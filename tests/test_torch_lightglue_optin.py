"""LightGlue's two opt-ins against the JAX package: the shared-score
bidirectional cross attention (``attn_impl: bidir``, kernel 6) and the fused
QKV + rotary prologue (``DIM_TPU_FUSED_PROLOGUE=1``, kernel 10). The port's
plain versions are held against the JAX package's Pallas kernels run in
interpret mode, and the whole LightGlue forward with both opt-ins against
the JAX package's, at width 256 (the prologue's gate), 2 layers, f32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deep_image_matching_tpu.ops.attention as jatt
import deep_image_matching_tpu.ops.pallas_bidir_attention as jbidir
import deep_image_matching_tpu.ops.pallas_ffn as jffn
import deep_image_matching_tpu.ops.pallas_qkv as jqkv
from deep_image_matching_tpu.models import lightglue as jlg
from deep_image_matching_tpu_torch.convert import lightglue_params_from_jax
from deep_image_matching_tpu_torch.matchers import lightglue as tlgm
from deep_image_matching_tpu_torch.models import lightglue as tlg
from deep_image_matching_tpu_torch.ops import bidir_attention as tbidir
from deep_image_matching_tpu_torch.ops import qkv as tqkv

H = 4


# ---------------------------------------------------------------------------
# kernel 6: plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def _bidir_inputs(case):
    rng = np.random.default_rng(0)
    B, M, N, d = 3, 384, 200, 64  # M: 3 row tiles of the Pallas grid
    qk0, v0 = (rng.normal(size=(B, H, M, d)).astype(np.float32) for _ in range(2))
    qk1, v1 = (rng.normal(size=(B, H, N, d)).astype(np.float32) for _ in range(2))
    m0, m1 = np.ones((B, M), bool), np.ones((B, N), bool)
    if case in ("partial", "fully_masked"):
        m0 = rng.random((B, M)) > 0.2
        m1 = rng.random((B, N)) > 0.3
    if case == "fully_masked":
        m1[1] = False  # every column of element 1's S masked
        m0[2] = False  # every row of element 2's S masked
    return qk0, qk1, v0, v1, m0, m1


@pytest.mark.parametrize("case", ["ragged", "partial", "fully_masked"])
def test_bidir_plain_matches_pallas_kernel(case):
    args = _bidir_inputs(case)
    ref = jbidir.bidir_cross_attention(*(jnp.asarray(a) for a in args), interpret=True)
    got = tbidir.bidir_cross_attention(*(torch.from_numpy(a) for a in args))
    for g, r, m in zip(got, ref, args[4:]):
        # valid rows only: masked rows are undefined (the kernel averages the
        # other side's valid tokens there, the dense form all of them)
        sel = m[:, None, :, None]
        np.testing.assert_allclose(g.numpy() * sel, np.asarray(r) * sel, atol=2e-6)
    if case == "fully_masked":
        # a valid row against all-masked columns averages every column
        np.testing.assert_allclose(got[0][1].numpy(), np.broadcast_to(
            args[3][1].mean(1, keepdims=True), got[0][1].shape), atol=2e-6)


# ---------------------------------------------------------------------------
# kernel 10: plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def _prologue_inputs(dtype, sections, bias, seed=0):
    rng = np.random.default_rng(seed)
    B, N, D = 2, 128, 256
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    w = (rng.normal(size=(sections * D, D)) * 0.05).astype(np.float32)  # (out, in)
    b = (rng.normal(size=sections * D) * 0.05).astype(np.float32) if bias else None
    cos = rng.uniform(-1, 1, (B, N, D // H)).astype(np.float32)
    sin = rng.uniform(-1, 1, (B, N, D // H)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    return x, w, b, cos, sin, jdt, tdt


def _jheads(t):
    return np.asarray(jlg._heads(t, H).astype(jnp.float32))


def _compare(got, ref, dtype, x, w, b, sections):
    """f32 within 1e-5. bf16: bitwise equal but where the f32 products,
    summed in another order, round t to the other side; there the output
    moves by one bf16 ulp of its operands (|y|, |rotate_half(y)|), and at
    least 99.9 % of the elements must be bitwise equal (measured: at most
    5 of 65536 differ per section)."""
    y = tqkv.proj_rotary_reference(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.zeros(sections * 256) if b is None else torch.from_numpy(b),
                                   None, None, H, sections, ())
    for g, r, ys in zip(got, ref, y):
        g = g.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, r, atol=1e-5)
        else:
            bound = 2.0 ** -7 * (np.abs(r) + np.abs(ys.numpy())
                                 + np.abs(tqkv.rotate_half(ys).numpy()))
            assert (np.abs(g - r) <= bound).all()
            assert (g == r).mean() >= 0.999


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_rotary_plain_matches_pallas_kernel(dtype, bias):
    x, w, b, cos, sin, jdt, tdt = _prologue_inputs(dtype, 3, bias)
    p = {"w": jnp.asarray(w.T, jdt)}
    if bias:
        p["b"] = jnp.asarray(b, jdt)
    ref = jqkv.qkv_rotary_fused(jnp.asarray(x, jdt), p, jnp.asarray(cos), jnp.asarray(sin), H,
                                interpret=True)
    tw = torch.from_numpy(w).to(tdt)
    tb = torch.from_numpy(b).to(tdt) if bias else torch.zeros(3 * 256, dtype=tdt)
    got = tqkv.qkv_rotary_fused(torch.from_numpy(x).to(tdt), *tqkv.qkv_weights(tw, tb, H),
                                torch.from_numpy(cos), torch.from_numpy(sin), H)
    _compare(got, [_jheads(r) for r in ref], dtype, x, w, b, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qk_v_plain_matches_pallas_kernel(dtype):
    x, w, b, _, _, jdt, tdt = _prologue_inputs(dtype, 2, True, seed=1)
    D = 256
    p_qk = {"w": jnp.asarray(w[:D].T, jdt), "b": jnp.asarray(b[:D], jdt)}
    p_v = {"w": jnp.asarray(w[D:].T, jdt), "b": jnp.asarray(b[D:], jdt)}
    ref = jqkv.qk_v_fused(jnp.asarray(x, jdt), p_qk, p_v, interpret=True)
    tw, tb = torch.from_numpy(w).to(tdt), torch.from_numpy(b).to(tdt)
    got = tqkv.qk_v_fused(torch.from_numpy(x).to(tdt),
                          *tqkv.qk_v_weights(tw[:D], tb[:D], tw[D:], tb[D:]), H)
    _compare(got, [_jheads(r) for r in ref], dtype, x, w, b, 2)


def test_qkv_permutation_is_the_jax_packages():
    np.testing.assert_array_equal(tqkv._qkv_perm(256, 4), jqkv._qkv_perm(256, 4))


# ---------------------------------------------------------------------------
# LightGlue with both opt-ins against the JAX package's
# ---------------------------------------------------------------------------

B, K, DIM, LAYERS, INPUT_DIM = 2, 128, 256, 2, 128


@pytest.fixture
def jax_kernels_interpreted(monkeypatch):
    """The JAX package's bidir, prologue and FFN kernels in interpret mode;
    its self attention on the dense ``xla`` route (no flash kernel on the
    CPU); the prologue switched on for both packages."""
    for mod, name in ((jbidir, "bidir_cross_attention"), (jqkv, "proj_rotary_fused"),
                      (jffn, "ffn_fused")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=orig, **k: _f(*a, **{**k, "interpret": True}))
    orig_att = jatt.fused_attention
    monkeypatch.setattr(jatt, "fused_attention",
                        lambda q, k, v, qm, kvm, s, impl="xla": orig_att(q, k, v, qm, kvm, s,
                                                                         impl="xla"))
    monkeypatch.setenv("DIM_TPU_FUSED_PROLOGUE", "1")


def _lg_inputs():
    """Image 1 holds image 0's keypoints permuted and shifted, with noisy
    copies of its descriptors; pair 1 has padded slots."""
    rng = np.random.default_rng(3)
    kpts0 = (rng.random((B, K, 2)) * [640, 480]).astype(np.float32)
    perm = np.stack([rng.permutation(K) for _ in range(B)])
    kpts1 = np.take_along_axis(kpts0, perm[..., None], 1) + np.float32([12, -8])
    desc0 = rng.normal(size=(B, K, INPUT_DIM)).astype(np.float32)
    desc0 /= np.linalg.norm(desc0, axis=-1, keepdims=True)
    desc1 = np.take_along_axis(desc0, perm[..., None], 1)
    desc1 = desc1 + 0.1 * rng.normal(size=desc1.shape).astype(np.float32)
    mask0 = np.ones((B, K), bool)
    mask0[1, 100:] = False
    mask1 = np.take_along_axis(mask0, perm, 1)
    size = np.tile(np.float32([[640, 480]]), (B, 1))
    return kpts0, kpts1, desc0, desc1, mask0, mask1, size, size


@pytest.mark.parametrize("case", ["fixed", "adaptive", "pruning"])
def test_lightglue_with_both_optins_matches_jax(jax_kernels_interpreted, case):
    params = jlg.init_params(jax.random.PRNGKey(5), n_layers=LAYERS, dim=DIM, num_heads=H,
                             input_dim=INPUT_DIM)
    kw = dict(depth_confidence=-1.0, width_confidence=-1.0)
    if case != "fixed":
        kw = dict(depth_confidence=0.95, width_confidence=0.99, pruning_min_kpts=16)
    if case == "pruning":
        # confident but unmatchable points after layer 0 are pruned, and the
        # stop threshold is out of reach, so layer 1 runs on pruned masks
        layers = dict(params["layers"])
        layers["token"] = {**layers["token"], "b": layers["token"]["b"].at[0].set(3.0)}
        assign = dict(layers["assign"])
        assign["match"] = {**assign["match"], "b": assign["match"]["b"].at[0].set(-4.6)}
        layers["assign"] = assign
        params = {**params, "layers": layers}
        kw["depth_confidence"] = 0.9999
    inputs = _lg_inputs()
    ref = jlg.forward_impl(params, *(jnp.asarray(a) for a in inputs), num_heads=H,
                           filter_threshold=0.0, compute_dtype="float32", attn_impl="bidir",
                           assignment_impl="dense", ffn_impl="fused", **kw)
    model = tlg.LightGlue(n_layers=LAYERS, dim=DIM, num_heads=H, input_dim=INPUT_DIM)
    model.load_state_dict(lightglue_params_from_jax(params))
    launches = {"bidir": 0, "qkv": 0, "qk_v": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            launches[name] += 1
            return fn(*a, **k)
        return wrapped

    with pytest.MonkeyPatch.context() as m:
        m.setattr(tlg, "bidir_cross_attention", counted("bidir", tlg.bidir_cross_attention))
        m.setattr(tlg, "qkv_rotary_fused", counted("qkv", tlg.qkv_rotary_fused))
        m.setattr(tlg, "qk_v_fused", counted("qk_v", tlg.qk_v_fused))
        got = tlg.forward(model.eval(), *(torch.from_numpy(a) for a in inputs),
                          filter_threshold=0.0, compute_dtype=torch.float32, attn_impl="bidir",
                          **kw)
    n = int(got["layers_run"])
    assert n == int(ref["layers_run"])
    assert launches == {"bidir": n, "qkv": 2 * n, "qk_v": 2 * n}
    np.testing.assert_array_equal(got["valid0"].numpy(), np.asarray(ref["valid0"]))
    np.testing.assert_array_equal(got["matches0"].numpy(), np.asarray(ref["matches0"]))
    assert int(got["valid0"].sum()) > 20


def test_prologue_gate_reads_the_environment_per_call(monkeypatch):
    x = torch.zeros(2, 64, 256)
    monkeypatch.delenv("DIM_TPU_FUSED_PROLOGUE", raising=False)
    assert not tlg._prologue_fused_ok(x)
    monkeypatch.setenv("DIM_TPU_FUSED_PROLOGUE", "1")
    assert tlg._prologue_fused_ok(x)
    assert not tlg._prologue_fused_ok(torch.zeros(1, 100, 256))  # rows % 128
    assert not tlg._prologue_fused_ok(torch.zeros(2, 64, 64))    # width % 128


def test_prologue_weights_built_once_per_dtype():
    model = tlg.LightGlue(n_layers=2, dim=256, num_heads=H).eval()
    p32 = model.state_dict()
    first = model.prologue_weights(p32)
    assert model.prologue_weights(p32) is first
    p16 = {k: v.to(torch.bfloat16) for k, v in p32.items()}
    assert model.prologue_weights(p16)[0]["self"][0].dtype == torch.bfloat16
    assert len(model._prologue) == 2
    model.load_state_dict(p32)  # new weights: the permuted copies go
    assert not model._prologue


# ---------------------------------------------------------------------------
# the matcher's tpu.attn_impl
# ---------------------------------------------------------------------------

def _matcher(monkeypatch, attn_impl):
    small = tlg.LightGlue(n_layers=2, dim=256, num_heads=H).eval()
    monkeypatch.setattr(tlgm, "load_default_model", lambda features, n_layers: small)
    tpu = {"device": "cpu", "dtype": "float32"}
    if attn_impl is not None:
        tpu["attn_impl"] = attn_impl
    return tlgm.LightGlueMatcher({"general": {"tpu": tpu}, "matcher": {"n_layers": 2}})


@pytest.mark.parametrize("attn_impl", [None, "flash", "xla", "bidir"])
def test_matcher_reads_attn_impl(monkeypatch, attn_impl):
    matcher = _matcher(monkeypatch, attn_impl)
    assert matcher.attn_impl == (attn_impl or "flash")
    calls = []
    monkeypatch.setattr(tlg, "bidir_cross_attention",
                        lambda *a: calls.append(1) or tbidir.bidir_cross_attention(*a))
    rng = np.random.default_rng(0)
    batch = {"keypoints": torch.from_numpy(rng.random((1, 128, 2)).astype(np.float32) * 100),
             "descriptors": torch.from_numpy(rng.normal(size=(1, 128, 256)).astype(np.float32)),
             "mask": torch.ones(1, 128, dtype=torch.bool),
             "image_size": torch.tensor([[100, 100]])}
    matches0, valid = matcher._match_batch_arrays(batch, batch)
    assert matches0.shape == (1, 128) and valid.shape == (1, 128)
    assert bool(calls) == (attn_impl == "bidir")


def test_matcher_refuses_unknown_attn_impl(monkeypatch):
    with pytest.raises(ValueError, match="attn_impl"):
        _matcher(monkeypatch, "splash")
    with pytest.raises(ValueError, match="attn_impl"):
        tlg.LightGlueRunner(model=tlg.LightGlue(n_layers=1, dim=256), attn_impl="fused")
