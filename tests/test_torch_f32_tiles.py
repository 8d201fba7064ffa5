"""The float32 forms of kernel 2 (csrc/ffn.cu, ``dim_ffn_f32``) and kernel 10
(csrc/qkv.cu, ``dim_qkv_rotary_f32``) against the JAX package's Pallas
kernels in interpret mode, in f32 on the CPU, and LightGlue (both opt-ins)
and SuperGlue run in f32 against the JAX package with the kernels' TF32
weight halves made once per model.

The CUDA kernels run only on the card (tests/test_torch_cuda.py holds them
against their plain versions there). What is checked here is the arithmetic
they implement: every product in split TF32, each operand split into TF32
halves by bit rounding (hi = rna_tf32(x), lo = rna_tf32(x - hi)) and each
product taken as lo.hi + hi.lo + hi.hi in f32, chunk by chunk of 32 along
the reduction as the kernels stream it; LayerNorm, GELU (or ReLU), the
bias and the rotary in f32. Each model is held to 1e-5 of max|out| (the
bound chip_smoke.py holds the kernels to on the card), and one TF32
product in its place leaves that bound.
"""

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
from deep_image_matching_tpu.models import superglue as jsg
from deep_image_matching_tpu_torch.convert import (lightglue_params_from_jax,
                                                   superglue_params_from_jax)
from deep_image_matching_tpu_torch.models import lightglue as tlg
from deep_image_matching_tpu_torch.models import superglue as tsg
from deep_image_matching_tpu_torch.ops import _lib
from deep_image_matching_tpu_torch.ops import qkv as tqkv

TOL = 1e-5  # of max|out|
KC = 32     # the kernels' k-chunk: one 128-byte swizzle row of f32
H = 4


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: f32 rounded to 10 mantissa bits, ties away from
    zero (the low 13 bits of the word cleared)."""
    bits = x.float().contiguous().numpy().view(np.uint32)
    return torch.from_numpy(((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32))


def chunked_product(a: torch.Tensor, w: torch.Tensor, terms: str = "split") -> torch.Tensor:
    """a (R, K) . w (N, K)^T as the kernels run it: 32-deep chunks, each the
    three TF32 products A lo.W hi + A hi.W hi + A hi.W lo ("split") or the
    hi one alone ("tf32"), summed in f32 chunk after chunk."""
    out = torch.zeros(a.shape[0], w.shape[0])
    for k0 in range(0, a.shape[1], KC):
        ac, wc = a[:, k0:k0 + KC], w[:, k0:k0 + KC]
        ah, wh = rna_tf32(ac), rna_tf32(wc)
        if terms == "tf32":
            out = out + ah @ wh.T
            continue
        al, wl = rna_tf32(ac - ah), rna_tf32(wc - wh)
        out = out + ((al @ wh.T + ah @ wh.T) + ah @ wl.T)
    return out


def stepped_product(a: torch.Tensor, w: torch.Tensor, terms: str = "split") -> torch.Tensor:
    """The same product in the order the kernels' accumulators take it, one
    8-deep wgmma step at a time: in each 32-deep chunk, A lo.W hi then A hi.W
    hi for each of the four steps, then A hi.W lo for each ("split"); or the
    hi one alone ("tf32")."""
    out = torch.zeros(a.shape[0], w.shape[0])
    for k0 in range(0, a.shape[1], KC):
        steps = []
        for s0 in range(k0, k0 + KC, 8):
            ac, wc = a[:, s0:s0 + 8], w[:, s0:s0 + 8]
            ah, wh = rna_tf32(ac), rna_tf32(wc)
            steps.append((ah, wh, rna_tf32(ac - ah), rna_tf32(wc - wh)))
        for ah, wh, al, _ in steps:
            if terms == "split":
                out = out + al @ wh.T
            out = out + ah @ wh.T
        if terms == "split":
            for ah, _, _, wl in steps:
                out = out + ah @ wl.T
    return out


def _err(got, ref) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max())


def test_port_split_rounds_as_the_kernels():
    """``_lib.tf32_split``, which makes the weights' halves, rounds bit for
    bit as cvt.rna.tf32.f32, ties included; hi + lo keeps ~21 bits."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=4096).astype(np.float32) * 10)
    # exact ties: the 13 low bits 0x1000, away from zero either sign
    ties = torch.from_numpy(np.array([0x3F801000, 0xBF801000, 0x40003000], np.uint32)
                            .view(np.float32))
    for t in (x, ties):
        hi, lo = _lib.tf32_split(t)
        assert torch.equal(hi, rna_tf32(t))
        assert torch.equal(lo, rna_tf32(t - rna_tf32(t)))
    hi, lo = _lib.tf32_split(x)
    assert ((hi + lo - x).abs() <= 2.0 ** -20 * x.abs()).all()


# ---------------------------------------------------------------------------
# kernel 2: the FFN
# ---------------------------------------------------------------------------

def _ffn_inputs(seed, B=2, K=192, D=256):
    rng = np.random.default_rng(seed)
    x, msg = (rng.normal(size=(B, K, D)).astype(np.float32) for _ in range(2))
    w1 = (rng.normal(size=(2 * D, 2 * D)) / np.sqrt(2 * D)).astype(np.float32)  # (out, in)
    b1 = (0.1 * rng.normal(size=2 * D)).astype(np.float32)
    g = (1.0 + 0.1 * rng.normal(size=2 * D)).astype(np.float32)
    beta = (0.1 * rng.normal(size=2 * D)).astype(np.float32)
    w2 = (rng.normal(size=(D, 2 * D)) / np.sqrt(2 * D)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=D)).astype(np.float32)
    return x, msg, w1, b1, g, beta, w2, b2


def tiled_ffn(x, msg, w1, b1, g, beta, w2, b2, mode, terms="split", product=chunked_product):
    """The float32 kernel's arithmetic on (B, K, D) inputs: h = [x | msg]
    W1^T in split TF32 chunk by chunk (``product``), + b1, LayerNorm (eps
    1e-5) and the exact GELU (or the relu) in f32, the f32 activation times
    W2^T in split TF32, + b2, + x."""
    B, K, D = x.shape
    a = torch.cat([x, msg], -1).reshape(-1, 2 * D)
    h = product(a, w1, terms) + b1
    if mode == "relu":
        act = torch.relu(h)
    else:
        mu = h.mean(-1, keepdim=True)
        var = ((h - mu) ** 2).mean(-1, keepdim=True)
        hn = (h - mu) * torch.rsqrt(var + 1e-5) * g + beta
        act = 0.5 * hn * (1.0 + torch.erf(hn * 0.7071067811865476))
    out = x.reshape(-1, D) + (product(act, w2, terms) + b2)
    return out.reshape(B, K, D)


def _jax_ffn(args, mode):
    x, msg, w1, b1, g, beta, w2, b2 = args
    return np.asarray(jffn.ffn_fused(*(jnp.asarray(a) for a in (x, msg, w1.T, b1, g, beta,
                                                                w2.T, b2)),
                                     interpret=True, mode=mode))


@pytest.mark.parametrize("mode", ["ln_gelu", "relu"])
def test_tiled_ffn_f32_matches_pallas_kernel(mode):
    args = _ffn_inputs(1)
    ref = _jax_ffn(args, mode)
    got = tiled_ffn(*(torch.from_numpy(a) for a in args), mode)
    assert _err(got, ref) <= TOL


@pytest.mark.parametrize("mode", ["ln_gelu", "relu"])
def test_one_tf32_product_leaves_the_ffn_tolerance(mode):
    """Why kernel 2's float32 form takes three TF32 products: one (hi.hi)
    is far outside 1e-5 of max|out|."""
    args = _ffn_inputs(2)
    ref = _jax_ffn(args, mode)
    one = tiled_ffn(*(torch.from_numpy(a) for a in args), mode, terms="tf32")
    assert _err(one, ref) > 4 * TOL


# ---------------------------------------------------------------------------
# kernel 10: the QKV + rotary prologue
# ---------------------------------------------------------------------------

def _qkv_inputs(seed, sections, B=2, N=128, D=256):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    w = (rng.normal(size=(sections * D, D)) / 16).astype(np.float32)  # (out, in), sectioned
    b = (0.1 * rng.normal(size=sections * D)).astype(np.float32)
    ang = rng.uniform(0, 6.3, (B, N, D // H // 2))
    cos = np.repeat(np.cos(ang), 2, -1).astype(np.float32)
    sin = np.repeat(np.sin(ang), 2, -1).astype(np.float32)
    return x, w, b, cos, sin


def tiled_qkv(x, w, b, cos, sin, sections, rot, terms="split", product=chunked_product):
    """The float32 kernel's arithmetic: y = x W^T in split TF32 chunk by
    chunk (``product``), + b in f32, split into (B, H, N, hd) heads per
    section, the rotary t cos + rotate_half(y) sin in f32 (each product and
    the sum rounded once) on the sections in ``rot``."""
    B, N, D = x.shape
    y = product(x.reshape(-1, D), w, terms) + b
    outs = []
    for s in range(sections):
        t = y[:, s * D:(s + 1) * D].reshape(B, N, H, D // H).transpose(1, 2)
        if s in rot:
            t = t * cos[:, None] + tqkv.rotate_half(t) * sin[:, None]
        outs.append(t)
    return outs


def _jax_qkv(args, sections, rot):
    x, w, b, cos, sin = args
    outs = jqkv.proj_rotary_fused(*(jnp.asarray(a) for a in (x, w.T, b, cos, sin)),
                                  n_sections=sections, rot=rot, interpret=True)
    B, N, D = x.shape
    return [np.asarray(o).reshape(B, N, H, D // H).transpose(0, 2, 1, 3) for o in outs]


@pytest.mark.parametrize("sections,rot", [(3, (0, 1)), (2, ())], ids=["self", "cross"])
def test_tiled_qkv_f32_matches_pallas_kernel(sections, rot):
    args = _qkv_inputs(3, sections)
    ref = _jax_qkv(args, sections, rot)
    got = tiled_qkv(*(torch.from_numpy(a) for a in args), sections, rot)
    for g, r in zip(got, ref):
        assert _err(g, r) <= TOL


def test_one_tf32_product_leaves_the_qkv_tolerance():
    args = _qkv_inputs(4, 3)
    ref = _jax_qkv(args, 3, (0, 1))
    one = tiled_qkv(*(torch.from_numpy(a) for a in args), 3, (0, 1), terms="tf32")
    assert max(_err(g, r) for g, r in zip(one, ref)) > 4 * TOL


@pytest.mark.parametrize("kernel,mode", [("ffn", "ln_gelu"), ("ffn", "relu"), ("qkv", "self"),
                                         ("qkv", "cross")])
def test_step_order_meets_pallas_kernels(kernel, mode):
    """Both float32 kernels keep the accumulation order of their first design
    (their outputs equal the earlier kernels' bit for bit on the card): per
    32-deep chunk, lo.hi and hi.hi step by step, then hi.lo. In that order,
    step by step, the split products meet the Pallas kernels within 1e-5 of
    max|out|, and one TF32 product in their place does not."""
    if kernel == "ffn":
        args = _ffn_inputs(5)
        ref = [_jax_ffn(args, mode)]
        run = lambda terms: [tiled_ffn(*(torch.from_numpy(a) for a in args), mode,  # noqa: E731
                                       terms, product=stepped_product)]
    else:
        sections, rot = (3, (0, 1)) if mode == "self" else (2, ())
        args = _qkv_inputs(6, sections)
        ref = _jax_qkv(args, sections, rot)
        run = lambda terms: tiled_qkv(*(torch.from_numpy(a) for a in args),  # noqa: E731
                                      sections, rot, terms, product=stepped_product)
    assert max(_err(g, r) for g, r in zip(run("split"), ref)) <= TOL
    assert max(_err(g, r) for g, r in zip(run("tf32"), ref)) > 4 * TOL


# ---------------------------------------------------------------------------
# the models in f32, with the TF32 halves of their weights made once
# ---------------------------------------------------------------------------

def _record(monkeypatch, module, name, seen):
    """Wrap ``module.name`` so that every call's ``split`` lands in ``seen``."""
    orig = getattr(module, name)

    def wrapped(*args, split=None, **kw):
        seen.append(split)
        return orig(*args, split=split, **kw)

    monkeypatch.setattr(module, name, wrapped)


@pytest.fixture
def jax_kernels_interpreted(monkeypatch):
    """The JAX package's bidir, prologue and FFN kernels in interpret mode;
    its self attention on the dense ``xla`` route; the prologue switched on
    for both packages."""
    for mod, name in ((jbidir, "bidir_cross_attention"), (jqkv, "proj_rotary_fused"),
                      (jffn, "ffn_fused")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=orig, **k: _f(*a, **{**k, "interpret": True}))
    orig_att = jatt.fused_attention
    monkeypatch.setattr(jatt, "fused_attention",
                        lambda q, k, v, qm, kvm, s, impl="xla": orig_att(q, k, v, qm, kvm, s,
                                                                         impl="xla"))
    monkeypatch.setenv("DIM_TPU_FUSED_PROLOGUE", "1")


def test_lightglue_f32_with_both_optins_makes_the_halves_once(jax_kernels_interpreted,
                                                              monkeypatch):
    """LightGlue at width 256, 2 layers, both opt-ins, compute_dtype f32,
    twice: the matches are the JAX package's, and every FFN and prologue
    call gets the TF32 halves of its own weights, the same tensors in both
    forwards (made once per model and dtype)."""
    B, K, layers, in_dim = 2, 128, 2, 128
    rng = np.random.default_rng(5)
    kpts0 = (rng.random((B, K, 2)) * [640, 480]).astype(np.float32)
    perm = np.stack([rng.permutation(K) for _ in range(B)])
    kpts1 = np.take_along_axis(kpts0, perm[..., None], 1) + np.float32([12, -8])
    desc0 = rng.normal(size=(B, K, in_dim)).astype(np.float32)
    desc0 /= np.linalg.norm(desc0, axis=-1, keepdims=True)
    desc1 = np.take_along_axis(desc0, perm[..., None], 1)
    desc1 = desc1 + 0.1 * rng.normal(size=desc1.shape).astype(np.float32)
    mask0 = np.ones((B, K), bool)
    mask0[1, 100:] = False
    mask1 = np.take_along_axis(mask0, perm, 1)
    size = np.tile(np.float32([[640, 480]]), (B, 1))
    inputs = (kpts0, kpts1, desc0, desc1, mask0, mask1, size, size)
    params = jlg.init_params(jax.random.PRNGKey(6), n_layers=layers, dim=256, num_heads=H,
                             input_dim=in_dim)
    ref = jlg.forward_impl(params, *(jnp.asarray(a) for a in inputs), num_heads=H,
                           filter_threshold=0.0, compute_dtype="float32", attn_impl="bidir",
                           assignment_impl="dense", ffn_impl="fused")
    model = tlg.LightGlue(n_layers=layers, dim=256, num_heads=H, input_dim=in_dim)
    model.load_state_dict(lightglue_params_from_jax(params))
    ffn_splits, qkv_splits = [], []
    _record(monkeypatch, tlg, "ffn_fused", ffn_splits)
    _record(monkeypatch, tlg, "qkv_rotary_fused", qkv_splits)
    _record(monkeypatch, tlg, "qk_v_fused", qkv_splits)
    outs = [tlg.forward(model.eval(), *(torch.from_numpy(a) for a in inputs),
                        filter_threshold=0.0, compute_dtype=torch.float32, attn_impl="bidir")
            for _ in range(2)]
    for got in outs:
        np.testing.assert_array_equal(got["valid0"].numpy(), np.asarray(ref["valid0"]))
        np.testing.assert_array_equal(got["matches0"].numpy(), np.asarray(ref["matches0"]))
    assert int(outs[0]["valid0"].sum()) > 20
    # 4 FFN and 4 prologue calls a layer; the second forward reuses the first's halves
    n = 4 * layers
    assert len(ffn_splits) == len(qkv_splits) == 2 * n
    for first, second in ((ffn_splits[:n], ffn_splits[n:]), (qkv_splits[:n], qkv_splits[n:])):
        assert all(a is b for a, b in zip(first, second))
    p = model.state_dict()
    w1s, w2s = ffn_splits[0]
    assert torch.equal(w1s, _lib.tf32_split(p["transformers.0.self_attn.ffn.0.weight"]))
    assert torch.equal(w2s, _lib.tf32_split(p["transformers.0.self_attn.ffn.3.weight"]))
    wqkv = tqkv.qkv_weights(p["transformers.0.self_attn.Wqkv.weight"],
                            p["transformers.0.self_attn.Wqkv.bias"], H)[0]
    assert torch.equal(qkv_splits[0], _lib.tf32_split(wqkv))
    assert len(model._prologue) == 2  # the permuted weights and their halves, f32 only
    model.load_state_dict(p)  # new weights: the halves go too
    assert not model._prologue


def test_superglue_f32_makes_the_halves_once(monkeypatch):
    """SuperGlue (2 blocks at width 256, f32, 30 Sinkhorn iterations)
    against the JAX package: ``folded_params(float32)`` carries each
    propagation MLP's TF32 halves, and every FFN call of a forward gets
    them from there."""
    rng = np.random.default_rng(7)
    n_blocks, dim = 2, 256
    kenc = tsg.KENC_CHANNELS
    params = jsg.init_params(jax.random.PRNGKey(8), n_blocks=n_blocks, dim=dim, num_heads=4)
    params["kenc"] = [{"w": jnp.asarray(rng.normal(size=(ci, co)) / np.sqrt(ci), jnp.float32),
                       "b": jnp.zeros((co,), jnp.float32)} for ci, co in zip(kenc[:-1], kenc[1:])]
    params["bin_score"] = jnp.asarray(0.7, jnp.float32)
    params = jax.tree.map(
        lambda a: a + jnp.asarray(0.05 * rng.normal(size=a.shape), jnp.float32), params)
    model = tsg.SuperGlue(n_blocks=n_blocks, dim=dim, num_heads=4, kenc_channels=kenc)
    model.load_state_dict(superglue_params_from_jax(params))
    model.eval()
    B, M, N = 2, 96, 80
    kpts0 = (rng.uniform(size=(B, M, 2)) * [640, 480]).astype(np.float32)
    desc0 = rng.normal(size=(B, M, dim)).astype(np.float32)
    sel = np.stack([rng.permutation(M)[:N] for _ in range(B)])
    kpts1 = (np.take_along_axis(kpts0, sel[..., None], 1) + [12.0, -7.0]).astype(np.float32)
    desc1 = (np.take_along_axis(desc0, sel[..., None], 1)
             + 0.2 * rng.normal(size=(B, N, dim))).astype(np.float32)
    scores0 = rng.uniform(size=(B, M)).astype(np.float32)
    scores1 = rng.uniform(size=(B, N)).astype(np.float32)
    mask0 = np.arange(M)[None] < np.array([[M], [70]])
    mask1 = np.arange(N)[None] < np.array([[60], [N]])
    size = np.array([[640.0, 480.0]] * B, np.float32)
    args = (kpts0, kpts1, scores0, scores1, desc0, desc1, mask0, mask1, size, size)
    ref = jsg.forward(params, *(jnp.asarray(a) for a in args), num_heads=4,
                      sinkhorn_iterations=30, match_threshold=0.05,
                      compute_dtype="float32", attn_impl="xla")
    folded = model.folded_params(torch.float32)
    assert "gnn.layers.0.mlp.0.weight_tf32" not in model.folded_params(torch.bfloat16)
    seen = []
    _record(monkeypatch, tsg, "ffn_fused", seen)
    got = tsg.forward(model, *(torch.from_numpy(a) for a in args), sinkhorn_iterations=30,
                      match_threshold=0.05, compute_dtype=torch.float32, params=folded)
    ref_v = np.asarray(ref["valid0"])
    assert ref_v.sum() > 20
    np.testing.assert_array_equal(got["valid0"].numpy(), ref_v)
    np.testing.assert_array_equal(got["matches0"].numpy(), np.asarray(ref["matches0"]))
    assert len(seen) == 2 * n_blocks * 2  # self and cross blocks, both sides
    for i, split in enumerate(seen):
        g = f"gnn.layers.{i // 2}.mlp"
        assert split[0] is folded[f"{g}.0.weight_tf32"]
        assert split[1] is folded[f"{g}.3.weight_tf32"]
        assert torch.equal(split[0], _lib.tf32_split(folded[f"{g}.0.weight"]))
