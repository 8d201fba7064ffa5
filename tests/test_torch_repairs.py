"""The port's configuration surface against the JAX package's: a deeper
LightGlue checkpoint loaded at fewer layers, ``tpu.ffn_impl`` and
``tpu.assignment_impl`` read and resolved as the JAX package reads them, the
JAX package's unfused ("xla") FFN arithmetic, ``tpu.device`` never falling
back to the CPU, and f32 taken on CUDA (other dtypes refused there)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_image_matching_tpu.models import lightglue as jlg
from deep_image_matching_tpu.ops import pallas_ffn as jffn
from deep_image_matching_tpu_torch.convert import lightglue_params_from_jax
from deep_image_matching_tpu_torch.matchers import lightglue as tlgm
from deep_image_matching_tpu_torch.matchers import matcher_base as tbase
from deep_image_matching_tpu_torch.matchers import superglue as tsgm
from deep_image_matching_tpu_torch.models import lightglue as tlg
from deep_image_matching_tpu_torch.ops import ffn as tffn
from deep_image_matching_tpu_torch.utils import device as tdevice


def _pair(K=128, D=256, seed=0):
    """One pair: image 1 holds image 0's keypoints permuted and shifted,
    with noisy copies of its descriptors."""
    rng = np.random.default_rng(seed)
    kpts0 = (rng.random((1, K, 2)) * [320, 240]).astype(np.float32)
    perm = rng.permutation(K)[None]
    kpts1 = np.take_along_axis(kpts0, perm[..., None], 1) + np.float32([12, -8])
    desc0 = rng.normal(size=(1, K, D)).astype(np.float32)
    desc0 /= np.linalg.norm(desc0, axis=-1, keepdims=True)
    desc1 = np.take_along_axis(desc0, perm[..., None], 1)
    desc1 = desc1 + 0.1 * rng.normal(size=desc1.shape).astype(np.float32)
    mask = np.ones((1, K), bool)
    size = np.float32([[320, 240]])
    return kpts0, kpts1, desc0, desc1, mask, mask, size, size


def test_deeper_checkpoint_loads_at_fewer_layers(tmp_path, monkeypatch):
    """A 9-layer checkpoint in DIM_TPU_WEIGHTS_DIR loads at n_layers = 7 (the
    superpoint+lightglue_fast preset) in both packages, and both match one
    seeded pair alike."""
    sd = lightglue_params_from_jax(jlg.init_params(jax.random.PRNGKey(5), n_layers=9))
    assert any(k.startswith("transformers.8.") for k in sd)
    assert any(k.startswith("token_confidence.7.") for k in sd)
    torch.save(sd, tmp_path / "superpoint_lightglue.pth")
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setattr(jlg, "_DEFAULT_PARAMS", {})
    monkeypatch.setattr(tlg, "_DEFAULT_MODELS", {})
    monkeypatch.setattr(tlg, "_DEFAULT_RANDOM", set())

    model = tlg.load_default_model("superpoint", n_layers=7)
    params = jlg.load_default_params("superpoint", n_layers=7)
    assert len(model.transformers) == 7 and len(model.token_confidence) == 6
    assert jax.tree.leaves(params["layers"])[0].shape[0] == 7
    for k, v in model.state_dict().items():  # the checkpoint's first 7 layers
        assert torch.equal(v, sd[k]), k

    inputs = _pair()
    ref = jlg.forward(params, *(jnp.asarray(a) for a in inputs), num_heads=4,
                      filter_threshold=0.0, compute_dtype="float32", attn_impl="xla",
                      assignment_impl="dense")
    got = tlg.forward(model, *(torch.from_numpy(a) for a in inputs), filter_threshold=0.0,
                      compute_dtype=torch.float32)
    np.testing.assert_array_equal(got["valid0"].numpy(), np.asarray(ref["valid0"]))
    np.testing.assert_array_equal(got["matches0"].numpy(), np.asarray(ref["matches0"]))
    assert int(got["valid0"].sum()) > 0


def test_truncate_layers_keeps_the_first_layers():
    sd = {"posenc.Wr.weight": 0, "transformers.6.x": 1, "transformers.7.x": 2,
          "transformers.10.x": 3, "log_assignment.6.y": 4, "log_assignment.7.y": 5,
          "token_confidence.5.z": 6, "token_confidence.6.z": 7, "input_proj.weight": 8}
    assert set(tlg.truncate_layers(sd, 7)) == {
        "posenc.Wr.weight", "transformers.6.x", "log_assignment.6.y", "token_confidence.5.z",
        "input_proj.weight"}


@pytest.mark.parametrize("rows", [128, 77])
def test_ffn_xla_matches_jax_xla_route_bf16(rows):
    """``ffn_xla`` against the JAX package's ``_ffn(..., "xla")`` in bf16 on
    the CPU, at a row count of full 128-row tiles and a ragged one. Held to
    one bf16 ulp of the output elementwise, with at least 99 % of elements
    equal: XLA's CPU fusions may keep a bias add or the LayerNorm's input in
    f32 where the JAX code rounds it to bf16, which moves a rounding of the
    output by one ulp at most."""
    rng = np.random.default_rng(3)
    D = 256
    x = rng.normal(size=(1, rows, D)).astype(np.float32)
    msg = rng.normal(size=(1, rows, D)).astype(np.float32)
    w1 = (rng.normal(size=(2 * D, 2 * D)) / np.sqrt(2 * D)).astype(np.float32)  # (out, in)
    b1 = (0.1 * rng.normal(size=2 * D)).astype(np.float32)
    g = (1.0 + 0.1 * rng.normal(size=2 * D)).astype(np.float32)
    beta = (0.1 * rng.normal(size=2 * D)).astype(np.float32)
    w2 = (rng.normal(size=(D, 2 * D)) / np.sqrt(2 * D)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=D)).astype(np.float32)

    def j(a):
        return jnp.asarray(a, jnp.bfloat16)

    p = {"ffn1": {"w": j(w1.T), "b": j(b1)}, "ln": {"g": j(g), "b": j(beta)},
         "ffn2": {"w": j(w2.T), "b": j(b2)}}
    ref = np.asarray(jlg._ffn(j(x), j(msg), p, "xla").astype(jnp.float32))

    def t(a):
        return torch.from_numpy(a).to(torch.bfloat16)

    got = tffn.ffn_xla(t(x), t(msg), t(w1), t(b1), t(g), t(beta), t(w2), t(b2))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = 2.0 ** -7 * np.maximum(np.abs(ref), 1.0)
    assert np.all(np.abs(got - ref) <= ulp)
    assert np.mean(got == ref) >= 0.99


def _jax_ffn_impl(monkeypatch, attn_impl):
    """The FFN route the JAX package's forward takes for ``attn_impl`` with
    ``ffn_impl="auto"``: its first ``_ffn`` call records the route and stops
    the run (attention is stubbed, as only the resolution is under test)."""

    class _Seen(Exception):
        pass

    def record(x, msg, p, impl="xla"):
        raise _Seen(impl)

    monkeypatch.setattr(jlg, "_ffn", record)
    monkeypatch.setattr(jlg, "_attention", lambda q, k, v, *a, **kw: q)
    params = jlg.init_params(jax.random.PRNGKey(0), n_layers=1, dim=64, input_dim=64)
    inputs = _pair(K=128, D=64)
    with pytest.raises(_Seen) as seen:
        jlg.forward_impl(params, *(jnp.asarray(a) for a in inputs), num_heads=4,
                         compute_dtype="float32", attn_impl=attn_impl, ffn_impl="auto")
    return seen.value.args[0]


@pytest.mark.parametrize("attn_impl", ["flash", "xla", "bidir"])
def test_ffn_impl_auto_resolves_as_jax(monkeypatch, attn_impl):
    expected = _jax_ffn_impl(monkeypatch, attn_impl)
    assert tlg.resolve_ffn_impl("auto", attn_impl) == expected
    matcher = tlgm.LightGlueMatcher({"general": {"tpu": {
        "device": "cpu", "dtype": "float32", "attn_impl": attn_impl}}, "matcher": {"n_layers": 1}})
    assert matcher.ffn_impl == expected
    for explicit in ("fused", "xla"):
        assert tlg.resolve_ffn_impl(explicit, attn_impl) == explicit


def _lightglue_matcher(**tpu):
    return tlgm.LightGlueMatcher({"general": {"tpu": {"device": "cpu", "dtype": "float32", **tpu}},
                                  "matcher": {"n_layers": 1}})


@pytest.mark.parametrize("key,value", [("ffn_impl", "pallas"), ("ffn_impl", "flash"),
                                       ("assignment_impl", "sparse"),
                                       ("assignment_impl", "auto")])
def test_unknown_ffn_and_assignment_impl_raise(key, value):
    with pytest.raises(ValueError, match=key):
        _lightglue_matcher(**{key: value})
    model = tlg.LightGlue(n_layers=1, dim=64, input_dim=64)
    with pytest.raises(ValueError, match=key):
        tlg.forward(model, *(torch.from_numpy(a) for a in _pair(K=8, D=64)), **{key: value})


def test_matcher_reads_ffn_and_assignment_impl():
    m = _lightglue_matcher(ffn_impl="xla", assignment_impl="dense")
    assert (m.ffn_impl, m.assignment_impl) == ("xla", "dense")
    m = _lightglue_matcher()  # the keys absent: today's routes
    assert (m.ffn_impl, m.assignment_impl) == ("fused", "fused")


@pytest.mark.parametrize("ffn_impl,assignment_impl",
                         [("xla", "dense"), ("fused", "dense"), ("xla", "fused")])
def test_lightglue_routes_match_jax_f32(monkeypatch, ffn_impl, assignment_impl):
    """Every pair of routes gives the JAX package's matches in f32, at 2
    layers, width 128 and K = 128, where the JAX package's "fused" FFN is
    its Pallas kernel (run in interpret mode) and the port's is kernel 2's
    plain version; the port's FFN calls go to the route asked for."""
    orig = jffn.ffn_fused
    monkeypatch.setattr(jffn, "ffn_fused", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    calls = {"fused": 0, "xla": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in calls:
        monkeypatch.setattr(tlg, f"ffn_{name}", counted(name, getattr(tlg, f"ffn_{name}")))
    params = jlg.init_params(jax.random.PRNGKey(1), n_layers=2, dim=128, input_dim=128)
    model = tlg.LightGlue(n_layers=2, dim=128, input_dim=128)
    model.load_state_dict(lightglue_params_from_jax(params))
    inputs = _pair(K=128, D=128)
    ref = jlg.forward(params, *(jnp.asarray(a) for a in inputs), num_heads=4,
                      filter_threshold=0.0, compute_dtype="float32", attn_impl="xla",
                      assignment_impl="dense", ffn_impl=ffn_impl)
    got = tlg.forward(model.eval(), *(torch.from_numpy(a) for a in inputs),
                      filter_threshold=0.0, compute_dtype=torch.float32, ffn_impl=ffn_impl,
                      assignment_impl=assignment_impl)
    # two self blocks and the cross block's two FFNs per layer run
    assert calls[ffn_impl] == 4 * int(got["layers_run"]) > 0
    assert sum(calls.values()) == calls[ffn_impl]
    np.testing.assert_array_equal(got["valid0"].numpy(), np.asarray(ref["valid0"]))
    np.testing.assert_array_equal(got["matches0"].numpy(), np.asarray(ref["matches0"]))
    v = np.asarray(ref["valid0"])
    # f32 on both sides, summed in another order
    np.testing.assert_allclose(got["matching_scores0"].numpy()[v],
                               np.asarray(ref["matching_scores0"])[v], atol=1e-4)


def test_device_auto_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for spec in (None, "auto", "AUTO", "cuda", "cuda:1"):
        with pytest.raises(RuntimeError, match="general.tpu.device: cpu"):
            tdevice.resolve_device(spec)
    with pytest.raises(RuntimeError, match="general.tpu.device: cpu"):
        tlgm.LightGlueMatcher({"general": {"tpu": {"dtype": "float32"}},
                               "matcher": {"n_layers": 1}})
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    assert _lightglue_matcher().device == torch.device("cpu")


@pytest.mark.parametrize("matcher_cls", [tlgm.LightGlueMatcher, tsgm.SuperGlueMatcher])
def test_float32_on_cuda_is_accepted(monkeypatch, matcher_cls):
    """A CUDA-device config with ``tpu.dtype: float32`` starts (kernels 1, 2,
    6 and 10 have float32 forms), float16 still raises there and names both
    dtypes the kernels take, and the CPU takes every dtype. This torch has
    no CUDA, so the model stays where it is."""
    monkeypatch.setattr(tbase, "resolve_device", lambda spec: torch.device("cuda", 0))
    monkeypatch.setattr(torch.nn.Module, "to", lambda self, *args, **kwargs: self)
    conf = {"general": {"tpu": {"device": "cuda", "dtype": "float32"}},
            "matcher": {"n_layers": 1}}
    matcher = matcher_cls(conf)
    assert matcher.device == torch.device("cuda", 0)
    assert matcher.compute_dtype == torch.float32
    conf["general"]["tpu"]["dtype"] = "float16"
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        matcher_cls(conf)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tdevice.check_matcher_dtype(torch.device("cuda", 0), torch.float16)
    for dt in (torch.float16, torch.bfloat16, torch.float32, torch.float64):
        assert tdevice.check_matcher_dtype(torch.device("cpu"), dt) == dt
