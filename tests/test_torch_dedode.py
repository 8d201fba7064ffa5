"""DeDoDe (detector-L, descriptors B and G) in the port against the JAX
package on the CPU: the seeded init trees equal the JAX package's, the
converter's round trips, the detector logits (f32, within 1e-4 of their
largest magnitude), the coverage reweighting (within 1e-6 of its largest
value), detection (keypoints equal as sets), descriptor B and G in f32
(within 1e-5) and G with DINOv2 in bf16 (within 5e-3), the loaders with and
without weights, and ``run_matching --pipeline dedode+kornia_matcher`` with
B and with G (resolution 112, DINOv2 at depth 2) on three demo images.
Inputs and the perturbed biases come from a numpy seed."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_image_matching_tpu.models import dedode as jdd
from deep_image_matching_tpu_torch.convert import dedode_params_from_jax, dinov2_params_from_jax
from deep_image_matching_tpu_torch.extractors import dedode as tdd_ext
from deep_image_matching_tpu_torch.models import dedode as tdd
from deep_image_matching_tpu_torch.utils import weights as tweights


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _perturb(tree, rng):
    """Every bias drawn from N(0, 0.1), so the converters carry non-zero
    biases through the folded BatchNorms."""
    if isinstance(tree, dict):
        return {k: (jnp.asarray(rng.normal(0, 0.1, np.shape(v)), jnp.float32) if k == "b"
                    else _perturb(v, rng)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb(v, rng) for v in tree]
    return tree


def _leaves_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _images():
    return np.random.default_rng(1).random((2, 112, 112, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _detector():
    """The seeded init's logits span ~1e5, so its softmax is one-hot and
    the rest underflow (to zero in XLA, which flushes denormals, to
    denormals in torch): the output convolutions are scaled by 0.03, which
    leaves the logits spread over ~5, as a trained detector's are."""
    p = _perturb(jdd.init_detector_params(jax.random.PRNGKey(13)), np.random.default_rng(2))
    for r in p["refiners"].values():
        r["out"]["w"] = r["out"]["w"] * 0.03
    return p


@functools.lru_cache(maxsize=None)
def _descriptor(g: bool):
    if g:
        p = jdd.init_descriptor_g_params(jax.random.PRNGKey(31))
        return {**_perturb({k: v for k, v in p.items() if k != "dinov2"},
                           np.random.default_rng(4)), "dinov2": p["dinov2"]}
    return _perturb(jdd.init_descriptor_params(jax.random.PRNGKey(13)), np.random.default_rng(3))


def _port(p):
    dino = dinov2_params_from_jax(p["dinov2"]) if "dinov2" in p else None
    return tdd.params_from_torch(dedode_params_from_jax(p), dino)


def test_init_trees_equal_the_jax_package():
    """Detector and descriptor B; G's seeded tree, DINOv2 included, is held
    through its loader in ``test_loaders_with_and_without_weights``."""
    _leaves_equal(jdd.init_detector_params(None), tdd.init_detector())
    _leaves_equal(jdd.init_descriptor_params(None), tdd.init_descriptor())


@pytest.mark.parametrize("kind", ["detector", "B", "G"])
def test_dedode_converter_round_trip(kind):
    p = _detector() if kind == "detector" else _descriptor(kind == "G")
    sd = {k: v.numpy() for k, v in dedode_params_from_jax(p).items()}
    if kind == "G":
        back = jdd.descriptor_g_params_from_torch(sd)
        p = {k: v for k, v in p.items() if k != "dinov2"}
    else:
        back = jdd.detector_params_from_torch(sd)
    _leaves_equal(p, back)
    port = _port(_descriptor(True) if kind == "G" else p)
    for s, ref in p["refiners"].items():
        w = np.asarray(ref["hidden"][1]["conv1"]["w"]).transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(port["refiners"][s]["hidden"][1]["conv1"]["w"].numpy(), w)
        np.testing.assert_array_equal(port["refiners"][s]["block1"]["conv1"]["b"].numpy(),
                                      np.asarray(ref["block1"]["conv1"]["b"]))


def test_coverage_reweight_matches_jax():
    rng = np.random.default_rng(5)
    p = rng.random((2, 64, 88)).astype(np.float32)
    p /= p.sum(axis=(1, 2), keepdims=True)
    ref = np.asarray(jdd._coverage_reweight(jnp.asarray(p)))
    got = tdd._coverage_reweight(torch.from_numpy(p)).numpy()
    assert _rel(got, ref) < 1e-6


def test_detector_logits_and_detect_match_jax():
    p, imgs = _detector(), _images()
    tp = _port(p)
    ref = np.asarray(jdd.detector_logits(p, jnp.asarray(imgs)))
    got = tdd.detector_logits(tp, torch.from_numpy(imgs)).numpy()
    assert _rel(got, ref) < 1e-4
    # the JAX detector one image at a time, at the shape its extractor
    # compiles for in ``test_run_matching_dedode_kornia_agrees_with_jax``
    jout = [jdd.detect(p, jnp.asarray(imgs[b:b + 1]), num_keypoints=1024) for b in range(2)]
    jk, jc, jv = (np.concatenate([np.asarray(o[i]) for o in jout]) for i in range(3))
    tk, tc, tv = tdd.detect(tp, torch.from_numpy(imgs), num_keypoints=1024)
    assert tv.numpy().all() and jv.all()
    for b in range(2):
        jkb, tkb = jk[b], tk[b].numpy()
        assert {tuple(k) for k in jkb} == {tuple(k) for k in tkb}
        index = {tuple(k): i for i, k in enumerate(tkb)}
        order = [index[tuple(k)] for k in jkb]
        np.testing.assert_allclose(tc[b].numpy()[order], np.asarray(jc[b]), rtol=1e-4)


@pytest.mark.parametrize("kind,dtype,atol", [("B", "float32", 1e-5), ("G", "float32", 1e-5),
                                              ("G", "bfloat16", 5e-3)])
def test_descriptors_match_jax(kind, dtype, atol):
    """G's DINOv2 in bf16 rounds at other op boundaries in the two packages,
    hence its looser bound."""
    p, imgs = _descriptor(kind == "G"), _images()
    tp = _port(p)
    kpts = np.random.default_rng(6).uniform(0, 111, (2, 300, 2)).astype(np.float32)
    kpts[:, :4] = [[0, 0], [111, 111], [0, 111], [55.5, 0]]
    if kind == "G":
        ref = jdd.describe_g(p, jnp.asarray(imgs), jnp.asarray(kpts), dino_dtype=dtype)
        got = tdd.describe_g(tp, torch.from_numpy(imgs), torch.from_numpy(kpts),
                             dino_dtype=getattr(torch, dtype))
    else:
        ref = jdd.describe(p, jnp.asarray(imgs), jnp.asarray(kpts))
        got = tdd.describe(tp, torch.from_numpy(imgs), torch.from_numpy(kpts))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol)


def _reset(monkeypatch):
    from deep_image_matching_tpu.extractors import dedode as jdd_ext

    monkeypatch.setattr(jdd_ext, "_PARAMS", {})
    monkeypatch.setattr(tdd_ext, "_PARAMS", {})
    monkeypatch.setattr(tdd_ext, "_RANDOM", set())


def test_loaders_with_and_without_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    _reset(monkeypatch)
    with tweights.strict(), pytest.raises(tweights.MissingWeightsError):
        tdd_ext.load_params("detector")
    tweights.set_allow_random_weights(True)
    try:
        _reset(monkeypatch)
        got = tdd_ext.load_params("descriptor_g")
        ref = _port(jdd.init_descriptor_g_params(jax.random.PRNGKey(31)))
        _leaves_equal(got, ref)
        # cached random weights re-consult the policy
        with tweights.strict(), pytest.raises(tweights.MissingWeightsError):
            tdd_ext.load_params("descriptor_g")
    finally:
        tweights.set_allow_random_weights(None)
    _reset(monkeypatch)
    torch.save(dedode_params_from_jax(_detector()), tmp_path / "dedode_detector_L_v2.pth")
    torch.save(dedode_params_from_jax(_descriptor(True)), tmp_path / "dedode_descriptor_G.pth")
    with tweights.strict():
        _leaves_equal(tdd_ext.load_params("detector"), _port(_detector()))
        # no dinov2_vitl14_pretrain.pth: G's DINOv2 is the seeded depth-2 stack
        _leaves_equal(tdd_ext.load_params("descriptor_g"), _port(_descriptor(True)))


@pytest.mark.parametrize("descriptor", ["B", "G"])
def test_run_matching_dedode_kornia_agrees_with_jax(tmp_path, monkeypatch, descriptor):
    """Both packages at resolution 112 (G needs a multiple of 56) on the
    same seeded checkpoints; the JAX package's G runs its DINOv2 in f32
    here, as the port does under ``tpu.dtype: float32``."""
    from test_torch_disk import demo_project, run_both_and_compare

    from deep_image_matching_tpu.models import dedode as jdd_mod

    wdir = tmp_path / "weights"
    wdir.mkdir()
    torch.save(dedode_params_from_jax(_detector()), wdir / "dedode_detector_L.pth")
    torch.save(dedode_params_from_jax(_descriptor(descriptor == "G")),
               wdir / f"dedode_descriptor_{descriptor}.pth")
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(wdir))
    _reset(monkeypatch)
    monkeypatch.setattr(jdd_mod, "describe_g",
                        functools.partial(jdd_mod.describe_g, dino_dtype="float32"))
    # the descriptors agree within ~1e-6 in f32, but features.h5 and the
    # matcher's cache hold them in f16, where such a difference can move one
    # ulp (~5e-4); with seeded weights many nearest neighbours sit near the
    # 0.99 ratio bound, so raw matches are held to 98 % of their union
    # (measured: 118 of 119 on one pair with B)
    proj = demo_project(tmp_path / "proj")
    run_both_and_compare(
        tmp_path, proj, "dedode+kornia_matcher",
        f"extractor:\n  n_features: 1024\n  resolution: 112\n  descriptor: {descriptor}\n",
        share=0.98)
