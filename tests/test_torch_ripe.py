"""RIPE in the port against the JAX package on the CPU: the seeded init
tree equals the JAX package's, the converter's round trip (with and without
the 1x1 descriptor reduction), the heatmap (f32, within 1e-4 of its largest
magnitude), ``extract`` (keypoints equal as sets, 960-d hypercolumn and
reduced descriptors within 1e-5, scores within 1e-4), the loader with and
without weights, and ``run_matching --pipeline ripe+kornia_matcher`` on
three demo images at 120 x 112. Inputs and the perturbed biases come from a
numpy seed."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_image_matching_tpu.models import ripe as jripe
from deep_image_matching_tpu_torch.convert import ripe_params_from_jax
from deep_image_matching_tpu_torch.extractors import ripe as tripe_ext
from deep_image_matching_tpu_torch.models import ripe as tripe
from deep_image_matching_tpu_torch.models.vgg_refiner import decode_multiscale, vgg19_features
from deep_image_matching_tpu_torch.utils import weights as tweights
from test_torch_dedode import _leaves_equal, _perturb, _rel


@functools.lru_cache(maxsize=None)
def _params(reduce: bool = False):
    p = _perturb(jripe.init_params(jax.random.PRNGKey(17)), np.random.default_rng(7))
    if reduce:
        rng = np.random.default_rng(8)
        p["dim_reduction"] = {
            "w": jnp.asarray(rng.normal(0, 960 ** -0.5, (960, 128)), jnp.float32),
            "b": jnp.asarray(rng.normal(0, 0.1, (128,)), jnp.float32)}
    return p


def _images():
    """The demo views' padded shape in ``test_run_matching_ripe_kornia_agrees_with_jax``,
    so the JAX package compiles ``extract`` once for both tests."""
    return np.random.default_rng(9).random((2, 112, 120, 3)).astype(np.float32)


def test_init_tree_equals_the_jax_package():
    _leaves_equal(jripe.init_params(None), tripe.init_tree())


@pytest.mark.parametrize("reduce", [False, True])
def test_ripe_converter_round_trip(reduce):
    p = _params(reduce)
    sd = ripe_params_from_jax(p)
    _leaves_equal(p, jripe.params_from_torch({k: v.numpy() for k, v in sd.items()}))
    port = tripe.params_from_torch(sd)
    np.testing.assert_array_equal(port["refiners"]["2"]["hidden"][7]["conv1"]["w"].numpy(),
                                  np.asarray(p["refiners"]["2"]["hidden"][7]["conv1"]["w"])
                                  .transpose(3, 2, 0, 1))
    if reduce:
        np.testing.assert_array_equal(port["dim_reduction"]["w"].numpy(),
                                      np.asarray(p["dim_reduction"]["w"]).T)


@pytest.mark.parametrize("reduce", [False, True])
def test_ripe_heatmap_and_extract_match_jax(reduce):
    from deep_image_matching_tpu.models import vgg_refiner as jvr

    p = _params(reduce)
    tp = tripe.params_from_torch(ripe_params_from_jax(p))
    imgs = _images()
    x = np.asarray(jripe._instance_norm(jnp.asarray(imgs)))
    ref = jvr.decode_multiscale(jvr.vgg19_features(p["encoder"], jnp.asarray(x)),
                                p["refiners"], num_prototypes=1)
    tx = tripe._instance_norm(torch.from_numpy(imgs))
    np.testing.assert_allclose(tx.numpy(), x, rtol=0, atol=1e-5)
    got = decode_multiscale(vgg19_features(tp["encoder"], tx), tp["refiners"], num_prototypes=1)
    assert _rel(got.numpy(), ref) < 1e-4
    vhw = np.array([[112, 120], [100, 90]], np.int32)
    jouts = [jripe.extract(p, jnp.asarray(imgs[b:b + 1]), jnp.asarray(vhw[b:b + 1]),
                           max_keypoints=1024, threshold=0.5) for b in range(2)]
    jo = {k: np.concatenate([np.asarray(o[k]) for o in jouts]) for k in jouts[0]}
    to = tripe.extract(tp, torch.from_numpy(imgs), torch.from_numpy(vhw.astype(np.int64)),
                       max_keypoints=1024, threshold=0.5)
    assert to["descriptors"].shape[-1] == (128 if reduce else 960)
    for b in range(2):
        jm, tm = jo["mask"][b], to["mask"][b].numpy()
        assert jm.sum() == tm.sum() > 50
        jk = np.asarray(jo["keypoints"][b])[jm]
        tk = to["keypoints"][b].numpy()[tm]
        assert {tuple(k) for k in jk} == {tuple(k) for k in tk}
        index = {tuple(k): i for i, k in enumerate(tk)}
        order = [index[tuple(k)] for k in jk]
        np.testing.assert_allclose(to["descriptors"][b].numpy()[tm][order],
                                   np.asarray(jo["descriptors"][b])[jm], rtol=0, atol=1e-5)
        np.testing.assert_allclose(to["scores"][b].numpy()[tm][order],
                                   np.asarray(jo["scores"][b])[jm], rtol=0, atol=1e-4)


def _reset(monkeypatch):
    from deep_image_matching_tpu.extractors import ripe as jripe_ext

    monkeypatch.setattr(jripe_ext, "_PARAMS", None)
    monkeypatch.setattr(tripe_ext, "_PARAMS", None)
    monkeypatch.setattr(tripe_ext, "_PARAMS_RANDOM", False)


def test_ripe_loader_with_and_without_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setattr(tripe_ext.tempfile, "gettempdir", lambda: str(tmp_path / "tmp"))
    _reset(monkeypatch)
    with tweights.strict(), pytest.raises(tweights.MissingWeightsError):
        tripe_ext.load_params()
    tweights.set_allow_random_weights(True)
    try:
        _reset(monkeypatch)
        _leaves_equal(tripe_ext.load_params(),
                      tripe.params_from_torch(ripe_params_from_jax(jripe.init_params(None))))
        with tweights.strict(), pytest.raises(tweights.MissingWeightsError):
            tripe_ext.load_params()
    finally:
        tweights.set_allow_random_weights(None)
    _reset(monkeypatch)
    torch.save(ripe_params_from_jax(_params(True)), tmp_path / "ripe_weights.pth")
    with tweights.strict():
        _leaves_equal(tripe_ext.load_params(),
                      tripe.params_from_torch(ripe_params_from_jax(_params(True))))


def test_run_matching_ripe_kornia_agrees_with_jax(tmp_path, monkeypatch):
    from test_torch_disk import demo_project, run_both_and_compare

    wdir = tmp_path / "weights"
    wdir.mkdir()
    torch.save(ripe_params_from_jax(_params()), wdir / "ripe_weights.pth")
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(wdir))
    _reset(monkeypatch)
    proj = demo_project(tmp_path / "proj", size=(120, 112))
    run_both_and_compare(tmp_path, proj, "ripe+kornia_matcher",
                         "extractor:\n  max_keypoints: 1024\n")
