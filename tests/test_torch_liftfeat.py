"""LiftFeat in the port against the JAX package on the CPU: the seeded init
tree equals the JAX package's, the converter's round trip (BaseLayers'
biases through the affine-free BatchNorms' means), the dense maps (f32,
within 1e-4 of their largest magnitude), the FeatureBooster (within 1e-5),
``extract`` (keypoints equal as sets, descriptors within 2e-5 after the
three AFT layers, scores within 1e-5), the loader with and without weights, and ``run_matching
--pipeline liftfeat+kornia_matcher`` on three demo images. Inputs and the
perturbed biases come from a numpy seed."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_image_matching_tpu.models import liftfeat as jlf
from deep_image_matching_tpu_torch.convert import liftfeat_params_from_jax
from deep_image_matching_tpu_torch.extractors import liftfeat as tlf_ext
from deep_image_matching_tpu_torch.models import liftfeat as tlf
from deep_image_matching_tpu_torch.utils import weights as tweights
from test_torch_dedode import _leaves_equal, _perturb, _rel


@functools.lru_cache(maxsize=None)
def _params():
    return _perturb(jlf.init_params(jax.random.PRNGKey(41)), np.random.default_rng(10))


def _port(p):
    return tlf.params_from_torch(liftfeat_params_from_jax(p))


def _images():
    return np.random.default_rng(11).random((2, 64, 96, 1)).astype(np.float32)


def test_init_tree_equals_the_jax_package():
    _leaves_equal(jlf.init_params(None), tlf.init_tree())


def test_liftfeat_converter_round_trip():
    p = _params()
    sd = liftfeat_params_from_jax(p)
    _leaves_equal(p, jlf.params_from_torch({f"model.{k}": v.numpy() for k, v in sd.items()}))
    port = _port(p)
    np.testing.assert_array_equal(port["keypoint_head"]["layers"][2]["b"].numpy(),
                                  np.asarray(p["keypoint_head"]["layers"][2]["b"]))
    np.testing.assert_array_equal(port["booster"]["aft"][1]["k"]["w"].numpy(),
                                  np.asarray(p["booster"]["aft"][1]["k"]["w"]).T)


def test_liftfeat_dense_and_boost_match_jax():
    p = _params()
    tp = _port(p)
    imgs = _images()
    jout = jlf.dense_forward(p, jnp.asarray(imgs))
    tout = tlf.dense_forward(tp, torch.from_numpy(imgs))
    for j, t in zip(jout, tout):
        assert _rel(t.numpy(), j) < 1e-4
    rng = np.random.default_rng(12)
    d = rng.normal(size=(96, 64)).astype(np.float32)
    n = rng.normal(size=(96, 192)).astype(np.float32)
    ref = np.asarray(jlf.feature_boost(p, jnp.asarray(d), jnp.asarray(n)))
    got = tlf.feature_boost(tp, torch.from_numpy(d), torch.from_numpy(n)).numpy()
    assert _rel(got, ref) < 1e-5


def test_liftfeat_extract_matches_jax():
    p = _params()
    tp = _port(p)
    imgs = _images()
    vhw = np.array([[64, 96], [60, 70]], np.int32)
    jo = jlf.extract(p, jnp.asarray(imgs), jnp.asarray(vhw), top_k=256, detection_threshold=0.01)
    to = tlf.extract(tp, torch.from_numpy(imgs), torch.from_numpy(vhw.astype(np.int64)),
                     top_k=256, detection_threshold=0.01)
    for b in range(2):
        jm, tm = np.asarray(jo["mask"][b]), to["mask"][b].numpy()
        assert jm.sum() == tm.sum() > 20
        jk = np.asarray(jo["keypoints"][b])[jm]
        tk = to["keypoints"][b].numpy()[tm]
        assert {tuple(k) for k in jk} == {tuple(k) for k in tk}
        index = {tuple(k): i for i, k in enumerate(tk)}
        order = [index[tuple(k)] for k in jk]
        np.testing.assert_allclose(to["descriptors"][b].numpy()[tm][order],
                                   np.asarray(jo["descriptors"][b])[jm], rtol=0, atol=2e-5)
        np.testing.assert_allclose(to["scores"][b].numpy()[tm][order],
                                   np.asarray(jo["scores"][b])[jm], rtol=0, atol=1e-5)


def _reset(monkeypatch):
    from deep_image_matching_tpu.extractors import liftfeat as jlf_ext

    monkeypatch.setattr(jlf_ext, "_PARAMS", None)
    monkeypatch.setattr(tlf_ext, "_PARAMS", None)
    monkeypatch.setattr(tlf_ext, "_PARAMS_RANDOM", False)


def test_liftfeat_loader_with_and_without_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    _reset(monkeypatch)
    with tweights.strict(), pytest.raises(tweights.MissingWeightsError):
        tlf_ext.load_params()
    tweights.set_allow_random_weights(True)
    try:
        _reset(monkeypatch)
        _leaves_equal(tlf_ext.load_params(), _port(jlf.init_params(None)))
        with tweights.strict(), pytest.raises(tweights.MissingWeightsError):
            tlf_ext.load_params()
    finally:
        tweights.set_allow_random_weights(None)
    _reset(monkeypatch)
    torch.save({"state_dict": {f"model.{k}": v for k, v in
                               liftfeat_params_from_jax(_params()).items()}},
               tmp_path / "LiftFeat.pth")
    with tweights.strict():
        _leaves_equal(tlf_ext.load_params(), _port(_params()))


def test_run_matching_liftfeat_kornia_agrees_with_jax(tmp_path, monkeypatch):
    from test_torch_disk import run_both_and_compare
    from test_torch_pipeline import _project

    wdir = tmp_path / "weights"
    wdir.mkdir()
    # with the seeded weights the normal MLP and the AFT layers add terms
    # shared by every cell, so all descriptors sit close together and the
    # 0.99 ratio test keeps 2-6 matches a pair, too few to verify; those
    # branches' last layers are scaled by 0.01 here (still run and carried),
    # and the views are a texture shifted by whole 8-pixel cells. Heat values
    # within ~1e-6 of each other can list the same keypoints in another
    # order, so that MAGSAC draws other samples from equal raw matches: the
    # verified matches are held to 90 % of their union (measured: 601 and
    # 612 of one pair's 663 raw matches)
    p = jlf.init_params(None)
    boost = p["booster"]
    for lp in [boost["nenc"][-1]] + [a[k] for a in boost["aft"] for k in ("proj", "ffn2")]:
        lp["w"] = lp["w"] * 0.01
    torch.save(liftfeat_params_from_jax(p), wdir / "LiftFeat.pth")
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(wdir))
    _reset(monkeypatch)
    run_both_and_compare(tmp_path, _project(tmp_path / "proj"), "liftfeat+kornia_matcher",
                         "extractor:\n  max_keypoints: 1024\n",
                         min_verified=1, verified_share=0.9)
