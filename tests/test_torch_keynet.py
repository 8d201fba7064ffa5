"""KeyNet, AffNet, OriNet and HardNet in the port against the JAX package on
the CPU, each alone (f32 within 1e-5 of the output's largest magnitude), the
converters' round trips, the ``jax.image.resize`` weights, the
determinant-of-Hessian and the learned detectors (keypoints equal as sets),
the orientation and the oriented patches, and ``keynet_hardnet_extract``
through both detectors with and without the learned frames; the extractor's
weight policy per stage on seeded checkpoints. Inputs come from a numpy
seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_image_matching_tpu.models import affnet as jan
from deep_image_matching_tpu.models import hardnet as jhn
from deep_image_matching_tpu.models import keynet as jkn
from deep_image_matching_tpu_torch.convert import (affnet_params_from_jax, hardnet_params_from_jax,
                                                   keynet_params_from_jax, orinet_params_from_jax)
from deep_image_matching_tpu_torch.extractors import keynetaffnethardnet as tkah
from deep_image_matching_tpu_torch.models import affnet as tan
from deep_image_matching_tpu_torch.models import hardnet as thn
from deep_image_matching_tpu_torch.models import keynet as tkn


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _with_biases(p, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(0, 0.05, a.shape), jnp.float32) if a.ndim == 1 else a, p)


def _keynet():
    return _with_biases(jkn.init_keynet_params(), 10)


def _affnet():
    return _with_biases(jan.init_affnet_params(jax.random.PRNGKey(1)), 11)


def _orinet():
    return _with_biases(jan.init_orinet_params(jax.random.PRNGKey(2)), 12)


def _hardnet():
    return _with_biases(jhn.init_hardnet_params(jax.random.PRNGKey(3)), 13)


def _image(h=96, w=128, seed=0):
    """A blurred random texture with blobs, grey in [0, 1]."""
    import cv2

    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.uniform(0, 1, (h, w)).astype(np.float32), (0, 0), 1.5)
    for _ in range(12):
        c = tuple(int(v) for v in rng.integers(0, max(h, w), 2))
        cv2.circle(img, c, int(rng.integers(3, 10)), float(rng.uniform(0, 1)), -1)
    return img


def _leaves_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_converters_round_trip():
    _leaves_equal(jkn.keynet_params_from_torch(keynet_params_from_jax(_keynet())), _keynet())
    _leaves_equal(jan.affnet_params_from_torch(affnet_params_from_jax(_affnet())), _affnet())
    _leaves_equal(jan.orinet_params_from_torch(orinet_params_from_jax(_orinet())), _orinet())
    _leaves_equal(jhn.hardnet_params_from_torch(hardnet_params_from_jax(_hardnet())), _hardnet())
    # the port's folds give the JAX tree's weights bit for bit
    model = tkn.keynet_params_from_torch(keynet_params_from_jax(_keynet()))
    np.testing.assert_array_equal(model.last.weight.detach().numpy(),
                                  np.asarray(_keynet()["last"]["w"]).transpose(3, 2, 0, 1))
    model = thn.hardnet_params_from_torch(hardnet_params_from_jax(_hardnet()))
    np.testing.assert_array_equal(model.layers[6].bias.detach().numpy(),
                                  np.asarray(_hardnet()["layers"][6]["b"]))


@pytest.mark.parametrize("shape", [(37, 53, 30, 44), (40, 40, 33, 33), (20, 30, 48, 64)])
@pytest.mark.parametrize("antialias", [True, False])
def test_resize_matches_jax_image_resize(shape, antialias):
    h, w, nh, nw = shape
    x = np.random.default_rng(1).normal(size=(2, h, w, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, nh, nw, 3), "bilinear",
                                      antialias=antialias))
    got = tkn.resize_linear(torch.from_numpy(x).permute(0, 3, 1, 2), nh, nw, antialias)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=1e-6)


def test_keynet_response_matches_jax():
    p = _keynet()
    model = tkn.keynet_params_from_torch(keynet_params_from_jax(p))
    imgs = np.stack([_image(seed=s) for s in (0, 1)])
    ref = jkn.keynet_response(p, jnp.asarray(imgs))
    got = tkn.keynet_response(model, torch.from_numpy(imgs))
    assert _rel(got.numpy(), ref) < 1e-5
    hc = tkn.handcrafted_block(torch.from_numpy(imgs)[:, None])
    np.testing.assert_allclose(hc.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jkn.handcrafted_block(jnp.asarray(imgs)[..., None])),
                               atol=1e-6)


def test_affnet_orinet_hardnet_match_jax():
    rng = np.random.default_rng(3)
    patches = rng.uniform(0, 1, (40, 32, 32)).astype(np.float32)
    tp = torch.from_numpy(patches)
    a = tan.affnet_params_from_torch(affnet_params_from_jax(_affnet()))
    o = tan.orinet_params_from_torch(orinet_params_from_jax(_orinet()))
    h = thn.hardnet_params_from_torch(hardnet_params_from_jax(_hardnet()))
    ref = np.asarray(jan.affnet_shapes(_affnet(), jnp.asarray(patches)))
    assert _rel(tan.affnet_shapes(a, tp).numpy(), ref) < 1e-5
    ref = np.asarray(jan.orinet_angles(_orinet(), jnp.asarray(patches)))
    np.testing.assert_allclose(tan.orinet_angles(o, tp).numpy(), ref, atol=1e-5)
    ref = np.asarray(jhn.hardnet_describe(_hardnet(), jnp.asarray(patches)))
    np.testing.assert_allclose(thn.hardnet_describe(h, tp).numpy(), ref, atol=1e-5)


def _same_keypoints(jk, jm, tk, tm, jsig, tsig):
    """Keypoints with their scales equal as sets (one position can be
    detected at two scales); the port's row of each JAX row."""
    jm, tm = np.asarray(jm), tm.numpy()
    jk = [tuple(k) + (s,) for k, s in zip(np.asarray(jk)[jm], np.asarray(jsig)[jm])]
    tk = [tuple(k) + (s,) for k, s in zip(tk.numpy()[tm], tsig.numpy()[tm])]
    assert len(jk) == len(tk) > 10 and len(set(tk)) == len(tk)
    assert set(jk) == set(tk)
    index = {k: i for i, k in enumerate(tk)}
    return [index[k] for k in jk]


def test_detectors_match_jax():
    imgs = np.stack([_image(seed=s) for s in (2, 3)])
    vhw = np.array([[96, 128], [80, 100]], np.int32)
    ti, tv = torch.from_numpy(imgs), torch.from_numpy(vhw.astype(np.int64))
    ref = jhn.multiscale_detect(jnp.asarray(imgs), jnp.asarray(vhw), 128)
    got = thn.multiscale_detect(ti, tv, 128)
    for b in range(2):
        order = _same_keypoints(ref[0][b], ref[3][b], got[0][b], got[3][b], ref[2][b],
                                got[2][b])
        # second differences of blurred f32 images, times sigma^4: the two
        # packages' summation orders move the responses by up to ~1e-4 of
        # the largest, so they are held within 1e-3 of it
        np.testing.assert_allclose(got[1][b].numpy()[got[3][b].numpy()][order],
                                   np.asarray(ref[1][b])[np.asarray(ref[3][b])], rtol=0,
                                   atol=1e-3 * float(np.abs(np.asarray(ref[1][b])).max()))
    p = _keynet()
    model = tkn.keynet_params_from_torch(keynet_params_from_jax(p))
    ref = jkn.keynet_multiscale_detect(p, jnp.asarray(imgs), jnp.asarray(vhw), 128)
    got = tkn.keynet_multiscale_detect(model, ti, tv, 128)
    for b in range(2):
        order = _same_keypoints(ref[0][b], ref[3][b], got[0][b], got[3][b], ref[2][b],
                                got[2][b])
        np.testing.assert_allclose(got[1][b].numpy()[got[3][b].numpy()][order],
                                   np.asarray(ref[1][b])[np.asarray(ref[3][b])], rtol=0,
                                   atol=1e-4 * float(np.abs(np.asarray(ref[1][b])).max()))


def test_orientation_and_patches_match_jax():
    imgs = np.stack([_image(seed=4)])
    rng = np.random.default_rng(5)
    kpts = rng.uniform(10, 90, (1, 50, 2)).astype(np.float32)
    sig = rng.uniform(1.0, 5.0, (1, 50)).astype(np.float32)
    ang = rng.uniform(-3, 3, (1, 50)).astype(np.float32)
    shp = rng.normal(0, 0.2, (1, 50, 2, 2)).astype(np.float32) + np.eye(2, dtype=np.float32)
    j = [jnp.asarray(a) for a in (imgs, kpts, sig, ang, shp)]
    t = [torch.from_numpy(a) for a in (imgs, kpts, sig, ang, shp)]
    # angles within 1e-4 rad: the mean gradients sum in another order
    np.testing.assert_allclose(thn.dominant_orientation(*t[:3]).numpy(),
                               np.asarray(jhn.dominant_orientation(*j[:3])), atol=1e-4)
    for shapes in (None, 4):
        ref = jhn.extract_oriented_patches(*j[:4], shapes=None if shapes is None else j[4])
        got = thn.extract_oriented_patches(*t[:4], shapes=None if shapes is None else t[4])
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("detector,frames,upright", [("doh", False, False), ("doh", True, False),
                                                     ("keynet", True, False),
                                                     ("keynet", False, True)])
def test_keynet_hardnet_extract_matches_jax(detector, frames, upright):
    imgs = np.stack([_image(seed=6)])
    vhw = np.array([[96, 128]], np.int32)
    h = thn.hardnet_params_from_torch(hardnet_params_from_jax(_hardnet()))
    kw_j = dict(max_keypoints=128, upright=upright, detector=detector)
    kw_t = dict(kw_j)
    if detector == "keynet":
        kw_j["keynet_params"] = _keynet()
        kw_t["keynet"] = tkn.keynet_params_from_torch(keynet_params_from_jax(_keynet()))
    if frames:
        kw_j["affnet_params"], kw_j["orinet_params"] = _affnet(), _orinet()
        kw_t["affnet"] = tan.affnet_params_from_torch(affnet_params_from_jax(_affnet()))
        kw_t["orinet"] = tan.orinet_params_from_torch(orinet_params_from_jax(_orinet()))
    ref = jhn.keynet_hardnet_extract(_hardnet(), jnp.asarray(imgs), jnp.asarray(vhw), **kw_j)
    got = thn.keynet_hardnet_extract(h, torch.from_numpy(imgs),
                                     torch.from_numpy(vhw.astype(np.int64)), **kw_t)
    order = _same_keypoints(ref["keypoints"][0], ref["mask"][0], got["keypoints"][0],
                            got["mask"][0], ref["scales"][0], got["scales"][0])
    m = got["mask"][0].numpy()
    jm = np.asarray(ref["mask"][0])
    np.testing.assert_allclose(got["angles"][0].numpy()[m][order], np.asarray(ref["angles"][0])[jm],
                               atol=1e-4)
    np.testing.assert_allclose(got["descriptors"][0].numpy()[m][order],
                               np.asarray(ref["descriptors"][0])[jm], atol=1e-4)


def test_extractor_weight_policy(tmp_path, monkeypatch):
    """Without KeyNet, AffNet and OriNet weights the extractor takes the
    classical stages (and says so); with them, the learned ones."""
    for name, val in (("_HARDNET", None), ("_HARDNET_RANDOM", False), ("_KEYNET", tkah._UNSET),
                      ("_FRAMES", tkah._UNSET)):
        monkeypatch.setattr(tkah, name, val)
    torch.save({"state_dict": hardnet_params_from_jax(_hardnet())}, tmp_path / "HardNet++.pth")
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(tmp_path))
    cfg = {"general": {"tpu": {"device": "cpu"}}, "extractor": {"name": "keynetaffnethardnet"}}
    ext = tkah.KeyNetAffNetHardNetExtractor(cfg)
    assert ext.detector == "doh" and ext.affnet is None and ext.orinet is None
    for name, val in (("_KEYNET", tkah._UNSET), ("_FRAMES", tkah._UNSET)):
        monkeypatch.setattr(tkah, name, val)
    torch.save(keynet_params_from_jax(_keynet()), tmp_path / "keynet_pytorch.pth")
    torch.save(affnet_params_from_jax(_affnet()), tmp_path / "AffNet.pth")
    torch.save({"state_dict": orinet_params_from_jax(_orinet())}, tmp_path / "OriNet.pth")
    ext = tkah.KeyNetAffNetHardNetExtractor(cfg)
    assert ext.detector == "keynet" and ext.affnet is not None and ext.orinet is not None
    feats = ext._extract(_image(seed=7))
    assert feats["descriptors"].shape == (len(feats["keypoints"]), 128)
    assert len(feats["keypoints"]) > 10


def _reset_caches(monkeypatch):
    from deep_image_matching_tpu.extractors import keynetaffnethardnet as jkah

    monkeypatch.setattr(jkah, "_PARAMS", None)
    for name in ("_KEYNET_PARAMS", "_AFFNET_PARAMS", "_ORINET_PARAMS"):
        monkeypatch.setattr(jkah, name, "unset")
    for name, val in (("_HARDNET", None), ("_HARDNET_RANDOM", False), ("_KEYNET", tkah._UNSET),
                      ("_FRAMES", tkah._UNSET)):
        monkeypatch.setattr(tkah, name, val)


@pytest.mark.parametrize("learned", [False, True])
def test_run_matching_keynetaffnethardnet_agrees_with_jax(tmp_path, monkeypatch, learned):
    """The weight-free stages (DoH, identity shape, gradient-moment
    orientation) and the learned ones (KeyNet, AffNet, OriNet)."""
    from test_torch_disk import demo_project, run_both_and_compare

    wdir = tmp_path / "weights"
    wdir.mkdir()
    torch.save({"state_dict": hardnet_params_from_jax(_hardnet())}, wdir / "hardnet.pth")
    if learned:
        torch.save(keynet_params_from_jax(_keynet()), wdir / "keynet.pth")
        torch.save(affnet_params_from_jax(_affnet()), wdir / "affnet.pth")
        torch.save(orinet_params_from_jax(_orinet()), wdir / "orinet.pth")
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(wdir))
    _reset_caches(monkeypatch)
    # the responses are second differences of f32 blurs, which the two
    # packages sum in other orders (~1e-4 of the largest): near-equal
    # neighbours swap in the NMS, so keypoints and matches are held to 98 %
    # of their unions (measured: 7 of 1408 keypoints differ on the first
    # view); the learned frames' angles move the patches' samples, so the
    # descriptors are held within 2e-3 there
    proj = demo_project(tmp_path / "proj", size=(192, 144))
    run_both_and_compare(tmp_path, proj, "keynetaffnethardnet+kornia_matcher", "",
                         min_verified=1, share=0.98, desc_atol=2e-3 if learned else 1e-3)


def test_run_matching_superpoint_open_agrees_with_jax(tmp_path, monkeypatch):
    """superpoint_open+kornia_matcher on three views shifted by whole cells,
    with a shared seeded ``superpoint_open.pth``."""
    from test_torch_disk import run_both_and_compare
    from test_torch_pipeline import _project

    from deep_image_matching_tpu.extractors import superpoint_open as jspo
    from deep_image_matching_tpu.models import superpoint as jsp
    from deep_image_matching_tpu_torch.convert import superpoint_params_from_jax
    from deep_image_matching_tpu_torch.extractors import superpoint_open as tspo

    wdir = tmp_path / "weights"
    wdir.mkdir()
    torch.save(superpoint_params_from_jax(jsp.init_params(jax.random.PRNGKey(6))),
               wdir / "superpoint_v6_from_tf.pth")
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(wdir))
    monkeypatch.setattr(jspo, "_PARAMS", None)
    monkeypatch.setattr(tspo, "_MODEL", None)
    monkeypatch.setattr(tspo, "_MODEL_RANDOM", False)
    run_both_and_compare(tmp_path, _project(tmp_path / "proj"), "superpoint_open+kornia_matcher",
                         "", min_verified=1)
