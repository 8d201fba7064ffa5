"""ALIKE in the port against the JAX package on the CPU, all four
configurations (t, s, n and l, whose head has two layers) at narrow sizes:
the converter's round trip (exact), the folded parameters (exact), the
dense maps (within 1e-5 of their largest magnitude), ``extract``
(keypoints equal as sets within 1e-4 px, scores within 1e-5, descriptors
within 1e-4), the extractor on a seeded checkpoint against the JAX
package's (features.h5: keypoints within 1e-4 px, descriptors within one
f16 ulp), ``FileNotFoundError`` without a checkpoint, and ``run_matching``
with an ALIKE YAML and kornia_matcher. Inputs come from a numpy seed."""

from pathlib import Path

import cv2
import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_image_matching_tpu.extractors import alike as jext
from deep_image_matching_tpu.models import alike as jal
from deep_image_matching_tpu_torch.convert import alike_params_from_jax
from deep_image_matching_tpu_torch.extractors import alike as text
from deep_image_matching_tpu_torch.models import alike as tal

from test_torch_aliked import _read, _same_rows

DEMO_IMAGES = Path(__file__).resolve().parents[1] / "notebooks" / "demo_project" / "images"
MODELS = ("alike-t", "alike-s", "alike-n", "alike-l")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread for this file: in a test worker beside busy others
    each parallel op waits on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def alike_state_dict(model_name: str, seed: int = 0) -> dict:
    """A seeded ALNet checkpoint in the upstream key layout (ALIKE has no
    random initialisation): He-normal convolutions, BatchNorms with running
    statistics, the /8 and /32 blocks' share of the aggregation damped, and
    the score channel of the head scaled so that the sigmoid scores spread
    around the 0.2 threshold. ``chip_smoke.alike_state_dict`` builds the
    same."""
    cfg = tal.CONFIGS[model_name]
    c1, c2, c3, c4, dim = (cfg[k] for k in ("c1", "c2", "c3", "c4", "dim"))
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, co, ci, k, bias=False, std=None):
        std = (2.0 / (ci * k * k)) ** 0.5 if std is None else std
        sd[f"{name}.weight"] = rng.normal(0, std, (co, ci, k, k))
        if bias:
            sd[f"{name}.bias"] = rng.normal(0, 0.05, co)

    def bn(name, n):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, n)
        sd[f"{name}.bias"] = rng.normal(0, 0.1, n)
        sd[f"{name}.running_mean"] = rng.normal(0, 0.1, n)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, n)
        sd[f"{name}.num_batches_tracked"] = np.array(0)

    for b, ci, co in ((1, 3, c1), (2, c1, c2), (3, c2, c3), (4, c3, c4)):
        conv(f"block{b}.conv1", co, ci, 3)
        bn(f"block{b}.bn1", co)
        conv(f"block{b}.conv2", co, co, 3)
        bn(f"block{b}.bn2", co)
        if b > 1:
            conv(f"block{b}.downsample", co, ci, 1, bias=True)
    for i, c in enumerate((c1, c2, c3, c4), 1):
        conv(f"conv{i}", dim // 4, c, 1, std=(2.0 / c) ** 0.5 * (0.1 if i > 2 else 1.0))
    if not cfg["single_head"]:
        conv("convhead1", dim, dim, 1)
    conv("convhead2", dim + 1, dim, 1)
    sd["convhead2.weight"][-1] *= 0.1
    return {k: torch.tensor(v, dtype=torch.int64 if v.ndim == 0 else torch.float32)
            for k, v in sd.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _images():
    """Two demo images at 64 x 96 and 50 x 80, uint8, padded to 64 x 96."""
    batch = np.zeros((2, 64, 96, 3), np.uint8)
    for i, (name, (h, w)) in enumerate((("sacre_coeur_A.jpg", (64, 96)),
                                        ("sacre_coeur_B.jpg", (50, 80)))):
        batch[i, :h, :w] = cv2.resize(cv2.imread(str(DEMO_IMAGES / name))[..., ::-1], (w, h),
                                      interpolation=cv2.INTER_AREA)
    return batch, np.array([[64, 96], [50, 80]], np.int64)


@pytest.mark.parametrize("model", MODELS)
def test_alike_converter_round_trip(model):
    sd = alike_state_dict(model)
    jp = jal.params_from_torch(sd, model)
    back = jal.params_from_torch(alike_params_from_jax(jp), model)
    tp = tal.params_from_torch(sd, model)
    assert jp.keys() == back.keys() == tp.keys()
    assert ("head1" in tp) == (model == "alike-l")
    for blk in jp:
        for name in jp[blk] if "w" not in jp[blk] else [None]:
            a = jp[blk] if name is None else jp[blk][name]
            b = back[blk] if name is None else back[blk][name]
            t = tp[blk] if name is None else tp[blk][name]
            assert a.keys() == b.keys() == t.keys()
            for k in a:
                np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))
                ref = np.asarray(a[k])
                np.testing.assert_array_equal(t[k].numpy(),
                                              ref.transpose(3, 2, 0, 1) if k == "w" else ref)


@pytest.mark.parametrize("model", MODELS)
def test_alike_dense_and_extract_match_jax(model):
    sd = alike_state_dict(model)
    jp, tp = jal.params_from_torch(sd, model), tal.params_from_torch(sd, model)
    batch, vhw = _images()
    imgs = batch.astype(np.float32) / 255.0
    jd, js = jal.dense_forward(jp, jnp.asarray(imgs))
    td, ts = tal.dense_forward(tp, torch.from_numpy(batch))
    assert td.shape == (2, 64, 96, tal.CONFIGS[model]["dim"])
    assert _rel(td, jd) < 1e-5 and _rel(ts, js) < 1e-5
    ref = jal.extract(jp, jnp.asarray(imgs), jnp.asarray(vhw, jnp.int32), max_keypoints=256)
    got = tal.extract(tp, torch.from_numpy(batch), torch.from_numpy(vhw), max_keypoints=256)
    for b in range(2):
        rm, gm = np.asarray(ref["mask"][b]), got["mask"][b].numpy()
        assert rm.sum() == gm.sum() > 20
        idx = _same_rows(np.asarray(ref["keypoints"][b])[rm], got["keypoints"][b].numpy()[gm],
                         1e-4)
        np.testing.assert_allclose(got["scores"][b].numpy()[gm][idx],
                                   np.asarray(ref["scores"][b])[rm], atol=1e-5)
        np.testing.assert_allclose(got["descriptors"][b].numpy()[gm][idx],
                                   np.asarray(ref["descriptors"][b])[rm], atol=1e-4)
        assert not got["descriptors"][b].numpy()[~gm].any()


@pytest.fixture
def alike_weights(tmp_path, monkeypatch):
    """Seeded ``alike-n.pth`` and ``alike-s.pth`` in a weights directory of
    their own, both packages' parameter caches emptied."""
    wdir = tmp_path / "weights"
    wdir.mkdir()
    for model in ("alike-n", "alike-s"):
        torch.save(alike_state_dict(model), wdir / f"{model}.pth")
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(wdir))
    monkeypatch.setattr(jext, "_PARAM_CACHE", {})
    monkeypatch.setattr(text, "_PARAM_CACHE", {})
    return wdir


def _project(root: Path, size=(160, 128)) -> Path:
    """Three demo images at one size (w, h) on disk."""
    (root / "images").mkdir(parents=True)
    for name in ("sacre_coeur_A.jpg", "sacre_coeur_B.jpg", "sacre_coeur_squared.jpg"):
        img = cv2.resize(cv2.imread(str(DEMO_IMAGES / name)), size, interpolation=cv2.INTER_AREA)
        cv2.imwrite(str(root / "images" / name.replace(".jpg", ".png")), img)
    return root


def test_alike_extractor_matches_jax(tmp_path, alike_weights):
    """Both packages' extractors over three images at the default settings
    (alike-n, a cap of 8192 keypoints): features.h5 equal within the
    tolerances, descriptors 128 wide."""
    from deep_image_matching_tpu.utils.image import ImageList as JImageList
    from deep_image_matching_tpu_torch.utils.image import ImageList

    proj = _project(tmp_path / "proj")
    jext.AlikeExtractor({"extractor": {}, "general": {}}).extract_batch(
        list(JImageList(proj / "images")), tmp_path / "jax.h5")
    ext = text.AlikeExtractor({"extractor": {}, "general": {"tpu": {"device": "cpu"}}})
    assert ext.descriptor_size == 128 and ext.max_keypoints == 15000
    ext.extract_batch(list(ImageList(proj / "images")), tmp_path / "torch.h5")
    with h5py.File(tmp_path / "jax.h5", "r") as jf, h5py.File(tmp_path / "torch.h5", "r") as tf:
        assert sorted(jf) == sorted(tf) and len(tf) == 3
        for name in jf:
            jk, tk = jf[name]["keypoints"][()], tf[name]["keypoints"][()]
            assert len(jk) > 100
            idx = _same_rows(jk, tk, 1e-4)
            np.testing.assert_allclose(tf[name]["descriptors"][()][:, idx].astype(np.float32),
                                       jf[name]["descriptors"][()].astype(np.float32), atol=1e-3)
            np.testing.assert_array_equal(tf[name]["image_size"][()], jf[name]["image_size"][()])


def test_alike_without_checkpoint_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(text, "_PARAM_CACHE", {})
    with pytest.raises(FileNotFoundError, match="alike-t"):
        text.AlikeExtractor({"extractor": {"model": "alike-t"},
                             "general": {"tpu": {"device": "cpu"}}})


def test_run_matching_alike_kornia_agrees_with_jax(tmp_path, alike_weights):
    """An ALIKE YAML (``extractor: {name: alike, model: alike-s}``) over the
    sift+kornia_matcher preset, both packages on three images in f32 with
    host verification: keypoints within 1e-4 px, raw and verified matches
    equal (the port's run goes through the device handoff)."""
    from deep_image_matching_tpu.__main__ import run_matching as jax_run_matching
    from deep_image_matching_tpu_torch.__main__ import run_matching as torch_run_matching

    proj = _project(tmp_path / "proj", size=(320, 256))
    cfg = tmp_path / "config.yaml"
    cfg.write_text("general:\n  tpu:\n    device: cpu\n    dtype: float32\n"
                   "extractor:\n  name: alike\n  model: alike-s\n  n_limit: 1024\n")
    outs = {}
    for tag, run in (("jax", jax_run_matching), ("torch", torch_run_matching)):
        feature_path, _, _ = run({
            "dir": str(proj), "outs": str(tmp_path / tag), "pipeline": "sift+kornia_matcher",
            "strategy": "bruteforce", "skip_reconstruction": True, "graph": False,
            "force": True, "config_file": str(cfg),
        })
        outs[tag] = _read(feature_path.parent)
    jf, jraw, jver, jtab, jimg = outs["jax"]
    tf, traw, tver, ttab, timg = outs["torch"]
    assert jf.keys() == tf.keys() and len(jf) == 3
    to_jax = {}
    for name in jf:
        assert jf[name]["descriptors"].shape[0] == 96 and len(jf[name]["keypoints"]) > 100
        idx = _same_rows(jf[name]["keypoints"], tf[name]["keypoints"], 1e-4)
        to_jax[name] = np.argsort(idx)
        np.testing.assert_allclose(tf[name]["descriptors"][:, idx].astype(np.float32),
                                   jf[name]["descriptors"].astype(np.float32), atol=1e-3)

    def as_jax(pair, m):
        a, b = pair
        return {(int(to_jax[a][i]), int(to_jax[b][j])) for i, j in m}

    assert jraw.keys() == traw.keys() and len(jraw) == 3
    assert sum(len(m) for m in jraw.values()) > 10
    for pair in jraw:
        assert as_jax(pair, traw[pair]) == {tuple(r) for r in jraw[pair].tolist()}, pair
    assert jver.keys() == tver.keys()
    for pair in jver:
        assert as_jax(pair, tver[pair]) == {tuple(r) for r in jver[pair].tolist()}, pair
    assert ttab == jtab and timg == jimg
