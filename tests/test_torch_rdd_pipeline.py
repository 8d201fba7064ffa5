"""``run_matching --pipeline rdd_sparse+lightglue`` of both packages on
three demo images at low quality, on the CPU in f32 with host
verification, with one seeded RDD checkpoint (``test_torch_rdd.params``)
and the JAX package's random LightGlue weights. In a file of its own so
that a test worker takes it beside the module tests."""

from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

from deep_image_matching_tpu.extractors import rdd_sparse as jext
from deep_image_matching_tpu.models import lightglue as jlg
from deep_image_matching_tpu_torch.convert import lightglue_params_from_jax
from deep_image_matching_tpu_torch.extractors import rdd_sparse as text
from deep_image_matching_tpu_torch.models import lightglue as tlg

from test_torch_aliked import _read, _same_rows
from test_torch_rdd import params  # noqa: F401  (the module fixture)

DEMO_IMAGES = Path(__file__).resolve().parents[1] / "notebooks" / "demo_project" / "images"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread for this file: in a test worker beside busy others
    each parallel op waits on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_run_matching_rdd_sparse_lightglue_agrees_with_jax(tmp_path, monkeypatch, params):
    """Both packages' run_matching on three demo images (each 640 x 512 on
    disk, 160 x 128 at low quality) with one RDD checkpoint and the JAX
    package's random LightGlue weights for RDD's 256-wide descriptors, in f32
    with host verification: keypoints equal as sets within 1e-4 px,
    descriptors within one f16 ulp, raw and verified matches equal."""
    from deep_image_matching_tpu.__main__ import run_matching as jax_run_matching
    from deep_image_matching_tpu_torch.__main__ import run_matching as torch_run_matching

    _, sd, _ = params
    wdir = tmp_path / "weights"
    wdir.mkdir()
    torch.save(sd, wdir / "RDD-v2.pth")
    torch.save(lightglue_params_from_jax(
        jlg.init_params(jax.random.PRNGKey(42), n_layers=9, input_dim=256)),
        wdir / "rdd_sparse_lightglue.pth")
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(wdir))
    monkeypatch.setattr(jext, "_PARAMS", None)
    monkeypatch.setattr(jlg, "_DEFAULT_PARAMS", {})
    monkeypatch.setattr(jlg, "_DEFAULT_PARAMS_RANDOM", set())
    monkeypatch.setattr(text, "_PARAMS", None)
    monkeypatch.setattr(text, "_PARAMS_RANDOM", False)
    monkeypatch.setattr(tlg, "_DEFAULT_MODELS", {})
    monkeypatch.setattr(tlg, "_DEFAULT_RANDOM", set())
    proj = tmp_path / "proj"
    (proj / "images").mkdir(parents=True)
    for name in ("sacre_coeur_A.jpg", "sacre_coeur_B.jpg", "sacre_coeur_squared.jpg"):
        img = cv2.resize(cv2.imread(str(DEMO_IMAGES / name)), (640, 512),
                         interpolation=cv2.INTER_AREA)
        cv2.imwrite(str(proj / "images" / name.replace(".jpg", ".png")), img)
    cfg = tmp_path / "config.yaml"
    cfg.write_text("general:\n  tpu:\n    device: cpu\n    dtype: float32\n"
                   "extractor:\n  max_num_keypoints: 256\nmatcher:\n  filter_threshold: 0.0\n")
    outs = {}
    for tag, run in (("jax", jax_run_matching), ("torch", torch_run_matching)):
        feature_path, _, _ = run({
            "dir": str(proj), "outs": str(tmp_path / tag), "pipeline": "rdd_sparse+lightglue",
            "strategy": "bruteforce", "quality": "low", "skip_reconstruction": True,
            "graph": False, "force": True, "config_file": str(cfg),
        })
        outs[tag] = _read(feature_path.parent)
    jf, jraw, jver, jtab, jimg = outs["jax"]
    tf, traw, tver, ttab, timg = outs["torch"]
    assert jf.keys() == tf.keys() and len(jf) == 3
    to_jax = {}
    for name in jf:
        assert len(jf[name]["keypoints"]) > 100
        idx = _same_rows(jf[name]["keypoints"], tf[name]["keypoints"], 1e-4)
        to_jax[name] = np.argsort(idx)
        np.testing.assert_allclose(tf[name]["descriptors"][:, idx].astype(np.float32),
                                   jf[name]["descriptors"].astype(np.float32), atol=1e-3)
        np.testing.assert_array_equal(tf[name]["image_size"], jf[name]["image_size"])

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
