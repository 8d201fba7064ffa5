"""The slices as a whole: both packages' ``run_matching`` on the same
images, with the JAX package's default weights carried into the port
through the converters. SuperPoint pipelines run on three synthetic images,
the OpenCV extractors (SIFT, ORB) on the five demo images. Both packages
run on the CPU in f32 with host verification (OpenCV MAGSAC, seeded), so
the outputs must agree."""

import shutil
import sqlite3
from pathlib import Path

import cv2
import h5py
import numpy as np
import pytest
import torch

import jax

from deep_image_matching_tpu.__main__ import run_matching as jax_run_matching
from deep_image_matching_tpu.matchers import superglue as jsgm
from deep_image_matching_tpu.models import lightglue as jlg
from deep_image_matching_tpu.models import superglue as jsg
from deep_image_matching_tpu.models import superpoint as jsp
from deep_image_matching_tpu_torch.__main__ import run_matching as torch_run_matching
from deep_image_matching_tpu_torch.convert import (
    lightglue_params_from_jax,
    superglue_params_from_jax,
    superpoint_params_from_jax,
)
from deep_image_matching_tpu_torch.models import lightglue as tlg
from deep_image_matching_tpu_torch.models import superglue as tsg
from deep_image_matching_tpu_torch.models import superpoint as tsp

DEMO_IMAGES = Path(__file__).resolve().parents[1] / "notebooks" / "demo_project" / "images"


def _project(root):
    """Three 240 x 320 views: a textured crop and two copies shifted by whole
    SuperPoint cells, so random-weight descriptors still match."""
    rng = np.random.default_rng(0)
    tex = cv2.GaussianBlur(rng.integers(0, 256, (400, 500), dtype=np.uint8), (0, 0), 2)
    for _ in range(60):
        c = tuple(int(v) for v in rng.integers(0, 500, 2))
        cv2.circle(tex, c, int(rng.integers(3, 20)), int(rng.integers(0, 256)), -1)
    tex = cv2.normalize(tex, None, 0, 255, cv2.NORM_MINMAX)
    (root / "images").mkdir(parents=True)
    for i, (dy, dx) in enumerate([(40, 40), (56, 24), (32, 72)]):
        cv2.imwrite(str(root / "images" / f"img_{i}.png"), tex[dy:dy + 240, dx:dx + 320])
    return root


@pytest.fixture
def shared_weights(tmp_path, monkeypatch):
    """The JAX package's default (random) weights as torch checkpoints that
    both packages load; every default-weight cache starts empty."""
    wdir = tmp_path / "weights"
    wdir.mkdir()
    sp = jsp.init_params(jax.random.PRNGKey(0))
    lg = jlg.init_params(jax.random.PRNGKey(42), n_layers=9, input_dim=256)
    torch.save(superpoint_params_from_jax(sp), wdir / "superpoint_v1.pth")
    torch.save(lightglue_params_from_jax(lg), wdir / "superpoint_lightglue.pth")
    torch.save(superglue_params_from_jax(jsg.init_params(jax.random.PRNGKey(7))),
               wdir / "superglue_outdoor.pth")
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(wdir))
    monkeypatch.setattr(jsp, "_DEFAULT_PARAMS", None)
    monkeypatch.setattr(jsp, "_DEFAULT_PARAMS_RANDOM", False)
    monkeypatch.setattr(jlg, "_DEFAULT_PARAMS", {})
    monkeypatch.setattr(jlg, "_DEFAULT_PARAMS_RANDOM", set())
    monkeypatch.setattr(jsgm, "_PARAM_CACHE", {})
    monkeypatch.setattr(tsp, "_DEFAULT_MODEL", None)
    monkeypatch.setattr(tsp, "_DEFAULT_MODEL_RANDOM", False)
    monkeypatch.setattr(tlg, "_DEFAULT_MODELS", {})
    monkeypatch.setattr(tlg, "_DEFAULT_RANDOM", set())
    monkeypatch.setattr(tsg, "_DEFAULT_MODELS", {})
    monkeypatch.setattr(tsg, "_DEFAULT_RANDOM", set())


def _read(out_dir):
    """features by image (keypoints as rows), and matches as sets of
    keypoint-coordinate pairs, so keypoint order does not matter."""
    feats, raw, ver = {}, {}, {}
    with h5py.File(out_dir / "features.h5", "r") as f:
        for name in f:
            feats[name] = {k: f[name][k][()] for k in f[name]}
    for path, out in ((out_dir / "raw_matches.h5", raw), (out_dir / "matches.h5", ver)):
        with h5py.File(path, "r") as f:
            for a in f:
                for b in f[a]:
                    m = f[a][b][()]
                    ka, kb = feats[a]["keypoints"], feats[b]["keypoints"]
                    out[(a, b)] = {tuple(ka[i]) + tuple(kb[j]) for i, j in m}
    db = sqlite3.connect(str(out_dir / "database.db"))
    tables = {t: db.execute(f"SELECT COUNT(*) FROM {t}").fetchone()[0]
              for t in ("cameras", "images", "keypoints", "matches", "two_view_geometries")}
    images = sorted(db.execute("SELECT name, camera_id FROM images").fetchall())
    cams = sorted(db.execute("SELECT model, width, height, params FROM cameras").fetchall())
    db.close()
    return feats, raw, ver, tables, images, cams


# pipeline -> (images, extra YAML). Random weights never reach LightGlue's
# 0.1 or SuperGlue's 0.3 match score, so those keep every mutual nearest
# neighbour (threshold 0); SuperGlue's 4096 keypoints are capped at 1024 to
# keep the CPU run short. The JAX package's CPU nearest-neighbour route holds
# (B, K, K) distances, so the demo runs match 2 pairs per batch.
PIPELINES = {
    "superpoint+lightglue": ("synthetic", "matcher:\n  filter_threshold: 0.0\n"),
    "superpoint+superglue": ("synthetic", "extractor:\n  max_keypoints: 1024\n"
                                          "matcher:\n  match_threshold: 0.0\n"),
    "superpoint+kornia_matcher": ("synthetic", ""),
    "sift+kornia_matcher": ("demo", ""),
    "orb+kornia_matcher": ("demo", ""),
}


@pytest.mark.parametrize("pipeline", list(PIPELINES))
def test_run_matching_agrees_with_jax(tmp_path, shared_weights, pipeline):
    images, extra = PIPELINES[pipeline]
    if images == "synthetic":
        proj = _project(tmp_path / "proj")
        tpu = "general:\n  tpu:\n    device: cpu\n    dtype: float32\n"
    else:
        proj = tmp_path / "proj"
        shutil.copytree(DEMO_IMAGES, proj / "images")
        tpu = "general:\n  tpu:\n    device: cpu\n    dtype: float32\n    match_batch_size: 2\n"
    n_images = len(list((proj / "images").iterdir()))
    cfg = tmp_path / "config.yaml"
    cfg.write_text(tpu + extra)  # f32 matcher on both sides
    outs = {}
    for tag, run in (("jax", jax_run_matching), ("torch", torch_run_matching)):
        feature_path, _, _ = run({
            "dir": str(proj), "outs": str(tmp_path / tag), "pipeline": pipeline,
            "strategy": "bruteforce", "skip_reconstruction": True, "graph": False,
            "force": True, "config_file": str(cfg),
        })
        outs[tag] = _read(feature_path.parent)
    assert_outputs_agree(outs["jax"], outs["torch"], n_images, pipeline)


def assert_outputs_agree(jax_out, torch_out, n_images, pipeline):
    """The two packages' outputs (``_read``) agree: the same keypoints as
    sets with their descriptors, scores and sizes, the same raw and verified
    matches pair by pair, the same database rows."""
    jf, jraw, jver, jtab, jimg, jcam = jax_out
    tf, traw, tver, ttab, timg, tcam = torch_out
    assert jf.keys() == tf.keys() and len(jf) == n_images
    for name in jf:
        jk = {tuple(p): i for i, p in enumerate(jf[name]["keypoints"])}
        tk = {tuple(p): i for i, p in enumerate(tf[name]["keypoints"])}
        assert jk.keys() == tk.keys()
        ji = np.array([jk[p] for p in tk])
        ti = np.array([tk[p] for p in tk])
        # stored as float16: one f16 ulp of the f32 values' differences
        np.testing.assert_allclose(tf[name]["descriptors"][:, ti].astype(np.float32),
                                   jf[name]["descriptors"][:, ji].astype(np.float32), atol=1e-3)
        np.testing.assert_allclose(tf[name]["scores"][ti].astype(np.float32),
                                   jf[name]["scores"][ji].astype(np.float32), rtol=1e-3)
        np.testing.assert_array_equal(tf[name]["image_size"], jf[name]["image_size"])
    assert jraw.keys() == traw.keys() and len(jraw) == n_images * (n_images - 1) // 2
    for pair in jraw:
        assert traw[pair] == jraw[pair], pair
    assert jver.keys() == tver.keys() and len(jver) >= 1
    if pipeline == "sift+kornia_matcher":  # the demo images are one scene
        assert len(jver) == 10
    for pair in jver:
        assert tver[pair] == jver[pair], pair
    assert ttab == jtab and timg == jimg and tcam == jcam


def test_lowres_probe_runners_agree_with_jax(tmp_path, shared_weights):
    """The probe's two runners (SuperPoint with a resize, LightGlue match
    counting over padded pair batches) give the same keypoints and counts."""
    from deep_image_matching_tpu.low_resolution import _probe_backend as jax_backend
    from deep_image_matching_tpu_torch.low_resolution import _probe_backend as torch_backend

    proj = _project(tmp_path / "proj")
    paths = sorted((proj / "images").iterdir())
    pairs = [(0, 1), (0, 2), (1, 2)]
    jsp_runner, _ = jax_backend(max_keypoints=512, resize_max=200)
    tsp_runner, _ = torch_backend(max_keypoints=512, resize_max=200, device=torch.device("cpu"))
    jfeats = jsp_runner.extract_images(paths)
    tfeats = tsp_runner.extract_images(paths)
    for jf, tf in zip(jfeats, tfeats):
        assert {tuple(p) for p in jf["keypoints"]} == {tuple(p) for p in tf["keypoints"]}
    # every mutual nearest neighbour counts (random weights stay below 0.1)
    jcounts = jlg.LightGlueRunner(features="superpoint", filter_threshold=0.0,
                                  compute_dtype="float32").count_matches_pairs(jfeats, pairs)
    tcounts = tlg.LightGlueRunner(features="superpoint", filter_threshold=0.0
                                  ).count_matches_pairs(tfeats, pairs)
    assert tcounts == jcounts and min(jcounts) > 0
