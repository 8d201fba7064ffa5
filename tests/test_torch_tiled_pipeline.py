"""Tiled extraction and tiled matching as a whole, against the JAX package:
SuperPoint's device route (tiles cut, extracted and merged on the device,
run here on the CPU) against the JAX package's device-tiling route forced on
the CPU, and ``run_matching`` with ``--tiling`` on three demo images for SIFT
and SuperPoint + LightGlue, on shared weights (the JAX package's random
weights carried into the port by the converters). Both packages run in f32
on the CPU with host verification (OpenCV MAGSAC, seeded)."""

import shutil
from pathlib import Path

import cv2
import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_image_matching_tpu.__main__ import run_matching as jax_run_matching
from deep_image_matching_tpu.constants import TileSelection as JTileSelection
from deep_image_matching_tpu.extractors import superpoint as jspx
from deep_image_matching_tpu.matchers import tiling as jtiling
from deep_image_matching_tpu.models import lightglue as jlg
from deep_image_matching_tpu.models import superpoint as jsp
from deep_image_matching_tpu.ops import tile_merge as jmerge
from deep_image_matching_tpu.parallel import mesh as mesh_mod
from deep_image_matching_tpu.utils.image import ImageList as JImageList
from deep_image_matching_tpu_torch.__main__ import run_matching as torch_run_matching
from deep_image_matching_tpu_torch.constants import TileSelection
from deep_image_matching_tpu_torch.convert import (lightglue_params_from_jax,
                                                   superpoint_params_from_jax)
from deep_image_matching_tpu_torch.extractors import superpoint as tspx
from deep_image_matching_tpu_torch.matchers import tiling as ttiling
from deep_image_matching_tpu_torch.models import lightglue as tlg
from deep_image_matching_tpu_torch.models import superpoint as tsp
from deep_image_matching_tpu_torch.ops import tile_merge as tmerge
from deep_image_matching_tpu_torch.utils.image import ImageList
from deep_image_matching_tpu_torch.utils.tiling import Tiler

DEMO_IMAGES = Path(__file__).resolve().parents[1] / "notebooks" / "demo_project" / "images"
THREE = ("sacre_coeur_A.jpg", "sacre_coeur_B.jpg", "sacre_coeur_B180.jpg")


def _weights(wdir: Path, monkeypatch, lightglue: bool) -> None:
    """The JAX package's default (random) SuperPoint weights, and with
    ``lightglue`` its LightGlue weights, as torch checkpoints that both
    packages load; every default-weight cache starts empty."""
    wdir.mkdir(exist_ok=True)
    torch.save(superpoint_params_from_jax(jsp.init_params(jax.random.PRNGKey(0))),
               wdir / "superpoint_v1.pth")
    if lightglue:
        lg = jlg.init_params(jax.random.PRNGKey(42), n_layers=9, input_dim=256)
        torch.save(lightglue_params_from_jax(lg), wdir / "superpoint_lightglue.pth")
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(wdir))
    monkeypatch.setattr(jsp, "_DEFAULT_PARAMS", None)
    monkeypatch.setattr(jsp, "_DEFAULT_PARAMS_RANDOM", False)
    monkeypatch.setattr(jlg, "_DEFAULT_PARAMS", {})
    monkeypatch.setattr(jlg, "_DEFAULT_PARAMS_RANDOM", set())
    monkeypatch.setattr(tsp, "_DEFAULT_MODEL", None)
    monkeypatch.setattr(tsp, "_DEFAULT_MODEL_RANDOM", False)
    monkeypatch.setattr(tlg, "_DEFAULT_MODELS", {})
    monkeypatch.setattr(tlg, "_DEFAULT_RANDOM", set())


@pytest.fixture
def one_device_mesh(monkeypatch):
    """The JAX package's device-tiling route, forced on the CPU as
    ``tests/test_device_tiling.py`` forces it."""
    monkeypatch.setattr(mesh_mod, "_DEFAULT_MESH", mesh_mod.MeshRunner(jax.devices()[:1]))
    monkeypatch.setenv("DIM_TPU_FORCE_DEVICE_HANDOFF", "1")


@pytest.fixture
def demo3(tmp_path):
    proj = tmp_path / "proj"
    (proj / "images").mkdir(parents=True)
    for name in THREE:
        shutil.copy(DEMO_IMAGES / name, proj / "images" / name)
    return proj


# tiles of (w 384, h 320): four an image, so the JAX merge's candidate set
# (4 x 16384) stays within one ``jax.lax.top_k`` call; above 65536 its
# chunked top-k pads with the lowest float, which the merge takes for valid
# rows when fewer candidates than the cap remain (ROADMAP.md, §3b)
TILE, OVERLAP = (384, 320), 16


def _sp_conf(tiling, max_kpts):
    return {"extractor": {"max_keypoints": max_kpts},
            "general": {"tile_selection": tiling, "tile_size": TILE,
                        "tile_overlap": OVERLAP, "tpu": {"device": "cpu"}}}


def _keyed(kpts, scores, desc, tile):
    return {tuple(k): (s, d, t) for k, s, d, t in zip(kpts.tolist(), scores, desc, tile)}


@pytest.mark.parametrize("cap", ["above", "binding"])
def test_superpoint_tiled_extraction_equals_jax(tmp_path, demo3, monkeypatch, one_device_mesh,
                                                cap):
    """The port's device route against the JAX package's, per image: tiles
    cut from one upload, the tile batch through SuperPoint, the merge (f32,
    before the h5 write), then features.h5 from both routes. With the cap
    above the candidate count the keypoint sets are equal, scores within
    1e-5 and descriptors within 1e-4 (f32 convolutions in another summation
    order); features.h5 stores them as float16, so there within 1e-3. With
    a binding cap near-tied random-weight scores flip at the cap's edge, so
    the JAX test's set criterion holds: more than 80 % of the keypoints
    shared, and more than 90 % of the shared ones from the same tile with
    scores within 1e-3 and descriptor cosines above 0.999."""
    _weights(tmp_path / "w", monkeypatch, lightglue=False)
    max_kpts = 16384 if cap == "above" else 256
    jex = jspx.SuperPointExtractor(_sp_conf(JTileSelection.GRID, max_kpts))
    tex = tspx.SuperPointExtractor(_sp_conf(TileSelection.GRID, max_kpts))
    paths = sorted((demo3 / "images").iterdir())[:2]

    for path in paths:
        img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        origins, pad, hw = Tiler().tile_origins(img.shape, TILE, OVERLAP)
        starts = np.stack([origins[:, 1] + pad[0], origins[:, 0] + pad[2]], 1).astype(np.int32)
        jt = jmerge.cut_tiles(jnp.asarray(img), jnp.asarray(starts), tile_hw=hw, pad=tuple(pad))
        tt = tmerge.cut_tiles(torch.from_numpy(img), starts, hw, pad)
        jout = jex._extract_tiles_dev(jt)
        tout = tex._extract_tiles_dev(tt)
        wh = (img.shape[1], img.shape[0])
        ref = {k: np.asarray(v) for k, v in jmerge.merge_tile_features(
            jout["keypoints"], jout["scores"], jout["descriptors"], jout["mask"],
            jnp.asarray(origins, jnp.float32), jnp.asarray(wh, jnp.float32), max_kpts).items()}
        got = {k: v.numpy() for k, v in tmerge.merge_tile_features(
            tout["keypoints"], tout["scores"], tout["descriptors"], tout["mask"],
            torch.from_numpy(origins.astype(np.float32)), wh, max_kpts).items()}
        rm, gm = ref["mask"], got["mask"]
        r = _keyed(ref["keypoints"][rm], ref["scores"][rm], ref["descriptors"][rm],
                   ref["tile_idx"][rm])
        g = _keyed(got["keypoints"][gm], got["scores"][gm], got["descriptors"][gm],
                   got["tile_idx"][gm])
        assert len(np.unique(got["tile_idx"][gm])) >= 2
        if cap == "above":
            assert gm.sum() < max_kpts and g.keys() == r.keys()
            for key, (s, d, t) in g.items():
                assert t == r[key][2]
                assert abs(s - r[key][0]) <= 1e-5
                np.testing.assert_allclose(d, r[key][1], atol=1e-4)
        else:
            _set_criterion(g, r, score_tol=1e-3)

    jex.feature_cache, tex.feature_cache = {}, {}
    jex.extract_batch(list(JImageList(demo3 / "images"))[:2], tmp_path / "jax.h5")
    assert jex.device_handoff is not None and jex.device_handoff.tile_idx is not None
    jex.flush()
    tex.extract_batch(list(ImageList(demo3 / "images"))[:2], tmp_path / "torch.h5")
    with h5py.File(tmp_path / "jax.h5", "r") as jf, h5py.File(tmp_path / "torch.h5", "r") as tf:
        for path in paths:
            j, t = jf[path.name], tf[path.name]
            np.testing.assert_array_equal(t["image_size"][()], j["image_size"][()])
            r = _keyed(j["keypoints"][()], j["scores"][()].astype(np.float32),
                       j["descriptors"][()].T.astype(np.float32), j["tile_idx"][()])
            g = _keyed(t["keypoints"][()], t["scores"][()].astype(np.float32),
                       t["descriptors"][()].T.astype(np.float32), t["tile_idx"][()])
            # the features in the cache are the file's values
            np.testing.assert_array_equal(tex.feature_cache[path.name]["tile_idx"],
                                          t["tile_idx"][()])
            if cap == "above":
                assert g.keys() == r.keys()
                for key, (s, d, tile) in g.items():
                    assert tile == r[key][2] and abs(s - r[key][0]) <= 1e-3
                    np.testing.assert_allclose(d, r[key][1], atol=1e-3)
            else:
                _set_criterion(g, r, score_tol=1e-3)


def _set_criterion(g, r, score_tol):
    common = g.keys() & r.keys()
    assert len(common) > 0.8 * len(r)
    same_tile = [k for k in common if g[k][2] == r[k][2]]
    assert len(same_tile) > 0.9 * len(common)
    for k in same_tile:
        assert abs(g[k][0] - r[k][0]) < score_tol
        d1, d2 = g[k][1], r[k][1]
        assert float(d1 @ d2) / max(float(np.linalg.norm(d1) * np.linalg.norm(d2)), 1e-9) > 0.999


def _record_jobs(monkeypatch, module) -> list:
    """The tile pairs ``select_tile_pairs`` chose, pair by pair."""
    calls = []
    orig = module.select_tile_pairs

    def record(*args, **kwargs):
        calls.append(orig(*args, **kwargs))
        return calls[-1]

    monkeypatch.setattr(module, "select_tile_pairs", record)
    return calls


def _read(out_dir: Path):
    """Features by image, and raw and verified matches per pair as sets of
    keypoint-coordinate pairs."""
    feats, raw, ver = {}, {}, {}
    with h5py.File(out_dir / "features.h5", "r") as f:
        for name in f:
            feats[name] = {k: f[name][k][()] for k in f[name]}
    for path, out in ((out_dir / "raw_matches.h5", raw), (out_dir / "matches.h5", ver)):
        if not path.exists():  # no pair verified
            continue
        with h5py.File(path, "r") as f:
            for a in f:
                for b in f[a]:
                    m = f[a][b][()]
                    assert len(np.unique(m[:, 0])) == len(m)  # deduplicated
                    ka, kb = feats[a]["keypoints"], feats[b]["keypoints"]
                    out[(a, b)] = {tuple(ka[i]) + tuple(kb[j]) for i, j in m}
    return feats, raw, ver


# label -> (pipeline, --tiling, extra YAML under general:). The LightGlue runs
# keep every mutual nearest neighbour (random weights stay below 0.1) and
# 256 keypoints an image; their probe finds the shared LightGlue checkpoint,
# which matches nothing at 0.1, so preselection falls back to every tile pair
# in both packages. The SIFT runs' probe has no LightGlue checkpoint and
# takes mutual nearest neighbours of the shared SuperPoint's descriptors.
RUNS = {
    "sift-grid": ("sift+kornia_matcher", "grid", ""),
    "sift-exhaustive": ("sift+kornia_matcher", "exhaustive", ""),
    "sift-preselection": ("sift+kornia_matcher", "preselection", ""),
    "sift-affine": ("sift+kornia_matcher", "preselection_affine_transform", ""),
    "sift-grid-gv-per-tile": ("sift+kornia_matcher", "grid",
                              "  geometric_verification_per_tile: true\n"
                              "  gv_threshold_in_tiles_matching: 4\n"),
    "lightglue-grid": ("superpoint+lightglue", "grid", ""),
    "lightglue-preselection": ("superpoint+lightglue", "preselection", ""),
}


def tiled_run_matching_equals_jax(tmp_path, demo3, monkeypatch, run):
    """Both packages' ``run_matching`` with tiles of (400, 300) and overlap
    20: equal tile-pair jobs pair by pair, the same features with their
    tile indices, and equal raw and verified matches per pair (sets of
    coordinate pairs; the SIFT descriptors are integers, so their distances
    and ties are exact). SuperPoint's keypoints come from the device route
    in both packages (the JAX package's forced on the CPU), in one
    score-descending order, so LightGlue sees the same rows in the same
    order and its matches are held equal, as
    ``tests/test_torch_pipeline.py`` holds them."""
    pipeline, tiling, extra = RUNS[run]
    lightglue = pipeline == "superpoint+lightglue"
    _weights(tmp_path / "w", monkeypatch, lightglue=lightglue)
    if lightglue:
        monkeypatch.setattr(mesh_mod, "_DEFAULT_MESH", mesh_mod.MeshRunner(jax.devices()[:1]))
        monkeypatch.setenv("DIM_TPU_FORCE_DEVICE_HANDOFF", "1")
    cfg = tmp_path / "config.yaml"
    cfg.write_text("general:\n  tile_size: [400, 300]\n  tile_overlap: 20\n" + extra
                   + "  tpu:\n    device: cpu\n    dtype: float32\n    match_batch_size: 2\n"
                   + ("extractor:\n  max_keypoints: 256\nmatcher:\n  filter_threshold: 0.0\n"
                      if lightglue else ""))
    jobs = {"jax": _record_jobs(monkeypatch, jtiling),
            "torch": _record_jobs(monkeypatch, ttiling)}
    outs = {}
    for tag, run_fn in (("jax", jax_run_matching), ("torch", torch_run_matching)):
        feature_path, _, _ = run_fn({
            "dir": str(demo3), "outs": str(tmp_path / tag), "pipeline": pipeline,
            "strategy": "bruteforce", "tiling": tiling, "skip_reconstruction": True,
            "graph": False, "force": True, "config_file": str(cfg)})
        outs[tag] = _read(feature_path.parent)
    assert jobs["torch"] == jobs["jax"] and len(jobs["torch"]) == 3
    if tiling == "grid":
        assert all(len(j) >= 4 for j in jobs["torch"])
    jf, jraw, jver = outs["jax"]
    tf, traw, tver = outs["torch"]
    assert jf.keys() == tf.keys() == set(THREE)
    for name in jf:
        jk = {tuple(p): i for i, p in enumerate(jf[name]["keypoints"])}
        tk = {tuple(p): i for i, p in enumerate(tf[name]["keypoints"])}
        assert jk.keys() == tk.keys()
        ji, ti = np.array([jk[p] for p in tk]), np.array([tk[p] for p in tk])
        np.testing.assert_array_equal(tf[name]["tile_idx"][ti], jf[name]["tile_idx"][ji])
        assert len(np.unique(tf[name]["tile_idx"])) >= 2
        # stored as float16: one f16 ulp of the f32 values' differences
        np.testing.assert_allclose(tf[name]["descriptors"][:, ti].astype(np.float32),
                                   jf[name]["descriptors"][:, ji].astype(np.float32), atol=1e-3)
        np.testing.assert_allclose(tf[name]["scores"][ti].astype(np.float32),
                                   jf[name]["scores"][ji].astype(np.float32), rtol=1e-3)
    assert traw.keys() == jraw.keys() and len(traw) == 3
    for pair in jraw:
        assert traw[pair] == jraw[pair], pair
    assert tver.keys() == jver.keys()
    if not lightglue:  # the demo images are one scene
        assert len(tver) >= 1
    for pair in jver:
        assert tver[pair] == jver[pair], pair


# The two LightGlue runs take most of this file's time, so each has a file of
# its own (test_torch_tiled_lightglue_grid.py and
# test_torch_tiled_lightglue_preselection.py) that parallel workers run beside
# this one; all three call ``tiled_run_matching_equals_jax``.
@pytest.mark.parametrize("run", [r for r in RUNS if not r.startswith("lightglue")])
def test_tiled_run_matching_equals_jax(tmp_path, demo3, monkeypatch, run):
    tiled_run_matching_equals_jax(tmp_path, demo3, monkeypatch, run)


def test_roma_probe_selected_by_config(demo3, monkeypatch):
    """``preselection_pipeline: roma`` wires the RoMa probe into tile
    selection on the matcher's device (the probe stubbed, as
    ``tests/test_tiled_matching.py`` stubs it; ``test_roma_match_images``
    runs the real pass)."""
    calls = {}

    class _StubRoma:
        def __init__(self, device):
            calls["device"] = device

        def matches(self, p0, p1):
            calls.setdefault("pairs", []).append((p0.name, p1.name))
            return np.zeros((0, 2), np.float32), np.zeros((0, 2), np.float32)

    monkeypatch.setattr(ttiling, "RomaProbe", _StubRoma)
    cfg = demo3 / "config.yaml"
    cfg.write_text("general:\n  tile_size: [400, 300]\n  preselection_pipeline: roma\n"
                   "  tpu:\n    device: cpu\n")
    torch_run_matching({"dir": str(demo3), "pipeline": "sift+kornia_matcher",
                        "strategy": "bruteforce", "tiling": "preselection",
                        "skip_reconstruction": True, "graph": False, "force": True,
                        "config_file": str(cfg)})
    assert calls["device"] == torch.device("cpu") and len(calls["pairs"]) == 3


def test_roma_match_images(demo3, monkeypatch):
    """``RomaMatcher._match_images``, which the RoMa probe calls: one pair's
    sampled full-resolution coordinates, the same as the batched route's."""
    from deep_image_matching_tpu_torch.matchers import roma as troma

    monkeypatch.setattr(troma, "_PARAMS", None)
    monkeypatch.setattr(troma, "_PARAMS_RANDOM", False)
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(demo3 / "no_weights"))
    conf = {"matcher": {"coarse_res": 112, "upsample_preds": False, "num_sampled_points": 200},
            "general": {"tpu": {"device": "cpu"}}}
    paths = sorted((demo3 / "images").iterdir())[:2]
    k0, k1 = troma.RomaMatcher(conf)._match_images(*paths)
    ref = troma.RomaMatcher(conf)
    r0, r1 = ref._finish_images_batch(ref._dispatch_images_batch([tuple(paths)]))[0]
    assert k0.shape == k1.shape == (200, 2)
    np.testing.assert_array_equal(k0, r0)
    np.testing.assert_array_equal(k1, r1)


@pytest.mark.parametrize("tiling", ["grid", "exhaustive", "preselection",
                                    "preselection_affine_transform"])
def test_cli_takes_every_tiling(tiling):
    from deep_image_matching_tpu_torch.config import Config
    from deep_image_matching_tpu_torch.parser import build_parser

    args = vars(build_parser().parse_args(
        ["--dir", str(DEMO_IMAGES.parent), "--pipeline", "sift+kornia_matcher",
         "--tiling", tiling]))
    assert Config(args=args).general["tile_selection"] is getattr(TileSelection, tiling.upper())


def test_tiled_cli_through_reconstruction(demo3, monkeypatch):
    """``--tiling preselection_affine_transform`` through stage 5 on the CPU:
    the tiled features and verified matches make a model."""
    from deep_image_matching_tpu_torch.__main__ import main

    _weights(demo3 / "w", monkeypatch, lightglue=False)
    cfg = demo3 / "config.yaml"
    cfg.write_text("general:\n  tile_size: [400, 300]\n  tpu:\n    device: cpu\n")
    monkeypatch.setattr("sys.argv", [
        "deep_image_matching_tpu_torch", "--dir", str(demo3), "--pipeline",
        "sift+kornia_matcher", "--strategy", "bruteforce", "--tiling",
        "preselection_affine_transform", "--config_file", str(cfg), "--force"])
    main()
    out = next(p for p in demo3.iterdir() if p.name.startswith("results"))
    with h5py.File(out / "features.h5", "r") as f:
        assert all("tile_idx" in f[name] for name in THREE)
    images = (out / "reconstruction" / "images.txt").read_text().splitlines()
    assert sum(1 for line in images if line and not line.startswith("#")) // 2 >= 2


def test_sift_tiled_extraction_equals_jax(tmp_path, demo3):
    """SIFT's host template with ``--tiling grid``: features.h5 and
    ``feature_cache`` hold the JAX package's keypoints, descriptors, scores
    and tile indices, equal."""
    from deep_image_matching_tpu.extractors.sift import SIFTExtractor as JSIFT
    from deep_image_matching_tpu_torch.extractors.sift import SIFTExtractor as TSIFT

    def conf(tiling):
        return {"extractor": {}, "general": {"tile_selection": tiling, "tile_size": (400, 300),
                                             "tile_overlap": 20}}

    jex, tex = JSIFT(conf(JTileSelection.GRID)), TSIFT(conf(TileSelection.GRID))
    jex.feature_cache, tex.feature_cache = {}, {}
    jex.extract_batch(list(JImageList(demo3 / "images")), tmp_path / "jax.h5")
    tex.extract_batch(list(ImageList(demo3 / "images")), tmp_path / "torch.h5")
    with h5py.File(tmp_path / "jax.h5", "r") as jf, h5py.File(tmp_path / "torch.h5", "r") as tf:
        assert sorted(jf) == sorted(tf) == sorted(THREE)
        for name in jf:
            assert sorted(jf[name]) == sorted(tf[name])
            for k in jf[name]:
                np.testing.assert_array_equal(tf[name][k][()], jf[name][k][()], err_msg=k)
            assert len(np.unique(tf[name]["tile_idx"][()])) >= 4
    for name in THREE:
        for k, v in jex.feature_cache[name].items():
            np.testing.assert_array_equal(tex.feature_cache[name][k], v, err_msg=k)


def test_superpoint_host_template_equals_jax(tmp_path, demo3, monkeypatch):
    """SuperPoint's ``extract`` with ``--tiling``: the host template, each
    tile batch through ``_extract_many`` (the runner's padded batches, as the
    JAX package's), in the host template's image order. Tiles of (384, 320)
    are multiples of the runner's 64-pixel buckets, so both packages run the
    convolutions on the same shapes: equal keypoints and tile indices,
    scores within 1e-5 (f32 convolutions in another summation order) and
    descriptors within one float16 ulp, 1e-3 (the runner returns them as
    float16, the storage type of features.h5), a cap above the candidate
    count. Within a tile
    near-equal scores may sort in another order, so the rows are compared
    by keypoint."""
    _weights(tmp_path / "w", monkeypatch, lightglue=False)
    path = demo3 / "images" / THREE[1]
    jf = jspx.SuperPointExtractor(_sp_conf(JTileSelection.GRID, 16384)).extract(path)
    tf = tspx.SuperPointExtractor(_sp_conf(TileSelection.GRID, 16384)).extract(path)
    r = _keyed(jf["keypoints"], jf["scores"], jf["descriptors"], jf["tile_idx"])
    g = _keyed(tf["keypoints"], tf["scores"], tf["descriptors"], tf["tile_idx"])
    assert g.keys() == r.keys() and len(g) == len(tf["keypoints"])
    for key, (sc, d, t) in g.items():
        assert t == r[key][2] and abs(sc - r[key][0]) <= 1e-5
        np.testing.assert_allclose(d.astype(np.float32), r[key][1].astype(np.float32), atol=1e-3)
    assert len(np.unique(tf["tile_idx"])) >= 4
