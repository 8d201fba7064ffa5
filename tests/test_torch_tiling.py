"""The port's tiling units against the JAX package's: the Tiler, the tile cut
and the merge on the device, tile-pair selection, the affine fit and the
low-resolution probe's LightGlue branch. Inputs are seeded numpy arrays;
every comparison is exact unless a tolerance is stated."""

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_image_matching_tpu.constants import TileSelection as JTileSelection
from deep_image_matching_tpu.matchers import tiling as jtiling
from deep_image_matching_tpu.models import lightglue as jlg
from deep_image_matching_tpu.models import superpoint as jsp
from deep_image_matching_tpu.ops import tile_merge as jmerge
from deep_image_matching_tpu.utils.tiling import Tiler as JTiler
from deep_image_matching_tpu_torch.constants import TileSelection
from deep_image_matching_tpu_torch.convert import (lightglue_params_from_jax,
                                                   superpoint_params_from_jax)
from deep_image_matching_tpu_torch.matchers import tiling as ttiling
from deep_image_matching_tpu_torch.models import lightglue as tlg
from deep_image_matching_tpu_torch.models import superpoint as tsp
from deep_image_matching_tpu_torch.ops import tile_merge as tmerge
from deep_image_matching_tpu_torch.utils.tiling import Tiler


# (image (h, w[, C]), tile size (w, h) or int, overlap (x, y) or int)
TILER_CASES = [
    ((100, 100, 3), 50, 0),
    ((100, 100, 3), 40, 0),
    ((100, 100), 50, 10),
    ((190, 260), (128, 96), 16),
    ((480, 640, 3), (400, 300), 20),
    ((641, 479), (200, 150), (30, 12)),
]


@pytest.mark.parametrize("shape,size,overlap", TILER_CASES)
def test_tiler_equals_jax(shape, size, overlap):
    img = np.random.default_rng(0).integers(0, 255, shape, np.uint8)
    jt, tt = JTiler(), Tiler()
    j_tiles, j_orig, j_pad = jt.compute_tiles_array(img, size, overlap)
    t_tiles, t_orig, t_pad = tt.compute_tiles_array(img, size, overlap)
    np.testing.assert_array_equal(t_tiles, j_tiles)
    np.testing.assert_array_equal(t_orig, j_orig)
    assert t_pad == j_pad and tt.grid == jt.grid
    assert tt.compute_tiles_by_size(img, size, overlap)[1] == \
        jt.compute_tiles_by_size(img, size, overlap)[1]
    j_o, j_p, j_hw = jt.tile_origins(shape[:2], size, overlap)
    t_o, t_p, t_hw = tt.tile_origins(shape[:2], size, overlap)
    np.testing.assert_array_equal(t_o, j_o)
    assert (t_p, t_hw) == (j_p, j_hw)
    for grid in ((2, 2), (3, 2)):
        jg = jt.compute_tiles_by_grid(img, grid, 0)
        tg = tt.compute_tiles_by_grid(img, grid, 0)
        assert tg[1] == jg[1] and tg[2] == jg[2]


def test_tiler_default_tiles_of_24mp():
    """6000 x 4000 at the default (2400, 2000) tiles and overlap 10: six tiles
    of 2000 x 2400, 600 px of padding left and right."""
    origins, pad, hw = Tiler().tile_origins((4000, 6000), (2400, 2000), 10)
    assert len(origins) == 6 and hw == (2000, 2400) and pad == (0, 0, 600, 600)
    np.testing.assert_array_equal(origins[:3], [[-600, 0], [1790, 0], [4180, 0]])


@pytest.mark.parametrize("shape,size,overlap", [
    ((190, 260, 3), (128, 96), 16), ((190, 260), (128, 96), 16), ((300, 200), 64, 8)])
def test_cut_tiles_equals_jax(shape, size, overlap):
    img = np.random.default_rng(1).integers(0, 255, shape, np.uint8)
    origins, pad, hw = Tiler().tile_origins(img.shape[:2], size, overlap)
    starts = np.stack([origins[:, 1] + pad[0], origins[:, 0] + pad[2]], 1).astype(np.int32)
    ref = np.asarray(jmerge.cut_tiles(jnp.asarray(img), jnp.asarray(starts), tile_hw=hw,
                                      pad=tuple(pad)))
    got = tmerge.cut_tiles(torch.from_numpy(img), starts, hw, pad).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, JTiler().compute_tiles_array(img, size, overlap)[0])


def _merge_inputs(n_cand, seed=3):
    """Four tiles' padded features with duplicates planted across tiles (an
    overlap region), rounding ties at .5, and tied scores."""
    rng = np.random.default_rng(seed)
    T, K, D = 4, n_cand, 8
    origins = np.array([[-5, -5], [45, -5], [-5, 35], [45, 35]], np.float32)
    kpts = rng.uniform(0, 60, (T, K, 2)).astype(np.float32)
    kpts[1, :4] = kpts[0, :4] + (origins[0] - origins[1])       # exact duplicates
    kpts[2, :3] = np.round(kpts[2, :3]) + 0.5                     # halves: round to even
    scores = rng.uniform(0.1, 1.0, (T, K)).astype(np.float32)
    scores[3, :5] = scores[0, 0]                                   # tied scores
    scores[1, :4] = scores[0, :4]                                  # duplicates tie too
    desc = rng.normal(size=(T, K, D)).astype(np.float32)
    mask = rng.uniform(size=(T, K)) > 0.2
    return kpts, scores, desc, mask, origins


@pytest.mark.parametrize("n_cand,max_kpts", [(64, 32), (64, 100), (16, 64), (64, 300)])
def test_merge_tile_features_equals_jax(n_cand, max_kpts):
    """Below and above the cap: the same rows in the same (score-descending,
    lower flat index first) order, bitwise."""
    kpts, scores, desc, mask, origins = _merge_inputs(n_cand)
    ref = jmerge.merge_tile_features(
        jnp.asarray(kpts), jnp.asarray(scores), jnp.asarray(desc), jnp.asarray(mask),
        jnp.asarray(origins), jnp.asarray([100.0, 80.0], jnp.float32), max_kpts)
    got = tmerge.merge_tile_features(
        torch.from_numpy(kpts), torch.from_numpy(scores), torch.from_numpy(desc),
        torch.from_numpy(mask), torch.from_numpy(origins), (100.0, 80.0), max_kpts)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    m = got["mask"].numpy()
    assert not m[int(m.sum()):].any() and (got["tile_idx"].numpy()[~m] == -1).all()


def _grid(image_wh, size, overlap):
    j = jtiling.tile_grid_for(image_wh, size, overlap)
    t = ttiling.tile_grid_for(image_wh, size, overlap)
    np.testing.assert_array_equal(t[0], j[0])
    assert t[1] == j[1]
    return t


@pytest.mark.parametrize("mode", ["exhaustive", "grid", "preselection",
                                  "preselection_affine_transform"])
@pytest.mark.parametrize("probe", ["none", "shift", "scattered"])
def test_select_tile_pairs_equals_jax(mode, probe):
    """All four modes, without probe points, with the points of a shifted
    view (the affine fit succeeds) and with scattered ones (it fails or
    finds no overlap, and preselection falls back to counting)."""
    o0, twh0 = _grid((640, 480), (200, 150), 10)
    o1, twh1 = _grid((618, 640), (200, 150), 10)
    rng = np.random.default_rng(5)
    lp0 = lp1 = None
    if probe == "shift":
        lp0 = rng.uniform(0, 480, (200, 2)).astype(np.float32)
        lp1 = lp0 + np.array([90.0, 130.0], np.float32)
    elif probe == "scattered":
        lp0 = rng.uniform(0, 600, (60, 2)).astype(np.float32)
        lp1 = rng.uniform(0, 600, (60, 2)).astype(np.float32)
    kw = dict(lowres_pts0=lp0, lowres_pts1=lp1, origins0=o0, origins1=o1,
              tile_wh0=twh0, tile_wh1=twh1, min_matches=6)
    ref = jtiling.select_tile_pairs(getattr(JTileSelection, mode.upper()), len(o0), len(o1), **kw)
    got = ttiling.select_tile_pairs(getattr(TileSelection, mode.upper()), len(o0), len(o1), **kw)
    assert got == ref and len(got) > 0
    if lp0 is not None:
        np.testing.assert_array_equal(ttiling.points_in_tiles(lp1, o1, twh1),
                                      jtiling.points_in_tiles(lp1, o1, twh1))


@pytest.mark.parametrize("n_out", [0, 10, 30])
def test_estimate_affine_ransac_equals_jax(n_out):
    """The same matrix from the same seeded draws (exact), with outliers."""
    rng = np.random.default_rng(1)
    src = rng.uniform(0, 200, (40, 2)).astype(np.float32)
    A = np.array([[1.1, 0.05, 100.0], [-0.04, 0.95, -20.0]], np.float32)
    dst = src @ A[:, :2].T + A[:, 2]
    src = np.concatenate([src, rng.uniform(0, 200, (n_out, 2)).astype(np.float32)])
    dst = np.concatenate([dst, rng.uniform(0, 200, (n_out, 2)).astype(np.float32)])
    ref = jtiling.estimate_affine_ransac(src, dst)
    got = ttiling.estimate_affine_ransac(src, dst)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, A, atol=1e-2)
    assert ttiling.estimate_affine_ransac(src[:2], dst[:2]) is None


@pytest.fixture
def probe_images(tmp_path):
    """Two 240 x 320 views, the second shifted by whole SuperPoint cells."""
    rng = np.random.default_rng(0)
    tex = cv2.GaussianBlur(rng.integers(0, 256, (400, 500), dtype=np.uint8), (0, 0), 2)
    tex = cv2.normalize(tex, None, 0, 255, cv2.NORM_MINMAX)
    paths = []
    for i, (dy, dx) in enumerate([(40, 40), (56, 24)]):
        paths.append(tmp_path / f"img_{i}.png")
        cv2.imwrite(str(paths[-1]), tex[dy:dy + 240, dx:dx + 320])
    return paths


def _set(p0, p1):
    return {tuple(a) + tuple(b) for a, b in zip(p0.tolist(), p1.tolist())}


def test_lowres_probe_equals_jax(probe_images, monkeypatch):
    """The probe with shared SuperPoint weights: its LightGlue branch with an
    injected runner (shared weights, 2 layers, threshold 0, as
    ``tests/test_tiled_matching.py`` injects one), then the mutual-NN branch
    on the same cached features; both give the JAX probe's matches."""
    sp = jsp.init_params(jax.random.PRNGKey(0))
    lg = jlg.init_params(jax.random.PRNGKey(0), n_layers=2)
    model = tsp.SuperPoint()
    model.load_state_dict(superpoint_params_from_jax(sp))
    tlg_model = tlg.LightGlue(n_layers=2)
    tlg_model.load_state_dict(lightglue_params_from_jax(lg))
    monkeypatch.setattr(jsp, "_DEFAULT_PARAMS", sp)
    monkeypatch.setattr(jsp, "_DEFAULT_PARAMS_RANDOM", False)
    monkeypatch.setattr(tsp, "_DEFAULT_MODEL", model.eval())
    monkeypatch.setattr(tsp, "_DEFAULT_MODEL_RANDOM", False)
    jprobe = jtiling.LowResProbe(preselection_size=256, max_keypoints=256)
    tprobe = ttiling.LowResProbe(preselection_size=256, max_keypoints=256)
    jprobe._lg = jlg.LightGlueRunner(params=lg, filter_threshold=0.0, compute_dtype="float32")
    tprobe._lg = tlg.LightGlueRunner(model=tlg_model.eval(), filter_threshold=0.0)
    jprobe._lg_checked = tprobe._lg_checked = True
    ref = jprobe.matches(*probe_images)
    got = tprobe.matches(*probe_images)
    assert got[0].shape == got[1].shape and got[0].shape[1] == 2 and len(got[0]) > 0
    assert _set(*got) == _set(*ref)
    jprobe._lg = tprobe._lg = None
    ref = jprobe.matches(*probe_images)
    got = tprobe.matches(*probe_images)
    assert len(got[0]) > 0 and _set(*got) == _set(*ref)


def test_lowres_probe_finds_lightglue_weights(tmp_path, monkeypatch):
    """The probe takes LightGlue exactly when the weights lookup finds a
    pretrained SuperPoint-LightGlue checkpoint."""
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setattr(tlg, "_DEFAULT_MODELS", {})
    monkeypatch.setattr(tlg, "_DEFAULT_RANDOM", set())
    monkeypatch.setattr("pathlib.Path.home", lambda: tmp_path / "home")
    assert ttiling.LowResProbe()._get_lightglue() is None
    torch.save(tlg.LightGlue().state_dict(), tmp_path / "superpoint_lightglue.pth")
    monkeypatch.setattr(tlg, "_DEFAULT_MODELS", {})
    assert isinstance(ttiling.LowResProbe()._get_lightglue(), tlg.LightGlueRunner)


def _merge_reference(kpts, scores, desc, mask, origins, wh, max_kpts):
    """The merge's semantics in numpy: border filter, the lowest flat index
    of each rounded coordinate, then the valid rows by score (descending,
    lower flat index first), at most ``max_kpts``."""
    T, K, _ = kpts.shape
    k = (kpts + origins[:, None, :]).reshape(-1, 2)
    ok = mask.reshape(-1) & (k[:, 0] >= 0) & (k[:, 0] < wh[0]) & (k[:, 1] >= 0) & (k[:, 1] < wh[1])
    flat = np.nonzero(ok)[0]
    _, first = np.unique(np.round(k[flat]).astype(np.int64), axis=0, return_index=True)
    flat = flat[np.sort(first)]
    flat = flat[np.argsort(-scores.reshape(-1)[flat], kind="stable")][:max_kpts]
    return k[flat], scores.reshape(-1)[flat], desc.reshape(T * K, -1)[flat], flat // K


@pytest.mark.parametrize("T,K,max_kpts", [(9, 8192, 8192), (6, 16384, 4096)])
def test_merge_tile_features_large_candidate_sets(T, K, max_kpts):
    """More than 65536 candidates, fewer valid ones than the cap in the first
    case: exactly the valid rows, then padding. (The JAX package's chunked
    top-k pads with the lowest float there, and its merge counts those fill
    rows as valid: ROADMAP.md, §3b.)"""
    rng = np.random.default_rng(7)
    origins = np.stack(np.meshgrid(np.arange(3) * 90.0, np.arange(T // 3) * 70.0),
                       -1).reshape(-1, 2).astype(np.float32) - 5
    kpts = rng.uniform(0, 100, (T, K, 2)).astype(np.float32)
    scores = rng.uniform(0.1, 1.0, (T, K)).astype(np.float32)
    desc = rng.normal(size=(T, K, 4)).astype(np.float32)
    mask = rng.uniform(size=(T, K)) < 0.05
    wh = (270.0, 70.0 * (T // 3))
    got = {k: v.numpy() for k, v in tmerge.merge_tile_features(
        torch.from_numpy(kpts), torch.from_numpy(scores), torch.from_numpy(desc),
        torch.from_numpy(mask), torch.from_numpy(origins), wh, max_kpts).items()}
    rk, rs, rd, rt = _merge_reference(kpts, scores, desc, mask, origins, wh, max_kpts)
    n = len(rk)
    assert got["mask"].sum() == n and got["mask"][:n].all()
    np.testing.assert_array_equal(got["keypoints"][:n], rk)
    np.testing.assert_array_equal(got["scores"][:n], rs)
    np.testing.assert_array_equal(got["descriptors"][:n], rd)
    np.testing.assert_array_equal(got["tile_idx"][:n], rt)
    assert (got["tile_idx"][n:] == -1).all() and not got["keypoints"][n:].any()
