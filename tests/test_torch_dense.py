"""The detector-free host tail and RoMa as a whole, in the port against the
JAX package on the CPU: ``DetectorFreeMatcher`` (keypoint appends, raw and
verified writes, host verification) and ``dense_to_multiview`` on the same
coordinates, then ``run_matching --pipeline roma`` on three demo images.
The port's files are read back with h5py."""

import functools
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
from deep_image_matching_tpu.config import Config as JConfig
from deep_image_matching_tpu.extractors.no_extractor import NoExtractor as JNoExtractor
from deep_image_matching_tpu.matchers import roma as jrm
from deep_image_matching_tpu.matchers.matcher_base import DetectorFreeMatcher as JDetectorFree
from deep_image_matching_tpu.models import roma as jr
from deep_image_matching_tpu.utils.dense_to_multiview import dense_to_multiview as jax_multiview
from deep_image_matching_tpu.utils.image import ImageList as JImageList
from deep_image_matching_tpu_torch.__main__ import run_matching as torch_run_matching
from deep_image_matching_tpu_torch.config import Config as TConfig
from deep_image_matching_tpu_torch.convert import roma_params_from_jax
from deep_image_matching_tpu_torch.extractors.no_extractor import NoExtractor as TNoExtractor
from deep_image_matching_tpu_torch.matchers import roma as trm
from deep_image_matching_tpu_torch.matchers.matcher_base import DetectorFreeMatcher as TDetectorFree
from deep_image_matching_tpu_torch.models import roma as tr
from deep_image_matching_tpu_torch.utils.dense_to_multiview import dense_to_multiview as torch_multiview
from deep_image_matching_tpu_torch.utils.image import ImageList as TImageList

DEMO_IMAGES = Path(__file__).resolve().parents[1] / "notebooks" / "demo_project" / "images"
NAMES = ["sacre_coeur_A.jpg", "sacre_coeur_B.jpg", "sacre_coeur_squared.jpg"]


def _project(root):
    (root / "images").mkdir(parents=True)
    for n in NAMES:
        shutil.copy(DEMO_IMAGES / n, root / "images" / n)
    return root


def _read_h5(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = obj[()]
        f.visititems(visit)
    return out


def _db(path):
    db = sqlite3.connect(str(path))
    try:
        return {t: sorted(db.execute(f"SELECT * FROM {t}").fetchall())
                for t in ("cameras", "images", "keypoints", "matches", "two_view_geometries")}
    finally:
        db.close()


def _paired_share(ref, got, tol):
    """The share of the rows of ``ref`` that have a row of ``got`` within
    ``tol`` (max norm), each row of ``got`` used once."""
    dist = np.abs(ref[:, None, :] - got[None, :, :]).max(-1)
    nearest = dist.argmin(1)
    found = dist[np.arange(len(ref)), nearest] <= tol
    assert len(set(nearest[found].tolist())) == found.sum()
    return found.mean()


def _pair_rows(files, key):
    """Each pair of the match file ``key`` as rows (x0, y0, x1, y1) of its
    matched keypoints."""
    feats = files["multiview/features_multiview.h5" if key.startswith("multiview")
                 else "features.h5"]
    out = {}
    for pair, m in files[key].items():
        a, b = pair.split("/")
        out[pair] = np.c_[feats[f"{a}/keypoints"][m[:, 0]], feats[f"{b}/keypoints"][m[:, 1]]]
    return out


def _pair_coords(seed, shapes):
    """Dense-matcher-like coordinates of one pair: 400 points related by an
    affine map with 0.3 px noise, 120 outliers, and 20 repeats of earlier
    points (the multiview merge rounds and deduplicates them)."""
    rng = np.random.default_rng(seed)
    (ha, wa), (hb, wb) = shapes
    k0 = rng.uniform([0, 0], [wa, ha], (400, 2))
    A = np.array([[0.9, 0.05], [-0.04, 0.95]])
    k1 = np.clip(k0 @ A.T + [12.0, -7.0] + rng.normal(0, 0.3, k0.shape), 0, [wb - 1, hb - 1])
    k1[280:] = rng.uniform([0, 0], [wb, hb], (120, 2))
    k0 = np.concatenate([k0, k0[:20]])
    k1 = np.concatenate([k1, k1[:20]])
    return k0.astype(np.float32), k1.astype(np.float32)


class _JaxStub(JDetectorFree):
    coords = {}

    def _match_images_batch(self, paths):
        return [self.coords[(a.name, b.name)] for a, b in paths]


class _TorchStub(TDetectorFree):
    coords = {}

    def _dispatch_images_batch(self, paths):
        return [self.coords[(a.name, b.name)] for a, b in paths]

    def _finish_images_batch(self, jobs):
        return jobs


def test_detector_free_tail_and_multiview_match_jax(tmp_path):
    proj = _project(tmp_path / "proj")
    pairs = [(NAMES[0], NAMES[1]), (NAMES[0], NAMES[2]), (NAMES[1], NAMES[2])]
    shapes = {n: cv2.imread(str(proj / "images" / n)).shape[:2] for n in NAMES}
    coords = {p: _pair_coords(i, (shapes[p[0]], shapes[p[1]])) for i, p in enumerate(pairs)}
    _JaxStub.coords = _TorchStub.coords = coords
    out = {}
    for tag, cfg_cls, images, ext_cls, stub, multiview in (
            ("jax", JConfig, JImageList, JNoExtractor, _JaxStub, jax_multiview),
            ("torch", TConfig, TImageList, TNoExtractor, _TorchStub, torch_multiview)):
        cfg = cfg_cls(args={"dir": str(proj), "outs": str(tmp_path / tag), "pipeline": "roma",
                            "strategy": "bruteforce", "skip_reconstruction": True,
                            "force": True})
        general = {**cfg.general, "tpu": {**cfg.general["tpu"], "device": "cpu"}}
        conf = {"general": general, "extractor": cfg.extractor, "matcher": cfg.matcher}
        feats, matches = cfg.output_dir / "features.h5", cfg.output_dir / "matches.h5"
        ext_cls(conf).extract_batch(list(images(proj / "images")), feats)
        results = stub(conf).match_all(pairs, feats, matches)
        mv_feats, mv_matches = multiview(feats, matches, cfg.output_dir / "database.db",
                                         proj / "images")
        out[tag] = (results, _read_h5(feats), _read_h5(cfg.output_dir / "raw_matches.h5"),
                    _read_h5(matches), _read_h5(mv_feats), _read_h5(mv_matches),
                    _db(cfg.output_dir / "database.db"))
    jres, *jfiles = out["jax"]
    tres, *tfiles = out["torch"]
    assert jres == tres and sum(v > 0 for v in jres.values()) == 3  # every pair verifies
    for jf, tf in zip(jfiles, tfiles):
        if isinstance(jf, dict) and "cameras" in jf:  # database tables
            assert jf == tf
            assert len(tf["two_view_geometries"]) == 3 and len(tf["keypoints"]) == 3
            continue
        assert jf.keys() == tf.keys()
        for k in jf:
            np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
            assert tf[k].dtype == jf[k].dtype, k
    feats = tfiles[0]
    # each image's keypoints are its pairs' coordinates, in pair order
    np.testing.assert_array_equal(feats[f"{NAMES[2]}/keypoints"],
                                  np.concatenate([coords[pairs[1]][1], coords[pairs[2]][1]]))


class _FlakyStub(_TorchStub):
    """Runs out of device memory above ``fits`` pairs per chunk, or fails
    with another error when the pair ``fail_on`` is finished."""

    fits = 3
    fail_on = None

    def _dispatch_images_batch(self, paths):
        self.batch_sizes.append(len(paths))
        if len(paths) > self.fits:
            raise torch.cuda.OutOfMemoryError("simulated")
        return [(a.name, b.name) for a, b in paths]

    def _finish_images_batch(self, jobs):
        if self.fail_on in jobs:
            raise RuntimeError("device fault")
        return [self.coords[p] for p in jobs]


def test_detector_free_bisects_oom_and_keeps_finished_pairs(tmp_path):
    """Out-of-memory chunks are halved until they fit; another error
    propagates, after the finished pairs' keypoints and raw matches were
    written together; a second stage (``--resume``) appends after them."""
    proj = _project(tmp_path / "proj")
    pairs = [(NAMES[0], NAMES[1]), (NAMES[0], NAMES[2]), (NAMES[1], NAMES[2])]
    shapes = {n: cv2.imread(str(proj / "images" / n)).shape[:2] for n in NAMES}
    _TorchStub.coords = {p: _pair_coords(i, (shapes[p[0]], shapes[p[1]]))
                         for i, p in enumerate(pairs)}
    cfg = TConfig(args={"dir": str(proj), "outs": str(tmp_path / "out"), "pipeline": "roma",
                        "strategy": "bruteforce", "skip_reconstruction": True, "force": True})
    general = {**cfg.general, "tpu": {**cfg.general["tpu"], "device": "cpu"}}
    conf = {"general": general, "extractor": cfg.extractor,
            "matcher": {**cfg.matcher, "pair_batch_size": 3}}
    feats, matches = cfg.output_dir / "features.h5", cfg.output_dir / "matches.h5"
    TNoExtractor(conf).extract_batch(list(TImageList(proj / "images")), feats)
    m = _FlakyStub(conf)
    m.batch_sizes, m.fits = [], 1
    assert set(m.match_all(pairs, feats, matches)) == set(pairs)
    assert m.batch_sizes == [3, 1, 2, 1, 1]  # 3 (OOM) -> 1 + 2 (OOM) -> 1 + 1

    for path in (feats, matches, cfg.output_dir / "raw_matches.h5"):
        path.unlink()
    TNoExtractor(conf).extract_batch(list(TImageList(proj / "images")), feats)
    m.batch_sizes, m.fits, m.fail_on = [], 3, pairs[2]
    m.conf["pair_batch_size"] = 1
    with pytest.raises(RuntimeError, match="device fault"):
        m.match_all(pairs, feats, matches)
    kp = _read_h5(feats)
    raw = _read_h5(cfg.output_dir / "raw_matches.h5")
    assert sorted(raw) == [f"{a}/{b}" for a, b in pairs[:2]]
    assert len(kp[f"{NAMES[0]}/keypoints"]) == 2 * 420 and len(kp[f"{NAMES[2]}/keypoints"]) == 420
    # the resumed stage appends the last pair after what the first wrote
    m.fail_on = None
    m.match_all(pairs[2:], feats, matches)
    kp = _read_h5(feats)
    raw = _read_h5(cfg.output_dir / "raw_matches.h5")
    assert sorted(raw) == [f"{a}/{b}" for a, b in pairs]
    np.testing.assert_array_equal(raw[f"{NAMES[1]}/{NAMES[2]}"][:, 1], np.arange(420, 840))
    np.testing.assert_array_equal(kp[f"{NAMES[2]}/keypoints"][420:], _TorchStub.coords[pairs[2]][1])


@pytest.fixture(scope="module")
def roma_weights():
    """The JAX package's random RoMa weights (DINOv2 at depth 1), and the
    same carried into the port."""
    jp = jr.init_params(jax.random.PRNGKey(0), dinov2_depth=1)
    return jp, roma_params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture
def shared_roma(monkeypatch, roma_weights):
    """``roma_weights`` in both packages' weight caches; the DINOv2 encoder
    runs in f32 on both sides (the matchers' default is bf16, whose
    roundings differ between XLA and the port); the port's sampler gets the
    JAX package's draws."""
    jp, tp = roma_weights
    monkeypatch.setattr(jrm, "_PARAMS", jp)
    monkeypatch.setattr(trm, "_PARAMS", tp)
    monkeypatch.setattr(trm, "_PARAMS_RANDOM", False)
    monkeypatch.setattr(jr, "match_pair", functools.partial(jr.match_pair_impl,
                                                            compute_dtype="float32"))
    monkeypatch.setattr(trm.RomaMatcher, "encoder_dtype", torch.float32)
    sample = tr.sample_matches_device

    def with_jax_draws(warp_ab, cert_ab, warp_ba, cert_ba, generator=None, num=5000,
                       sample_thresh=0.05):
        # the JAX matcher keys pair i with PRNGKey(i), the port seeds its
        # generator with i: draw what JAX draws from that key
        n = 2 * warp_ab.shape[0] * warp_ab.shape[1]
        n_cand = min(4 * num, n)
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(generator.initial_seed()), 3)
        draws = tuple(torch.from_numpy(np.array(d)) for d in (
            jax.random.gumbel(k1, (n,)),
            jax.random.choice(k2, n_cand, (min(n_cand, 4000),), replace=False),
            jax.random.gumbel(k3, (n_cand,))))
        return sample(warp_ab, cert_ab, warp_ba, cert_ba, num=num, sample_thresh=sample_thresh,
                      draws=draws)

    monkeypatch.setattr(tr, "sample_matches_device", with_jax_draws)


def test_run_matching_roma_agrees_with_jax(tmp_path, shared_roma):
    proj = _project(tmp_path / "proj")
    cfg = tmp_path / "config.yaml"
    cfg.write_text("general:\n  tpu:\n    device: cpu\n"
                   "matcher:\n  coarse_res: 112\n  upsample_res: 160\n"
                   "  num_sampled_points: 1000\n")
    outs = {}
    for tag, run in (("jax", jax_run_matching), ("torch", torch_run_matching)):
        feature_path, _, _ = run({
            "dir": str(proj), "outs": str(tmp_path / tag), "pipeline": "roma",
            "strategy": "bruteforce", "skip_reconstruction": True, "graph": False,
            "force": True, "config_file": str(cfg),
        })
        out_dir = feature_path.parent
        files = {name: _read_h5(out_dir / name) for name in ("features.h5", "raw_matches.h5")
                 if (out_dir / name).exists()}
        for name in ("matches.h5", "multiview/features_multiview.h5",
                     "multiview/matches_multiview.h5"):
            files[name] = _read_h5(out_dir / name) if (out_dir / name).exists() else None
        outs[tag] = (files, _db(out_dir / "database.db"))
    (jfiles, jdb), (tfiles, tdb) = outs["jax"], outs["torch"]
    jf, tf = jfiles["features.h5"], tfiles["features.h5"]
    assert jf.keys() == tf.keys() and jfiles["raw_matches.h5"].keys() == tfiles["raw_matches.h5"].keys()
    for name in NAMES:
        np.testing.assert_array_equal(tf[f"{name}/image_size"], jf[f"{name}/image_size"])
        assert tf[f"{name}/keypoints"].shape == jf[f"{name}/keypoints"].shape == (2000, 2)
    # each pair's 1000 samples: the same samples, each within 0.25 px (the
    # warps agree to 1e-3 of their magnitude, see test_torch_roma.py, which
    # puts 99 % of the samples within 0.05 px of the JAX package's on these
    # images; another sample would sit a pixel of the 160-px grid, 4 px
    # here, away). Inputs that agree to ~1e-6 still decide a few samples
    # differently: a KDE density at its cut-off of 10, a certainty at the
    # threshold, a warp at the image border; and two samples whose KDE
    # scores are within ~1e-5 may swap places. So samples are paired by
    # coordinates, one to one, and 99 % of each pair's must find theirs.
    for key in ("raw_matches.h5", "matches.h5", "multiview/matches_multiview.h5"):
        assert (jfiles[key] is None) == (tfiles[key] is None), key
        if jfiles[key] is None:
            continue
        jrows, trows = _pair_rows(jfiles, key), _pair_rows(tfiles, key)
        assert jrows.keys() == trows.keys()
        for pair, jx in jrows.items():
            assert abs(len(trows[pair]) - len(jx)) <= 0.01 * len(jx), (key, pair)
            assert _paired_share(jx, trows[pair], 0.25) >= 0.99, (key, pair)
    # the same rows: ids, names, counts (the blobs hold the coordinates
    # compared above)
    for t in ("cameras", "images", "keypoints", "matches", "two_view_geometries"):
        assert [r[:3] for r in tdb[t]] == [r[:3] for r in jdb[t]], t


def test_roma_matcher_batches_like_single_pairs(tmp_path, shared_roma):
    """``pair_batch_size`` 3 split by ``tpu.roma_batch_size`` 2 into
    programs of 2 and 1 pairs, with an image cache too small to keep any
    image, gives each pair the samples it gets alone."""
    proj = _project(tmp_path / "proj")
    outs = {}
    for tag, extra in (("single", ""), ("batched", "  pair_batch_size: 3\n  image_cache_mb: 0\n")):
        cfg = tmp_path / f"{tag}.yaml"
        cfg.write_text("general:\n  tpu:\n    device: cpu\n    roma_batch_size: 2\n"
                       "matcher:\n  coarse_res: 112\n  upsample_res: 160\n"
                       "  num_sampled_points: 300\n" + extra)
        feature_path, _, _ = torch_run_matching({
            "dir": str(proj), "outs": str(tmp_path / tag), "pipeline": "roma",
            "strategy": "bruteforce", "skip_reconstruction": True, "graph": False,
            "force": True, "config_file": str(cfg)})
        files = {n: _read_h5(feature_path.parent / n) for n in ("features.h5", "raw_matches.h5")}
        outs[tag] = _pair_rows(files, "raw_matches.h5")
    assert outs["single"].keys() == outs["batched"].keys() and len(outs["single"]) == 3
    for pair, rows in outs["single"].items():
        # convolutions over another batch size sum in another order, which
        # the coarse-to-fine loop carries on: the bound and pairing of
        # test_run_matching_roma_agrees_with_jax
        assert outs["batched"][pair].shape == rows.shape == (300, 4)
        assert _paired_share(rows, outs["batched"][pair], 0.25) >= 0.99, pair
