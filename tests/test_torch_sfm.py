"""Stage 5 of the port, reconstruction, against the JAX package on the CPU:
the union-find, bundle adjustment (residuals, Jacobian blocks, one LM step,
whole solves, the early exit), the incremental mapper (with the JAX
package's BA injected, bitwise; with its own BA, within stated bounds), the
known-poses triangulation, ``build_tracks``, and ``run_matching`` through
reconstruction on the demo images. Inputs are made from numpy seeds; the
synthetic scenes are ``tests/test_sfm.py``'s.

The LM solve runs 30 conjugate-gradient steps a step by default, and CG on
these normal equations amplifies rounding differences by about 1e6 every
ten iterations (float32 and float64 alike): two correct implementations that
sum in another order agree to 1e-7 after 5 CG steps and differ by percents
of the step's cost after 30, as the JAX package's padded and unpadded forms
of one problem do. So single steps are compared at 5 CG steps in float32 and
20 in float64, solves' cost traces in float64 at 20, and the float32 default
solve by its final error.
"""

import logging
import shutil
import sqlite3
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components as scipy_components

from deep_image_matching_tpu.__main__ import run_matching as jax_run_matching
from deep_image_matching_tpu.io import tracks as jtracks
from deep_image_matching_tpu.sfm import ba as jba
from deep_image_matching_tpu.sfm import geometry as G
from deep_image_matching_tpu.sfm import incremental as jinc
from deep_image_matching_tpu_torch import native as tnative
from deep_image_matching_tpu_torch import triangulation as ttri
from deep_image_matching_tpu_torch.__main__ import run_matching as torch_run_matching
from deep_image_matching_tpu_torch.io import tracks as ttracks
from deep_image_matching_tpu_torch.io.colmap_db import COLMAPDatabase
from deep_image_matching_tpu_torch.io.colmap_read_write_model import (
    Camera,
    Image,
    qvec2rotmat,
    read_model,
    rotmat2qvec,
    write_model,
)
from deep_image_matching_tpu_torch.io.h5 import save_features, save_matches
from deep_image_matching_tpu_torch.sfm import ba as tba
from deep_image_matching_tpu_torch.sfm import incremental as tinc
from test_sfm import _make_scene, _observations

CPU = torch.device("cpu")
DEMO_IMAGES = Path(__file__).resolve().parents[1] / "notebooks" / "demo_project" / "images"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread for this file: a solve is thousands of small ops,
    and in a test worker that shares the cores with others each parallel
    op waits for its descheduled threads (the demo mapper's 6 s became
    150-250 s beside six busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rms(poses, intr, points, obs_pose, obs_pt, obs_uv):
    errs = []
    for i in range(len(poses)):
        R = G.rotvec_to_matrix(poses[i, :3])
        sel = obs_pose == i
        uv, _ = G.project_points(intr, R, poses[i, 3:], points[obs_pt[sel]])
        errs.append(np.linalg.norm(uv - obs_uv[sel], axis=1))
    return float(np.sqrt((np.concatenate(errs) ** 2).mean()))


# -- native union-find -------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_connected_components_match_scipy(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(50, 400))
    edges = rng.integers(0, n, (int(rng.integers(0, 2 * n)), 2))
    roots = tnative.connected_components(n, edges)
    _, labels = scipy_components(
        coo_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])), shape=(n, n)),
        directed=False)
    # the same partition: a bijection between root ids and scipy's labels
    pairs = set(zip(roots.tolist(), labels.tolist()))
    assert len(pairs) == len(set(roots.tolist())) == len(set(labels.tolist()))
    assert all(roots[r] == r for r in set(roots.tolist()))


# -- fixed-order segment sums --------------------------------------------------


def _segment_cases():
    rng = np.random.default_rng(0)
    return {
        "balanced": (rng.integers(0, 64, 20000), 64, 1),
        "one_long_segment": (np.r_[np.zeros(3000, np.int64), rng.integers(1, 400, 600)], 400, 2),
        "empty_segments": (rng.choice([1, 3, 4], 500), 6, 1),
        "mostly_empty": (rng.choice([3, 7, 9], 500), 12, 2),
        "one_segment": (np.zeros(9, np.int64), 1, 1),
    }


@pytest.mark.parametrize("case", list(_segment_cases()))
def test_segment_sum_matches_scatter_add(case):
    """``plan_segments`` + ``_segment_sum`` against ``np.add.at`` on
    integer-valued rows (exact in any order), every row gathered once;
    one level where that pads little, two where a few segments are far
    longer than the mean."""
    idx, n, n_levels = _segment_cases()[case]
    levels = tba.plan_segments(idx, n, CPU)
    assert len(levels) == n_levels
    first = levels[0].numpy().ravel()
    assert np.array_equal(np.sort(first[first < len(idx)]), np.arange(len(idx)))
    x = np.random.default_rng(1).integers(-50, 50, (len(idx), 3)).astype(np.float64)
    ref = np.zeros((n, 3))
    np.add.at(ref, idx, x)
    got = tba._segment_sum(torch.from_numpy(x), levels).numpy()
    assert got.shape == (n, 3) and np.array_equal(got, ref)


# -- bundle adjustment -------------------------------------------------------


def test_residuals_and_jacobian_blocks_match_jax():
    rng = np.random.default_rng(0)
    O = 300
    poses = np.concatenate([rng.normal(0, 0.3, (O, 3)), rng.normal(0, 0.5, (O, 3))], 1)
    intr = np.stack([np.log(rng.uniform(800, 1000, O)), np.log(rng.uniform(800, 1000, O)),
                     rng.uniform(300, 340, O), rng.uniform(220, 260, O),
                     rng.normal(0, 0.1, O), rng.normal(0, 0.02, O),
                     rng.normal(0, 2e-3, O), rng.normal(0, 2e-3, O)], 1)
    pts = rng.uniform([-2, -2, 6], [2, 2, 12], (O, 3))
    uv = rng.uniform([0, 0], [640, 480], (O, 2))
    args = [a.astype(np.float32) for a in (poses, intr, pts, uv)]
    res_j = np.asarray(jba._obs_res_batch(*map(jnp.asarray, args)))
    res_t = tba._obs_res_batch(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(res_t, res_j, rtol=1e-5, atol=1e-5 * np.abs(res_j).max())
    jac_j = jba._obs_jac_batch(*map(jnp.asarray, args))
    jac_t = tba._obs_jac_batch(*map(torch.from_numpy, args))
    for name, a, b in zip(("pose", "intr", "point"), jac_j, jac_t):
        a = np.asarray(a)
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape, name
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-5 * np.abs(a).max(),
                                   err_msg=name)


def _step_problem(dtype):
    """test_sfm's perturbed 6-camera problem, normalized as bundle_adjust
    normalizes it: the port's BAProblem and the JAX package's, with obs_w = 1
    and no padding rows."""
    rng = np.random.default_rng(5)
    intr, X, poses = _make_scene(rng)
    obs = _observations(intr, X, poses, rng)
    poses0 = poses + rng.normal(0, 0.02, poses.shape)
    poses0[0] = poses[0]
    X0 = X + rng.normal(0, 0.05, X.shape)
    intr8 = np.array([[950.0, 950.0, 320.0, 240.0, 0, 0, 0, 0]])
    pose_free = np.ones((len(poses), 6))
    pose_free[0] = 0
    pose_free[1, 3] = 0
    intr_free = np.array([[1.0, 1, 0, 0, 1, 0, 0, 0]])
    pn, xn, _, _ = tba.normalize_scene(poses0, X0)
    prob_t = tba.make_problem(pn, intr8, xn, *obs, pose_free, intr_free, None, CPU, dtype)
    f = lambda a: jnp.asarray(np.asarray(a, dtype))  # noqa: E731
    prob_j = jba.BAProblem(
        poses=f(pn), intr=f(intr8), points=f(xn),
        obs_pose=jnp.asarray(obs[0], jnp.int32), obs_cam=jnp.asarray(obs[1], jnp.int32),
        obs_pt=jnp.asarray(obs[2], jnp.int32), obs_uv=f(obs[3]),
        obs_w=jnp.ones(len(obs[0]), dtype), pose_free=f(pose_free), intr_free=f(intr_free),
        point_free=jnp.ones((len(xn), 3), dtype))
    log_intr = intr8.copy()
    log_intr[:, :2] = np.log(log_intr[:, :2])
    return prob_t, prob_j, log_intr.astype(dtype)


@pytest.mark.parametrize("dtype,n_cg", [(np.float32, 5), (np.float64, 20)],
                         ids=["float32-cg5", "float64-cg20"])
def test_lm_step_matches_jax(dtype, n_cg):
    with jax.enable_x64(dtype == np.float64):
        prob_t, prob_j, log_intr = _step_problem(dtype)
        lam0 = np.asarray(1e-4, dtype)
        out = {}
        for cg in (0, n_cg):  # 0 CG steps: a zero update, rejected -> the cost before
            tj, lj, cj = jba._lm_step((prob_j.poses, jnp.asarray(log_intr), prob_j.points),
                                      jnp.asarray(lam0), prob_j, jnp.asarray(4.0, dtype), cg)
            tt, lt, ct, acc = tba.lm_step(
                (prob_t.poses, torch.from_numpy(log_intr), prob_t.points),
                torch.from_numpy(lam0), prob_t, 4.0, cg)
            out[cg] = (tj, float(lj), float(cj), tt, float(lt), float(ct), bool(acc))
    (_, lj0, cj0, _, lt0, ct0, acc0), (tj, lj, cj, tt, lt, ct, acc) = out[0], out[n_cg]
    assert not acc0 and np.isclose(lt0, lj0, rtol=1e-5)
    np.testing.assert_allclose(ct0, cj0, rtol=1e-5)  # the cost before the step
    np.testing.assert_allclose(ct, cj, rtol=1e-5)    # after
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    assert acc and ct < ct0
    for a, b in zip(tj, tt):
        a = np.asarray(a)
        assert np.abs(b.numpy() - a).max() <= 1e-4 * np.abs(a).max()


def _perturbed_scene():
    """test_sfm.py::test_bundle_adjust_converges_to_noise_floor's problem."""
    rng = np.random.default_rng(5)
    intr, X, poses = _make_scene(rng)
    obs = _observations(intr, X, poses, rng)
    poses0 = poses + rng.normal(0, 0.02, poses.shape)
    poses0[0] = poses[0]
    X0 = X + rng.normal(0, 0.05, X.shape)
    intr0 = np.array([[950.0, 320.0, 240.0, 0.0]])
    pose_free = np.ones((len(poses), 6))
    pose_free[0] = 0
    pose_free[1, 3] = 0
    intr_free = np.array([[1.0, 0, 0, 1.0]])
    return poses, (poses0, intr0, X0, *obs, pose_free, intr_free), obs


def test_bundle_adjust_float64_cost_trace_matches_jax():
    _, args, _ = _perturbed_scene()
    kw = dict(n_lm_iters=30, n_cg_iters=20, dtype=np.float64)
    with jax.enable_x64(True):
        ref = jba.bundle_adjust(*args, **kw)
    got = tba.bundle_adjust(*args, **kw, device="cpu")
    n = min(len(ref["costs"]), len(got["costs"]))
    assert n >= 10
    np.testing.assert_allclose(got["costs"][:n], ref["costs"][:n], rtol=1e-3)


def test_bundle_adjust_converges_to_noise_floor():
    """test_sfm.py's bar at the float32 default (30 LM, 30 CG steps), beside
    the JAX package's own solve."""
    poses, args, (obs_pose, _, obs_pt, obs_uv) = _perturbed_scene()
    kw = dict(n_lm_iters=30, n_cg_iters=30)
    got = tba.bundle_adjust(*args, **kw, device="cpu")
    ref = jba.bundle_adjust(*args, **kw)
    poses0, intr0, X0 = args[:3]
    assert _rms(poses0, intr0[0], X0, obs_pose, obs_pt, obs_uv) > 5.0
    final = _rms(got["poses"], got["intr"][0], got["points"], obs_pose, obs_pt, obs_uv)
    final_ref = _rms(ref["poses"], ref["intr"][0], ref["points"], obs_pose, obs_pt, obs_uv)
    assert final < 0.8 and abs(final - final_ref) < 0.01 * final_ref, (final, final_ref)
    assert np.allclose(got["poses"][0], poses[0], atol=1e-6)  # gauge pose untouched
    assert np.all(np.diff(got["costs"]) <= 0)


def test_bundle_adjust_early_exit_on_converged_problem():
    """test_sfm.py's early-exit case: noise-free ground truth stops well
    before the step budget and stays at the optimum."""
    rng = np.random.default_rng(11)
    intr, X, poses = _make_scene(rng, k1=0.0)
    obs = _observations(intr, X, poses, rng, noise=0.0)
    pose_free = np.ones((len(poses), 6))
    pose_free[0] = 0
    pose_free[1, 3] = 0
    out = tba.bundle_adjust(poses, np.atleast_2d(intr), X, *obs, pose_free, np.zeros((1, 4)),
                            n_lm_iters=30, n_cg_iters=30, device="cpu")
    assert len(out["costs"]) < 30
    assert np.allclose(out["poses"], poses, atol=1e-4)


def test_stall_rule():
    """Rejections before the first accepted step leave the count alone;
    after one, three stalls in a row stop the solve."""

    def run(steps):
        stall, prev, any_acc, n = 0, None, False, 0
        for cost, acc in steps:
            any_acc |= acc
            n += 1
            stall = tba.stall_count(stall, prev, cost, acc, any_acc)
            if stall >= tba.STALL_STEPS:
                break
            prev = cost
        return n, stall

    # the JAX package stops after the fourth of these (ba.py:238-240: the
    # second, third and fourth count as stalls)
    early = [(100.0, False)] * 4 + [(50.0, True), (40.0, True)]
    assert run(early) == (6, 0)
    assert run([(100.0, False)] * 10) == (10, 0)
    assert run([(50.0, True)] + [(50.0, False)] * 3 + [(10.0, True)]) == (4, 3)
    assert run([(50.0, True), (50.0, True), (49.99999, True), (49.99998, True)]) == (4, 3)
    assert run([(50.0, True), (50.0, False), (40.0, True), (40.0, False)]) == (4, 1)


def test_bundle_adjust_refines_after_early_rejections(monkeypatch):
    """A solve whose first four steps are rejected goes on to refine the
    scene (the JAX package would return it unrefined)."""
    real_step = tba.lm_step
    calls = []

    def step(theta, lam, prob, delta, n_cg):
        calls.append(float(lam))
        # no CG step: a zero update, rejected, and lam rises five times
        return real_step(theta, lam, prob, delta, 0 if len(calls) <= 4 else n_cg)

    monkeypatch.setattr(tba, "lm_step", step)
    poses, args, (obs_pose, _, obs_pt, obs_uv) = _perturbed_scene()
    got = tba.bundle_adjust(*args, n_lm_iters=30, n_cg_iters=30, device="cpu")
    assert len(calls) > 4
    np.testing.assert_allclose(calls[:5], [1e-4, 5e-4, 2.5e-3, 1.25e-2, 6.25e-2], rtol=1e-5)
    assert _rms(got["poses"], got["intr"][0], got["points"], obs_pose, obs_pt, obs_uv) < 0.8


# -- the mapper --------------------------------------------------------------


def _mapper_scene(path, kind):
    """test_sfm.py's 6-image SIMPLE_RADIAL scene
    (``test_incremental_mapper_end_to_end``) or its OPENCV one
    (``test_incremental_mapper_opencv_scene``), written as a COLMAP database
    at ``path``; returns (database, camera id, ground-truth poses)."""
    if kind == "simple_radial":
        rng = np.random.default_rng(6)
        intr, X, poses = _make_scene(rng, n_cams=6, n_pts=900, k1=0.0)
        model, noise, window, keep = 2, 0.4, 4, 0.8
    else:
        rng = np.random.default_rng(13)
        intr = np.array([900.0, 920.0, 320.0, 240.0, -0.10, 0.015, 0.001, -0.001])
        X = rng.uniform([-4, -4, 8], [4, 4, 16], (900, 3))
        poses = [np.zeros(6)]
        for i in range(1, 6):
            poses.append(np.concatenate([rng.normal(0, 0.08, 3), [0.9 * i, 0.15 * i, 0.1 * i]]))
        poses = np.stack(poses)
        model, noise, window, keep = 4, 0.3, 4, 0.85
    kpts, vis_ids = [], []
    for p in poses:
        R = G.rotvec_to_matrix(p[:3])
        uv, z = G.project_points(intr, R, p[3:], X)
        vis = (z > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < 640) & (uv[:, 1] >= 0) & (uv[:, 1] < 480)
        ids = np.where(vis)[0]
        ids = ids[rng.permutation(len(ids))]
        kpts.append(uv[ids] + rng.normal(0, noise, (len(ids), 2)))
        vis_ids.append(ids)
    path.mkdir(parents=True, exist_ok=True)
    db = COLMAPDatabase.connect(path / "database.db")
    db.create_tables()
    cam_id = db.add_camera(model, 640, 480, intr)
    img_ids = []
    for i in range(len(poses)):
        iid = db.add_image(f"img{i}.jpg", cam_id)
        db.add_keypoints(iid, kpts[i].astype(np.float32))
        img_ids.append(iid)
    for i in range(len(poses)):
        for j in range(i + 1, min(i + window, len(poses))):
            _, ia, ib = np.intersect1d(vis_ids[i], vis_ids[j], return_indices=True)
            m = np.stack([ia, ib], axis=1).astype(np.uint32)
            m = m[rng.random(len(m)) < keep]
            db.add_matches(img_ids[i], img_ids[j], m)
            db.add_two_view_geometry(img_ids[i], img_ids[j], m)
    db.commit()
    db.close()
    return path / "database.db", cam_id, poses


@pytest.fixture(scope="module")
def jax_mapped(tmp_path_factory):
    """Each scene and the JAX package's mapper run on it, shared by the tests
    that need them."""
    out = {}
    for kind in ("simple_radial", "opencv"):
        root = tmp_path_factory.mktemp(kind)
        db, cam_id, poses = _mapper_scene(root, kind)
        res = jinc.native_incremental_mapping(db, root, root / "jax")
        assert res is not None
        out[kind] = (root, db, cam_id, poses, res)
    return out


def _jax_ba(*args, device=None, **kw):
    return jba.bundle_adjust(*args, **kw)


def test_mapper_with_jax_ba_is_bitwise_jax(jax_mapped, monkeypatch):
    """The copied host logic holds exactly: with the JAX package's BA
    injected, the port's mapper gives the JAX mapper's model bit for bit."""
    root, db, _, _, (jcams, jimgs, jpts) = jax_mapped["simple_radial"]
    monkeypatch.setattr(tinc, "bundle_adjust", _jax_ba)
    cams, imgs, pts = tinc.native_incremental_mapping(db, root, root / "port_jax_ba", device="cpu")
    assert list(imgs) == list(jimgs)  # registration order
    for i in jimgs:
        assert imgs[i].name == jimgs[i].name
        np.testing.assert_array_equal(imgs[i].qvec, jimgs[i].qvec)
        np.testing.assert_array_equal(imgs[i].tvec, jimgs[i].tvec)
        np.testing.assert_array_equal(imgs[i].point3D_ids, jimgs[i].point3D_ids)
    for c in jcams:
        np.testing.assert_array_equal(cams[c].params, jcams[c].params)
    assert list(pts) == list(jpts)  # track ids
    for p in jpts:
        np.testing.assert_array_equal(pts[p].xyz, jpts[p].xyz)


def _relative_rotations(imgs):
    R = {im.name: qvec2rotmat(im.qvec) for im in imgs.values()}
    names = sorted(R)
    return {(a, b): R[b] @ R[a].T for i, a in enumerate(names) for b in names[i + 1:]}


@pytest.mark.parametrize("kind", ["simple_radial", "opencv"])
def test_mapper_with_its_own_ba_matches_jax(jax_mapped, kind):
    root, db, cam_id, poses, (jcams, jimgs, jpts) = jax_mapped[kind]
    cams, imgs, pts = tinc.native_incremental_mapping(db, root, root / "port", device="cpu")
    assert sorted(i.name for i in imgs.values()) == sorted(i.name for i in jimgs.values())
    assert len(imgs) == len(poses)
    f, fj = cams[cam_id].params[0], jcams[cam_id].params[0]
    assert abs(f - fj) / fj < 0.005, (f, fj)
    rel, rel_j = _relative_rotations(imgs), _relative_rotations(jimgs)
    for pair, Rr in rel.items():
        err = np.degrees(np.linalg.norm(G.matrix_to_rotvec(Rr @ rel_j[pair].T)))
        assert err < 0.1, (pair, err)
    assert abs(len(pts) - len(jpts)) <= 0.02 * len(jpts), (len(pts), len(jpts))
    assert cams[cam_id].model == jcams[cam_id].model
    rec = root / "port" / "reconstruction"
    _, imgs2, pts2 = read_model(rec, ".txt")
    assert len(imgs2) == len(imgs) and len(pts2) == len(pts)
    assert (rec / "model.ply").stat().st_size > 1000


def test_forced_global_schedule_runs_full_lm_steps(jax_mapped, monkeypatch):
    """With ba_global_every >= 1 every global BA runs ba_lm_iters LM steps
    (the JAX package halves the in-loop ones there too); the adaptive default
    keeps its halved in-loop global BA."""
    root, db, _, _, _ = jax_mapped["simple_radial"]
    real = tinc.bundle_adjust
    for every, in_loop in ((1, 20), (0, 10)):
        seen = []

        def record(*a, **kw):
            seen.append((kw["n_lm_iters"], bool(np.asarray(a[8]).any())))
            return real(*a, **kw)

        monkeypatch.setattr(tinc, "bundle_adjust", record)
        data = tinc.load_database(db)
        opt = tinc.MapperOptions(ba_global_every=every, ba_lm_iters=20)
        assert tinc.IncrementalMapper(data, opt, "cpu").run()
        # a global BA frees the focal (argument 8, intr_free); local BAs
        # free no intrinsics
        global_steps = [n for n, free in seen if free]
        assert global_steps[-1] == 20 and set(global_steps[:-1]) == {in_loop}, seen


# -- tracks and the known-poses triangulation ----------------------------------


def test_build_tracks_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    path = tmp_path / "matches.h5"
    names = [f"im{i}.jpg" for i in range(6)]
    for a in range(6):
        for b in range(a + 1, 6):
            m = np.unique(rng.integers(0, 60, (int(rng.integers(0, 40)), 2)), axis=0)
            save_matches(path, names[a], names[b], m)
    assert ttracks.build_tracks(path) == jtracks.build_tracks(path)
    assert ttracks.build_tracks(path, 3) == jtracks.build_tracks(path, 3)


def test_triangulation_from_known_poses_matches_jax(tmp_path):
    """test_sfm.py::test_native_triangulate_points_from_poses's scene through
    the port's known-poses path (database rebuilt from the model and
    features.h5 / matches.h5 written by the port), against the JAX
    package's on the same files."""
    from deep_image_matching_tpu import triangulation as jtri

    rng = np.random.default_rng(7)
    intr, X, poses = _make_scene(rng, n_cams=4, n_pts=500, k1=0.0)
    names = [f"img{i}.jpg" for i in range(len(poses))]
    vis_ids = []
    for i, p in enumerate(poses):
        R = G.rotvec_to_matrix(p[:3])
        uv, z = G.project_points(intr, R, p[3:], X)
        vis = (z > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < 640) & (uv[:, 1] >= 0) & (uv[:, 1] < 480)
        ids = np.where(vis)[0]
        # features.h5 keypoints are in the pipeline's convention, 0.5 px
        # before COLMAP's, which the import adds
        kp = uv[ids] + rng.normal(0, 0.3, (len(ids), 2)) - 0.5
        save_features(tmp_path / "features.h5", names[i], keypoints=kp.astype(np.float32))
        vis_ids.append(ids)
    for i in range(len(poses)):
        for j in range(i + 1, len(poses)):
            _, ia, ib = np.intersect1d(vis_ids[i], vis_ids[j], return_indices=True)
            save_matches(tmp_path / "matches.h5", names[i], names[j], np.stack([ia, ib], 1))
    model = tmp_path / "model"
    model.mkdir()
    cams = {1: Camera(id=1, model="SIMPLE_RADIAL", width=640, height=480, params=intr.copy())}
    imgs = {i + 1: Image(id=i + 1, qvec=rotmat2qvec(G.rotvec_to_matrix(p[:3])), tvec=p[3:].copy(),
                         camera_id=1, name=names[i], xys=np.zeros((0, 2)),
                         point3D_ids=np.zeros(0, np.int64))
            for i, p in enumerate(poses)}
    write_model(cams, imgs, {}, model, ext=".txt")
    out = {}
    for tag, mod in (("jax", jtri), ("port", ttri)):
        db = mod.db_from_existing_poses(model, tmp_path / "features.h5", tmp_path / "matches.h5",
                                        tmp_path / f"{tag}.db")
        kw = {"device": "cpu"} if tag == "port" else {}
        out[tag] = mod.triangulate_points(model, db, tmp_path, tmp_path / tag, backend="native", **kw)
    con = [sqlite3.connect(str(tmp_path / f"{t}.db")) for t in ("jax", "port")]
    rows = [c.execute("SELECT pair_id, rows, data FROM two_view_geometries ORDER BY pair_id")
            .fetchall() for c in con]
    assert rows[0] == rows[1] and len(rows[0]) == 6
    _, _, pts_j = out["jax"]
    _, _, pts_t = out["port"]
    assert abs(len(pts_t) - len(pts_j)) <= 0.02 * len(pts_j) and len(pts_t) > 300
    errs = [np.linalg.norm(X - p.xyz, axis=1).min() for p in pts_t.values()]
    assert np.median(errs) < 0.05
    common = sorted(set(pts_t) & set(pts_j))
    assert len(common) >= 0.98 * len(pts_j)
    d = max(np.linalg.norm(pts_t[k].xyz - pts_j[k].xyz) for k in common)
    assert d < 1e-3, d
    assert (tmp_path / "port" / "points3D.txt").exists()


# -- run_matching through stage 5 ----------------------------------------------


def test_run_matching_through_reconstruction_matches_jax(tmp_path):
    """sift+kornia_matcher on the five demo images without
    --skip_reconstruction, both packages on the CPU: the same initial pair
    and registered images, point counts within 2 %, and the model files."""
    proj = tmp_path / "proj"
    shutil.copytree(DEMO_IMAGES, proj / "images")
    cfg = tmp_path / "config.yaml"
    cfg.write_text("general:\n  tpu:\n    device: cpu\n    match_batch_size: 2\n")
    init = {}

    class Init(logging.Handler):
        def emit(self, rec):
            msg = rec.getMessage()
            if msg.startswith("Initialized from pair"):
                init[rec.name] = msg.split(":")[0]

    handler = Init()
    for name in ("dim_tpu", "dim_tpu_torch"):
        logging.getLogger(name).addHandler(handler)
    models = {}
    try:
        for tag, run in (("jax", jax_run_matching), ("torch", torch_run_matching)):
            _, _, models[tag] = run({
                "dir": str(proj), "outs": str(tmp_path / tag), "pipeline": "sift+kornia_matcher",
                "strategy": "bruteforce", "force": True, "config_file": str(cfg)})
    finally:
        for name in ("dim_tpu", "dim_tpu_torch"):
            logging.getLogger(name).removeHandler(handler)
    assert models["jax"] is not None and models["torch"] is not None
    assert init["dim_tpu"] == init["dim_tpu_torch"]
    names = {t: sorted(i.name for i in m[1].values()) for t, m in models.items()}
    assert names["torch"] == names["jax"] and len(names["torch"]) == 5
    n_pts = {t: len(m[2]) for t, m in models.items()}
    assert abs(n_pts["torch"] - n_pts["jax"]) <= 0.02 * n_pts["jax"], n_pts
    rec = tmp_path / "torch" / "reconstruction"
    for f in ("cameras.txt", "images.txt", "points3D.txt", "model.ply"):
        assert (rec / f).is_file(), f
    cams, imgs, pts = read_model(rec, ".txt")
    assert len(imgs) == 5 and len(pts) == n_pts["torch"]
