"""Bundle adjustment in PyTorch on the mapper's device (Levenberg-Marquardt + PCG).

Port of the JAX package's ``sfm/ba.py``, operation for operation:

- **Explicit sparse Jacobian blocks.** Each observation contributes small
  dense blocks d(res)/d(pose) (2x6), d(res)/d(intr) (2x8) and
  d(res)/d(point) (2x3), computed once per LM step with
  ``torch.func.vmap(torch.func.jacfwd(...))``. The Gauss-Newton product
  ``J^T J v`` is three gathers, the blocks' products with the gathered
  vectors and three segment sums: no Jacobian is materialised beyond its
  O(observations) blocks.
- **Segment sums in a fixed order.** Each sum over the observations of a
  pose, a camera or a point gathers the rows into a padded (segments,
  width) layout planned once per problem on the host (``plan_segments``)
  and sums over the width, so every run adds in the same order and the
  card's results are the same from run to run. ``index_add_`` adds with
  float atomics on CUDA, in an order that changes between runs, and the
  mapper amplifies such differences into different models. The products are
  broadcast multiplies and sums over the block's 2 rows or k columns, not
  batched matrix products: cuBLAS runs 262k (1 x 2)(2 x k) products as
  batched GEMV, slower than the broadcast form on an H100.
- **Jacobi-preconditioned CG with Marquardt damping.** The normal equations
  ``(J^T J + lam diag(J^T J)) d = -J^T r`` are solved by CG preconditioned
  with the exact diagonal, which is what makes float32 work despite the
  ~1e4 spread between camera and point curvature. The solve runs inside
  ``utils/device.full_f32``: TF32 products would drop the digits that
  spread needs.
- **One LM step at a time, host-driven loop.** ``(theta, lam)`` stay on the
  device across steps; the one host sync per step fetches the cost and
  whether the step was accepted, which drive the early exit
  (``stall_count``).

There are no padded shape buckets (the JAX package pads to bound XLA
recompiles): every tensor has the problem's own size, so there are no
padding rows and no per-observation weights beyond Huber's.

Residuals use the OPENCV model (fx, fy as logs, cx, cy, k1, k2, p1, p2);
SIMPLE_RADIAL callers pass the legacy 4-vector (f, cx, cy, k1), widened to
the 8-vector for the solve and collapsed back on return. Huber IRLS
reweighting; gauge freedom is removed by the callers' fixed-DOF masks.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.device import full_f32, resolve_device

logger = logging.getLogger("dim_tpu_torch")

# the early exit: stop after this many consecutive stalled steps, a stall
# being an accepted step whose cost fell by at most STALL_RTOL of the
# previous one, or a rejected step once some step has been accepted
STALL_STEPS = 3
STALL_RTOL = 1e-6


class BAProblem(NamedTuple):
    """Device-ready bundle-adjustment problem (no padding)."""

    poses: torch.Tensor       # (M,6) rvec||tvec
    intr: torch.Tensor        # (C,8) fx,fy,cx,cy,k1,k2,p1,p2 (f linear here)
    points: torch.Tensor      # (N,3)
    obs_pose: torch.Tensor    # (O,) int64
    obs_cam: torch.Tensor     # (O,) int64
    obs_pt: torch.Tensor      # (O,) int64
    obs_uv: torch.Tensor      # (O,2)
    pose_free: torch.Tensor   # (M,6) 1 where the DOF is optimized
    intr_free: torch.Tensor   # (C,8) 1 where optimized (fx/fy slots = log f)
    point_free: torch.Tensor  # (N,3)
    seg_pose: Tuple[torch.Tensor, ...]  # plan_segments(obs_pose, M)
    seg_cam: Tuple[torch.Tensor, ...]   # plan_segments(obs_cam, C)
    seg_pt: Tuple[torch.Tensor, ...]    # plan_segments(obs_pt, N)


def _rotvec_to_matrix(rvec):
    """Rodrigues' formula for one rotation vector (3,) -> (3, 3)."""
    theta = torch.sqrt(torch.sum(rvec**2, dim=0, keepdim=True) + 1e-24)
    k = rvec / theta
    zero = torch.zeros_like(theta)
    K = torch.stack([
        torch.cat([zero, -k[2:3], k[1:2]]),
        torch.cat([k[2:3], zero, -k[0:1]]),
        torch.cat([-k[1:2], k[0:1], zero]),
    ])
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)


def _obs_residual(pose6, log_intr8, pt3, uv):
    """Unweighted reprojection residual of one observation, (2,).

    Full OPENCV model: radial (k1, k2) + tangential (p1, p2) distortion with
    independent fx/fy (stored as logs for a better-conditioned focal update).
    Scalars are kept as (1,) slices: under ``jacfwd`` an operation between a
    0-d tensor and a Python number gives float64 tangents.
    """
    R = _rotvec_to_matrix(pose6[:3])
    Xc = R @ pt3 + pose6[3:]
    z = Xc[2:3]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    xy = Xc[:2] / zs
    f = torch.exp(log_intr8[0:2])
    k1, k2 = log_intr8[4:5], log_intr8[5:6]
    p1, p2 = log_intr8[6:7], log_intr8[7:8]
    x, y = xy[0:1], xy[1:2]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.cat([xd, yd]) * f + log_intr8[2:4] - uv


_obs_res_batch = torch.func.vmap(_obs_residual)
_obs_jac_batch = torch.func.vmap(torch.func.jacfwd(_obs_residual, argnums=(0, 1, 2)))


def _gather(theta, prob: BAProblem):
    poses, log_intr, points = theta
    return poses[prob.obs_pose], log_intr[prob.obs_cam], points[prob.obs_pt]


def plan_segments(idx: np.ndarray, n: int, device) -> Tuple[torch.Tensor, ...]:
    """The gather indices of a fixed-order sum of rows into the ``n``
    segments ``idx`` names: one (outputs, width) index matrix a level, whose
    row k lists the level's input rows that add into its output row k, in
    the order they come, padded with the index of a zero row (the level's
    input row count).

    One level takes the rows straight to their segments where that gathers
    at most about four times as many rows as there are. Otherwise (a few
    segments far longer than the mean) a first level sums chunks of a power
    of two rows near the square root of the longest segment, plus one
    all-padding chunk last (the zero row the second level pads with), and
    a second level sums the chunks of each segment."""
    keys = np.asarray(idx, np.int64)
    rows = len(keys)
    order = np.argsort(keys, kind="stable")
    counts = np.bincount(keys, minlength=n)
    seg = keys[order]
    pos = np.arange(rows) - (np.cumsum(counts) - counts)[seg]  # rank within the segment
    width = int(counts.max(initial=1))

    def padded(out_rows, at, col, values, fill):
        g = np.full((out_rows, int(col.max(initial=0)) + 1), fill, np.int64)
        g[at, col] = values
        return torch.from_numpy(g).to(device)

    if n * width <= 4 * rows + n:
        return (padded(n, seg, pos, order, rows),)
    chunk = 1 << int(np.ceil(np.log2(np.sqrt(width))))
    per = -(-counts // chunk)  # chunks a segment
    first = np.cumsum(per) - per
    n_chunks = int(per.sum())
    chunk_seg = np.repeat(np.arange(n), per)
    return (padded(n_chunks + 1, first[seg] + pos // chunk, pos % chunk, order, rows),
            padded(n, chunk_seg, np.arange(n_chunks) - first[chunk_seg], np.arange(n_chunks),
                   n_chunks))


def _segment_sum(x, levels):
    """Rows of ``x`` summed by segment along ``plan_segments``' levels."""
    x = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
    for g in levels:
        x = x[g].sum(1)
    return x


def _tree_dot(a, b):
    return sum(torch.sum(x * y) for x, y in zip(a, b))


def lm_step(theta, lam, prob: BAProblem, huber_delta: float, n_cg_iters: int):
    """One Levenberg-Marquardt iteration; returns (theta, lam, cost, accepted),
    all on the device."""
    free = (prob.pose_free, prob.intr_free, prob.point_free)

    p6, li, pt = _gather(theta, prob)
    res = _obs_res_batch(p6, li, pt, prob.obs_uv)
    # Huber IRLS weights (the JAX package's obs_w is 1 on every real row)
    nrm = torch.sqrt(torch.sum(res**2, dim=1) + 1e-12)
    w = torch.sqrt(torch.clamp(huber_delta / nrm, max=1.0))
    r = res * w[:, None]  # (O,2)
    c0 = 0.5 * torch.sum(r**2)

    Jp, Ji, Jx = _obs_jac_batch(p6, li, pt, prob.obs_uv)
    # weight rows, mask fixed DOFs (columns)
    Jp = Jp * w[:, None, None] * prob.pose_free[prob.obs_pose][:, None, :]
    Ji = Ji * w[:, None, None] * prob.intr_free[prob.obs_cam][:, None, :]
    Jx = Jx * w[:, None, None] * prob.point_free[prob.obs_pt][:, None, :]

    def jt_apply(res2):
        """J^T res2 -> parameter-space tree."""
        return (
            _segment_sum((Jp * res2[:, :, None]).sum(1), prob.seg_pose),
            _segment_sum((Ji * res2[:, :, None]).sum(1), prob.seg_cam),
            _segment_sum((Jx * res2[:, :, None]).sum(1), prob.seg_pt),
        )

    def j_apply(v):
        vp, vi, vx = v
        return (
            (Jp * vp[prob.obs_pose][:, None, :]).sum(2)
            + (Ji * vi[prob.obs_cam][:, None, :]).sum(2)
            + (Jx * vx[prob.obs_pt][:, None, :]).sum(2)
        )

    grad = jt_apply(r)
    # exact diag(J^T J)
    diag = (
        _segment_sum(torch.sum(Jp**2, dim=1), prob.seg_pose),
        _segment_sum(torch.sum(Ji**2, dim=1), prob.seg_cam),
        _segment_sum(torch.sum(Jx**2, dim=1), prob.seg_pt),
    )
    damp = tuple(lam * d + 1e-8 for d in diag)
    precon = tuple(1.0 / (d + dm) for d, dm in zip(diag, damp))

    def hvp(v):
        return tuple(h + dm * x for h, dm, x in zip(jt_apply(j_apply(v)), damp, v))

    def guard(t):
        return torch.where(torch.abs(t) < 1e-20, 1e-20, t)

    # Jacobi-preconditioned CG
    b = tuple(-g for g in grad)
    x = tuple(torch.zeros_like(g) for g in b)
    res_cg = b
    p = tuple(m * c for m, c in zip(precon, b))
    rz = _tree_dot(b, p)
    for _ in range(n_cg_iters):
        Ap = hvp(p)
        alpha = rz / guard(_tree_dot(p, Ap))
        x = tuple(a + alpha * c for a, c in zip(x, p))
        res_cg = tuple(a - alpha * c for a, c in zip(res_cg, Ap))
        z = tuple(m * c for m, c in zip(precon, res_cg))
        rz_new = _tree_dot(res_cg, z)
        beta = rz_new / guard(rz)
        p = tuple(a + beta * c for a, c in zip(z, p))
        rz = rz_new

    theta_new = tuple(a + d * m for a, d, m in zip(theta, x, free))
    p6, li, pt = _gather(theta_new, prob)
    c1 = 0.5 * torch.sum((_obs_res_batch(p6, li, pt, prob.obs_uv) * w[:, None]) ** 2)
    accept = c1 < c0
    theta = tuple(torch.where(accept, b_, a) for a, b_ in zip(theta, theta_new))
    lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 5.0), 1e-10, 1e8)
    return theta, lam, torch.where(accept, c1, c0), accept


def stall_count(stall: int, prev: Optional[float], cost: float, accepted: bool,
                any_accepted: bool) -> int:
    """The early exit's count of consecutive stalled steps after one LM step
    (the solve stops when it reaches ``STALL_STEPS``).

    A step stalls when the cost it returns fell by at most ``STALL_RTOL`` of
    the previous step's, and otherwise resets the count, as in the JAX
    package; but a rejected step leaves the count as it is until the solve
    has accepted a step (``any_accepted``, this step included). Before that,
    rejections are the damping rising from its starting ``lam`` towards a
    step that descends, and counting them would end the solve unrefined
    after three of them."""
    if not accepted and not any_accepted:
        return stall
    if prev is not None and prev - cost <= STALL_RTOL * max(prev, 1e-12):
        return stall + 1
    return 0


def ba_solve(prob: BAProblem, huber_delta: float, n_lm_iters: int, n_cg_iters: int):
    """Host-driven LM loop over ``lm_step``. Returns (poses, intr, points,
    costs), the first three on the device."""
    log_intr0 = prob.intr.clone()
    log_intr0[:, 0:2] = torch.log(torch.clamp(prob.intr[:, 0:2], min=1e-6))
    theta = (prob.poses, log_intr0, prob.points)
    lam = torch.tensor(1e-4, dtype=prob.poses.dtype, device=prob.poses.device)
    costs, prev, stall, any_accepted = [], None, 0, False
    for _ in range(n_lm_iters):
        theta, lam, c, accept = lm_step(theta, lam, prob, huber_delta, n_cg_iters)
        c, accepted = torch.stack([c, accept.to(c.dtype)]).tolist()  # the step's one sync
        accepted = bool(accepted)
        any_accepted |= accepted
        costs.append(c)
        stall = stall_count(stall, prev, c, accepted, any_accepted)
        if stall >= STALL_STEPS:
            break
        prev = c
    poses, log_intr, points = theta
    intr = log_intr.clone()
    intr[:, 0:2] = torch.exp(log_intr[:, 0:2])
    return poses, intr, points, np.asarray(costs)


def make_problem(poses, intr, points, obs_pose, obs_cam, obs_pt, obs_uv, pose_free, intr_free,
                 point_free, device, dtype=np.float32) -> BAProblem:
    """Host arrays -> a ``BAProblem`` on ``device`` (intrinsics as the
    8-vector, focal linear, non-positive focals replaced by 1)."""
    N = len(points)
    intr_safe = np.array(intr, np.float64)
    intr_safe[:, 0:2] = np.where(intr_safe[:, 0:2] <= 0, 1.0, intr_safe[:, 0:2])
    pf = (
        np.ones((N, 3), dtype)
        if point_free is None
        else np.broadcast_to(np.asarray(point_free, dtype).reshape(N, -1), (N, 3)).astype(dtype)
    )

    def dev(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)

    return BAProblem(
        poses=dev(poses, dtype), intr=dev(intr_safe, dtype), points=dev(points, dtype),
        obs_pose=dev(obs_pose, np.int64), obs_cam=dev(obs_cam, np.int64),
        obs_pt=dev(obs_pt, np.int64), obs_uv=dev(obs_uv, dtype),
        pose_free=dev(pose_free, dtype), intr_free=dev(intr_free, dtype), point_free=dev(pf, dtype),
        seg_pose=plan_segments(obs_pose, len(poses), device),
        seg_cam=plan_segments(obs_cam, len(intr_safe), device),
        seg_pt=plan_segments(obs_pt, N, device),
    )


def normalize_scene(poses: np.ndarray, points: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                                    np.ndarray, float]:
    """Center on the point median, unit median norm (float64, on the host):
    returns (poses', points', centroid, scale)."""
    centroid = np.median(points, axis=0)
    scale = float(np.median(np.linalg.norm(points - centroid, axis=1))) + 1e-9
    pts_n = (points - centroid) / scale
    poses_n = poses.copy()
    for i in range(len(poses)):
        R = _np_rotmat(poses[i, :3])
        # x_cam = R x + t with x = centroid + scale*x'  ->  t' = (t + R c)/s
        poses_n[i, 3:] = (poses[i, 3:] + R @ centroid) / scale
    return poses_n, pts_n, centroid, scale


def bundle_adjust(
    poses: np.ndarray,
    intr: np.ndarray,
    points: np.ndarray,
    obs_pose: np.ndarray,
    obs_cam: np.ndarray,
    obs_pt: np.ndarray,
    obs_uv: np.ndarray,
    pose_free: np.ndarray,
    intr_free: np.ndarray,
    point_free: Optional[np.ndarray] = None,
    huber_delta_px: float = 4.0,
    n_lm_iters: int = 25,
    n_cg_iters: int = 30,
    dtype=np.float32,
    device=None,
) -> Dict[str, np.ndarray]:
    """Run LM-BA on ``device``; returns refined poses/intr/points and the
    cost after each LM step.

    Inputs are host numpy. The scene is normalized to unit scale in float64
    on the host for float32 conditioning, solved in ``dtype`` on ``device``
    (``utils/device.resolve_device``: the first CUDA device unless "cpu" is
    asked for), and denormalized.
    """
    device = resolve_device(device)
    # legacy 4-vector (f, cx, cy, k1) compatibility: widen to the OPENCV
    # 8-vector for the solve and collapse back on return
    intr = np.asarray(intr, np.float64)
    intr_free = np.asarray(intr_free, np.float64)
    legacy4 = intr.shape[1] == 4
    if legacy4:
        f, cx, cy, k1 = intr.T
        zc = np.zeros_like(f)
        intr = np.stack([f, f, cx, cy, k1, zc, zc, zc], axis=1)
        ff, fcx, fcy, fk1 = intr_free.T
        zf = np.zeros_like(ff)
        intr_free = np.stack([ff, ff, fcx, fcy, fk1, zf, zf, zf], axis=1)

    N, O = len(points), len(obs_pose)
    if O == 0 or N == 0:
        return {
            "poses": np.asarray(poses, np.float64),
            "intr": np.asarray(intr, np.float64),
            "points": np.asarray(points, np.float64),
            "costs": np.zeros(0),
        }
    poses_n, pts_n, centroid, scale = normalize_scene(
        np.asarray(poses, np.float64), np.asarray(points, np.float64))
    prob = make_problem(poses_n, intr, pts_n, obs_pose, obs_cam, obs_pt, obs_uv, pose_free,
                        intr_free, point_free, device, dtype)
    _t0 = time.perf_counter()
    with full_f32():
        poses_o, intr_o, pts_o, costs = ba_solve(prob, huber_delta_px, n_lm_iters, n_cg_iters)
    logger.debug(
        f"BA solve (M={len(poses)}, N={N}, O={O}) on {device}: "
        f"{len(costs)}/{n_lm_iters} LM steps, {time.perf_counter() - _t0:.2f} s"
    )
    poses_o = poses_o.cpu().numpy().astype(np.float64)
    intr_o = intr_o.cpu().numpy().astype(np.float64)
    if legacy4:
        intr_o = intr_o[:, [0, 2, 3, 4]]  # back to (f, cx, cy, k1)
    pts_o = pts_o.cpu().numpy().astype(np.float64)
    # denormalize
    pts_out = pts_o * scale + centroid
    poses_out = poses_o.copy()
    for i in range(len(poses_o)):
        R = _np_rotmat(poses_o[i, :3])
        poses_out[i, 3:] = poses_o[i, 3:] * scale - R @ centroid
    return {"poses": poses_out, "intr": intr_o, "points": pts_out, "costs": costs}


def _np_rotmat(rvec: np.ndarray) -> np.ndarray:
    theta = np.sqrt(np.sum(rvec**2) + 1e-24)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)
