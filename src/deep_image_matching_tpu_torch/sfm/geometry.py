"""Multi-view geometry primitives for the native SfM mapper.

Division of labor: the small, precision-critical solves (DLT triangulation,
8-point essential, PnP minimal solves) run as *vectorized float64 numpy* on
host — batched ``np.linalg.eigh`` over thousands of 4x4/12x12 systems, not
Python loops. The FLOP-heavy stage, bundle adjustment, runs on the mapper's
device in PyTorch (see ``sfm/ba.py``); float32 there is conditioned by scene
normalization. Conventions follow COLMAP: world-to-camera ``x_cam = R @
x_world + t``; SIMPLE_RADIAL intrinsics ``(f, cx, cy, k1)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# rotations
# ---------------------------------------------------------------------------


def rotvec_to_matrix(rvec: np.ndarray) -> np.ndarray:
    """Rodrigues axis-angle (3,) -> rotation matrix (3,3); safe at 0."""
    rvec = np.asarray(rvec, np.float64)
    theta = np.sqrt(np.sum(rvec**2) + 1e-24)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def matrix_to_rotvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle."""
    R = np.asarray(R, np.float64)
    cos_theta = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    if theta < 1e-8:
        return np.zeros(3)
    if np.pi - theta < 1e-6:
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diag(A), 0.0))
        if axis[0] > 1e-6:
            axis[1] = np.copysign(axis[1], A[0, 1])
            axis[2] = np.copysign(axis[2], A[0, 2])
        elif axis[1] > 1e-6:
            axis[2] = np.copysign(axis[2], A[1, 2])
        axis /= np.linalg.norm(axis) + 1e-24
        return axis * theta
    axis = np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
    ) / (2.0 * np.sin(theta))
    return axis * theta


# ---------------------------------------------------------------------------
# camera model — unified 8-parameter OPENCV vector
# ---------------------------------------------------------------------------
# Every camera is carried internally as ``(fx, fy, cx, cy, k1, k2, p1, p2)``
# (the COLMAP OPENCV model); simpler models embed with fx=fy and zero
# higher-order terms, so SIMPLE_RADIAL / RADIAL / PINHOLE round-trip exactly.


def intr8(intr) -> np.ndarray:
    """Coerce a legacy 4-vector (f, cx, cy, k1) or an 8-vector to intr8."""
    intr = np.asarray(intr, np.float64).ravel()
    if intr.size == 8:
        return intr
    if intr.size == 4:
        f, cx, cy, k1 = intr
        return np.array([f, f, cx, cy, k1, 0.0, 0.0, 0.0])
    raise ValueError(f"intrinsics must be 4 or 8 values, got {intr.size}")


def distort_normalized(intr: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Apply OPENCV radial+tangential distortion to normalized coords.

    xy: (..., 2). Works with any leading batch shape and per-element
    intrinsics broadcast as intr (..., 8) or a single (8,).
    """
    intr = np.asarray(intr, np.float64)
    k1, k2 = intr[..., 4:5], intr[..., 5:6]
    p1, p2 = intr[..., 6:7], intr[..., 7:8]
    x, y = xy[..., 0:1], xy[..., 1:2]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.concatenate([xd, yd], axis=-1)


def normalized_to_pixels(intr: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Distorted normalized coords -> pixels (per-element intr broadcast)."""
    intr = np.asarray(intr, np.float64)
    xyd = distort_normalized(intr, xy)
    return xyd * intr[..., 0:2] + intr[..., 2:4]


def project_points(
    intr: np.ndarray, R: np.ndarray, t: np.ndarray, X: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """World points X (N,3) -> pixels (N,2) with the OPENCV intr8 model.

    Returns (uv, z_cam); z<=0 means behind the camera.
    """
    intr = intr8(intr)
    Xc = X @ np.asarray(R).T + np.asarray(t)
    z = Xc[:, 2]
    zs = np.where(np.abs(z) < 1e-12, 1e-12, z)
    xy = Xc[:, :2] / zs[:, None]
    uv = normalized_to_pixels(intr, xy)
    return uv, z


def undistort_normalized(intr: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Pixels -> normalized (undistorted) camera coords.

    Inverts the OPENCV distortion by fixed-point iteration (exact when all
    distortion terms are zero; converges for photographic distortion
    magnitudes)."""
    intr = intr8(intr)
    fx, fy, cx, cy, k1, k2, p1, p2 = [float(v) for v in intr]
    xyd = (np.asarray(uv, np.float64) - [cx, cy]) / [fx, fy]
    xy = xyd.copy()
    for _ in range(10):
        x, y = xy[:, 0:1], xy[:, 1:2]
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xy = (xyd - np.concatenate([dx, dy], axis=1)) / radial
    return xy


# ---------------------------------------------------------------------------
# FULL_OPENCV (rational-polynomial) distortion — COLMAP model 6
# ---------------------------------------------------------------------------
# params p12 = (fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, k5, k6); radial
# factor is (1 + k1 r^2 + k2 r^4 + k3 r^6) / (1 + k4 r^2 + k5 r^4 + k6 r^6)
# plus the standard tangential terms. The native mapper rectifies the
# rational tail away at load (``load_database``), leaving a plain OPENCV
# camera (k1 k2 p1 p2 live and refinable).


def full_opencv_distort_normalized(p12: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Ideal normalized coords -> FULL_OPENCV-distorted normalized coords."""
    p12 = np.asarray(p12, np.float64).ravel()
    k1, k2, p1, p2, k3, k4, k5, k6 = p12[4:12]
    x, y = xy[..., 0:1], xy[..., 1:2]
    r2 = x * x + y * y
    radial = (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))) / (
        1.0 + r2 * (k4 + r2 * (k5 + r2 * k6))
    )
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.concatenate([xd, yd], axis=-1)


def full_opencv_undistort_normalized(p12: np.ndarray, xyd: np.ndarray) -> np.ndarray:
    """Inverse of ``full_opencv_distort_normalized`` by fixed-point
    iteration (the cv2.undistortPoints scheme, converges for photographic
    distortion magnitudes)."""
    p12 = np.asarray(p12, np.float64).ravel()
    k1, k2, p1, p2, k3, k4, k5, k6 = p12[4:12]
    xyd = np.asarray(xyd, np.float64)
    xy = xyd.copy()
    for _ in range(12):
        x, y = xy[..., 0:1], xy[..., 1:2]
        r2 = x * x + y * y
        radial = (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))) / (
            1.0 + r2 * (k4 + r2 * (k5 + r2 * k6))
        )
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xy = (xyd - np.concatenate([dx, dy], axis=-1)) / radial
    return xy


# ---------------------------------------------------------------------------
# fisheye (equidistant) distortion — COLMAP *_FISHEYE family
# ---------------------------------------------------------------------------
# COLMAP models OPENCV_FISHEYE (5), SIMPLE_RADIAL_FISHEYE (8),
# RADIAL_FISHEYE (9) share the equidistant projection: with r = |xy| and
# theta = atan(r), the distorted radius is
# theta_d = theta (1 + k1 th^2 + k2 th^4 + k3 th^6 + k4 th^8) and the
# distorted point is xy * theta_d / r. The native mapper rectifies fisheye
# keypoints to an ideal pinhole frame at load time (``load_database``), so
# only these two conversions are needed — the incremental pipeline itself
# stays on the OPENCV/pinhole intr8 model.


def fov_distort_normalized(omega: float, xy: np.ndarray) -> np.ndarray:
    """COLMAP FOV model (7, Devernay-Faugeras): r_d = atan(2 r tan(w/2))/w.
    Exact closed-form in both directions."""
    xy = np.asarray(xy, np.float64)
    r = np.sqrt(np.sum(xy * xy, axis=-1, keepdims=True))
    if abs(omega) < 1e-9:
        return xy.copy()
    t = 2.0 * np.tan(omega / 2.0)
    rd = np.arctan(r * t) / omega
    scale = np.where(r < 1e-12, t / omega, rd / np.where(r < 1e-12, 1.0, r))
    return xy * scale


def fov_undistort_normalized(omega: float, xyd: np.ndarray) -> np.ndarray:
    """Exact inverse of the FOV model: r = tan(r_d w) / (2 tan(w/2))."""
    xyd = np.asarray(xyd, np.float64)
    rd = np.sqrt(np.sum(xyd * xyd, axis=-1, keepdims=True))
    if abs(omega) < 1e-9:
        return xyd.copy()
    t = 2.0 * np.tan(omega / 2.0)
    r = np.tan(rd * omega) / t
    scale = np.where(rd < 1e-12, omega / t, r / np.where(rd < 1e-12, 1.0, rd))
    return xyd * scale


def thin_prism_distort_normalized(p12: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """COLMAP THIN_PRISM_FISHEYE (10): equidistant projection, then radial
    k1..k4 + tangential p1 p2 + thin-prism sx1 sy1 on the fisheye-projected
    coords. params p12 = (fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, sx1, sy1)."""
    p12 = np.asarray(p12, np.float64).ravel()
    k1, k2, p1, p2, k3, k4, sx1, sy1 = p12[4:12]
    xy = np.asarray(xy, np.float64)
    # equidistant (fisheye) projection first, plain theta (no poly here)
    r = np.sqrt(np.sum(xy * xy, axis=-1, keepdims=True))
    theta = np.arctan(r)
    xy = xy * np.where(
        r < 1e-12, 1.0, theta / np.where(r < 1e-12, 1.0, r)
    )
    x, y = xy[..., 0:1], xy[..., 1:2]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) + sx1 * r2
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y + sy1 * r2
    return np.concatenate([xd, yd], axis=-1)


def thin_prism_undistort_normalized(p12: np.ndarray, xyd: np.ndarray) -> np.ndarray:
    """Inverse of ``thin_prism_distort_normalized``: fixed-point on the
    polynomial stage, then exact r = tan(theta) for the equidistant stage."""
    p12 = np.asarray(p12, np.float64).ravel()
    k1, k2, p1, p2, k3, k4, sx1, sy1 = p12[4:12]
    xyd = np.asarray(xyd, np.float64)
    xy = xyd.copy()
    for _ in range(12):
        x, y = xy[..., 0:1], xy[..., 1:2]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) + sx1 * r2
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y + sy1 * r2
        xy = (xyd - np.concatenate([dx, dy], axis=-1)) / radial
    theta = np.sqrt(np.sum(xy * xy, axis=-1, keepdims=True))
    r = np.tan(theta)
    return xy * np.where(
        theta < 1e-12, 1.0, r / np.where(theta < 1e-12, 1.0, theta)
    )


def fisheye_distort_normalized(k: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Ideal-pinhole normalized coords -> equidistant-distorted normalized
    coords. ``k``: (4,) [k1, k2, k3, k4]; xy: (..., 2)."""
    k = np.asarray(k, np.float64).ravel()
    xy = np.asarray(xy, np.float64)
    r = np.sqrt(np.sum(xy * xy, axis=-1, keepdims=True))
    theta = np.arctan(r)
    t2 = theta * theta
    theta_d = theta * (
        1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3])))
    )
    # theta_d / r -> 1 as r -> 0 (theta ~ r)
    scale = np.where(r < 1e-12, 1.0, theta_d / np.where(r < 1e-12, 1.0, r))
    return xy * scale


def fisheye_undistort_normalized(k: np.ndarray, xyd: np.ndarray) -> np.ndarray:
    """Equidistant-distorted normalized coords -> ideal-pinhole normalized
    coords (Newton on theta; with all k zero this reduces to the exact
    r = tan(theta_d) — equidistant zero-k is still not pinhole)."""
    k = np.asarray(k, np.float64).ravel()
    xyd = np.asarray(xyd, np.float64)
    rd = np.sqrt(np.sum(xyd * xyd, axis=-1, keepdims=True))
    theta = rd.copy()  # rd IS theta_d; theta_d ~ theta for small distortion
    for _ in range(10):
        t2 = theta * theta
        poly = 1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3])))
        dpoly = (
            2.0 * k[0]
            + t2 * (4.0 * k[1] + t2 * (6.0 * k[2] + t2 * 8.0 * k[3]))
        )
        f = theta * poly - rd
        df = poly + t2 * dpoly
        theta = theta - f / np.where(np.abs(df) < 1e-12, 1e-12, df)
    r = np.tan(theta)
    scale = np.where(rd < 1e-12, 1.0, r / np.where(rd < 1e-12, 1.0, rd))
    return xyd * scale


# ---------------------------------------------------------------------------
# triangulation (batched DLT, float64)
# ---------------------------------------------------------------------------


def triangulate_dlt(
    P0: np.ndarray, P1: np.ndarray, x0: np.ndarray, x1: np.ndarray
) -> np.ndarray:
    """Two-view DLT triangulation, vectorized over points.

    P0,P1: (3,4) projections onto *normalized* image coords; x0,x1: (N,2)
    normalized coords. Solves the 4x4 homogeneous system per point via a
    batched eigendecomposition of A^T A.
    """
    x0 = np.asarray(x0, np.float64)
    x1 = np.asarray(x1, np.float64)

    def rows(P, x):
        return np.stack(
            [x[:, 0:1] * P[2] - P[0], x[:, 1:2] * P[2] - P[1]], axis=1
        )  # (N,2,4)

    A = np.concatenate([rows(np.asarray(P0, np.float64), x0),
                        rows(np.asarray(P1, np.float64), x1)], axis=1)
    AtA = np.einsum("nij,nik->njk", A, A)
    _, v = np.linalg.eigh(AtA)
    Xh = v[:, :, 0]
    w = Xh[:, 3:4]
    return Xh[:, :3] / np.where(np.abs(w) < 1e-12, 1e-12, w)


def triangulate_multiview(Ps: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """N-view DLT for one track: Ps (V,3,4), xs (V,2) normalized. -> (3,)"""
    rows = np.concatenate(
        [
            xs[:, 0:1] * Ps[:, 2] - Ps[:, 0],
            xs[:, 1:2] * Ps[:, 2] - Ps[:, 1],
        ],
        axis=0,
    )  # (2V,4)
    _, v = np.linalg.eigh(rows.T @ rows)
    Xh = v[:, 0]
    w = Xh[3] if abs(Xh[3]) > 1e-12 else 1e-12
    return Xh[:3] / w


def pose_to_P(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    return np.concatenate(
        [np.asarray(R, np.float64), np.asarray(t, np.float64).reshape(3, 1)], axis=1
    )


def camera_center(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    return -np.asarray(R).T @ np.asarray(t)


def triangulation_angles(
    X: np.ndarray, c0: np.ndarray, c1: np.ndarray
) -> np.ndarray:
    """Angle (deg) at each point X between the rays to camera centers c0, c1."""
    d0 = c0[None] - X
    d1 = c1[None] - X
    cosang = np.sum(d0 * d1, axis=1) / (
        np.linalg.norm(d0, axis=1) * np.linalg.norm(d1, axis=1) + 1e-12
    )
    return np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))


# ---------------------------------------------------------------------------
# essential matrix
# ---------------------------------------------------------------------------


def essential_from_normalized(x0: np.ndarray, x1: np.ndarray) -> np.ndarray:
    """8-point essential matrix from normalized coords (N>=8): Hartley
    conditioning + projection onto the essential manifold."""
    x0 = np.asarray(x0, np.float64)
    x1 = np.asarray(x1, np.float64)

    def normalize(x):
        mean = x.mean(axis=0)
        scale = np.sqrt(2.0) / (np.mean(np.linalg.norm(x - mean, axis=1)) + 1e-12)
        T = np.array(
            [[scale, 0, -scale * mean[0]], [0, scale, -scale * mean[1]], [0, 0, 1]]
        )
        xh = np.concatenate([x, np.ones((len(x), 1))], axis=1) @ T.T
        return xh, T

    a, T0 = normalize(x0)
    b, T1 = normalize(x1)
    # constraint: b^T E a = 0
    A = np.stack(
        [
            b[:, 0] * a[:, 0], b[:, 0] * a[:, 1], b[:, 0],
            b[:, 1] * a[:, 0], b[:, 1] * a[:, 1], b[:, 1],
            a[:, 0], a[:, 1], np.ones(len(a)),
        ],
        axis=1,
    )
    _, _, Vt = np.linalg.svd(A, full_matrices=False)
    E = Vt[-1].reshape(3, 3)
    E = T1.T @ E @ T0
    U, s, Vt = np.linalg.svd(E)
    sm = (s[0] + s[1]) / 2.0
    return U @ np.diag([sm, sm, 0.0]) @ Vt


def sampson_error_sq(E: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> np.ndarray:
    """Squared Sampson distance of normalized correspondences under E."""
    x0h = np.concatenate([x0, np.ones((len(x0), 1))], axis=1)
    x1h = np.concatenate([x1, np.ones((len(x1), 1))], axis=1)
    Ex0 = x0h @ E.T  # (N,3)
    Etx1 = x1h @ E  # (N,3)
    num = np.sum(x1h * Ex0, axis=1) ** 2
    den = Ex0[:, 0] ** 2 + Ex0[:, 1] ** 2 + Etx1[:, 0] ** 2 + Etx1[:, 1] ** 2
    return num / np.maximum(den, 1e-18)


def ransac_essential(
    x0: np.ndarray,
    x1: np.ndarray,
    thresh: float,
    n_iters: int = 200,
    rng: Optional[np.random.Generator] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """RANSAC over 8-point essential hypotheses on normalized coords.

    Returns (E, inlier_mask) or None. ``thresh`` is in normalized units
    (pixel threshold / focal).
    """
    N = len(x0)
    if N < 8:
        return None
    rng = rng or np.random.default_rng(0)
    best_E, best_mask, best_count = None, None, -1
    t2 = thresh * thresh
    for _ in range(n_iters):
        idx = rng.choice(N, size=8, replace=False)
        try:
            E = essential_from_normalized(x0[idx], x1[idx])
        except np.linalg.LinAlgError:
            continue
        mask = sampson_error_sq(E, x0, x1) < t2
        c = int(mask.sum())
        if c > best_count:
            best_E, best_mask, best_count = E, mask, c
    if best_count < 8:
        return None
    # final refit on the inliers
    E = essential_from_normalized(x0[best_mask], x1[best_mask])
    mask = sampson_error_sq(E, x0, x1) < t2
    return E, mask


def decompose_essential(
    E: np.ndarray, x0: np.ndarray, x1: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pick the (R,t) among the 4 essential decompositions with the best
    cheirality support. Pose maps cam0-frame points into cam1
    (x1 = R x0 + t); t has unit norm (monocular gauge).
    Returns (R, t, in_front_mask)."""
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float64)
    P0 = pose_to_P(np.eye(3), np.zeros(3))
    best = None
    for R in (U @ W @ Vt, U @ W.T @ Vt):
        for t in (U[:, 2], -U[:, 2]):
            P1 = pose_to_P(R, t)
            X = triangulate_dlt(P0, P1, x0, x1)
            z0 = X[:, 2]
            z1 = (X @ R.T + t)[:, 2]
            front = (z0 > 0) & (z1 > 0)
            if best is None or front.sum() > best[2].sum():
                best = (R, t, front)
    return best


# ---------------------------------------------------------------------------
# PnP (vectorized 6-point DLT RANSAC)
# ---------------------------------------------------------------------------


def _pnp_dlt_batch(Xs: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Solve H independent 6-point DLTs for P=[R|t].

    Xs: (H,6,3) world points, xs: (H,6,2) normalized coords -> (H,3,4) with
    orthonormalized rotations (det +1) and cheirality-corrected sign.
    """
    H, S, _ = Xs.shape
    Xh = np.concatenate([Xs, np.ones((H, S, 1))], axis=2)  # (H,S,4)
    zeros = np.zeros((H, S, 4))
    r1 = np.concatenate([Xh, zeros, -xs[:, :, 0:1] * Xh], axis=2)
    r2 = np.concatenate([zeros, Xh, -xs[:, :, 1:2] * Xh], axis=2)
    A = np.concatenate([r1, r2], axis=1)  # (H,2S,12)
    AtA = np.einsum("hij,hik->hjk", A, A)
    _, v = np.linalg.eigh(AtA)
    P = v[:, :, 0].reshape(H, 3, 4)
    # cheirality sign of the raw DLT solution: sample points must have z>0,
    # so fix the sign of the whole P *before* orthonormalizing (a valid
    # P = s[R|t] has det(M)=s^3, so the sign fix also makes det positive)
    z_raw = np.einsum("hsj,hj->hs", Xs, P[:, 2, :3]) + P[:, 2, 3:4]
    sign = np.where(np.sign(z_raw).sum(axis=1) < 0, -1.0, 1.0)
    P = P * sign[:, None, None]
    M = P[:, :, :3]
    U, s, Vt = np.linalg.svd(M)
    det = np.linalg.det(np.einsum("hij,hjk->hik", U, Vt))
    D = np.zeros((H, 3, 3))
    D[:, 0, 0] = 1.0
    D[:, 1, 1] = 1.0
    D[:, 2, 2] = det
    R = np.einsum("hij,hjk,hkl->hil", U, D, Vt)
    scale = s.sum(axis=1) / 3.0
    scale = np.where(scale < 1e-12, 1e-12, scale)
    t = P[:, :, 3] / scale[:, None]
    return np.concatenate([R, t[:, :, None]], axis=2)


def pnp_ransac(
    X: np.ndarray,
    uv: np.ndarray,
    intr: np.ndarray,
    n_hyp: int = 256,
    thresh_px: float = 8.0,
    rng: Optional[np.random.Generator] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """RANSAC PnP: world points X (N,3), pixels uv (N,2), SIMPLE_RADIAL intr.

    Prefers OpenCV's planar-safe minimal solvers (P3P/EPnP inside
    ``cv2.solvePnPRansac``) when cv2 is available — 6-point DLT degenerates
    on quasi-planar scenes, which real facades often are. Falls back to the
    batched-DLT RANSAC below (one batched eigh for all hypotheses, one
    broadcasted projection to score) when cv2 is missing.
    Returns (R, t, inlier_mask) or None.
    """
    res = _pnp_ransac_cv2(X, uv, intr, thresh_px)
    if res is not None:
        return res
    X = np.asarray(X, np.float64)
    N = len(X)
    if N < 6:
        return None
    rng = rng or np.random.default_rng(0)
    xn = undistort_normalized(intr, uv)
    idx = np.stack([rng.choice(N, size=6, replace=False) for _ in range(n_hyp)])
    Ps = _pnp_dlt_batch(X[idx], xn[idx])  # (H,3,4)
    Xc = np.einsum("hij,nj->hni", Ps[:, :, :3], X) + Ps[:, None, :, 3]
    z = Xc[:, :, 2]
    zs = np.where(np.abs(z) < 1e-12, 1e-12, z)
    proj = Xc[:, :, :2] / zs[:, :, None]
    err = np.sum((proj - xn[None]) ** 2, axis=2)
    thr2 = (thresh_px / float(intr[0])) ** 2
    inl = (err < thr2) & (z > 0)
    counts = inl.sum(axis=1)
    best = int(np.argmax(counts))
    if counts[best] < 6:
        return None
    P, mask = Ps[best], inl[best]
    # one refit on all inliers (S>6 DLT) for a tighter pose
    if mask.sum() >= 6:
        P2 = _pnp_dlt_batch(X[mask][None], xn[mask][None])[0]
        Xc2 = X @ P2[:, :3].T + P2[:, 3]
        z2 = Xc2[:, 2]
        ok = z2 > 0
        proj2 = Xc2[:, :2] / np.where(np.abs(z2) < 1e-12, 1e-12, z2)[:, None]
        err2 = np.sum((proj2 - xn) ** 2, axis=1)
        mask2 = (err2 < thr2) & ok
        if mask2.sum() >= mask.sum():
            P, mask = P2, mask2
    return P[:, :3], P[:, 3], mask


def _pnp_ransac_cv2(
    X: np.ndarray, uv: np.ndarray, intr: np.ndarray, thresh_px: float
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """cv2.solvePnPRansac on undistorted normalized coords (None if cv2
    is unavailable or the solve fails)."""
    try:
        import cv2
    except ImportError:
        return None
    X = np.ascontiguousarray(np.asarray(X, np.float64))
    if len(X) < 4:
        return None
    xn = undistort_normalized(intr, uv)
    try:
        ok, rvec, tvec, inl = cv2.solvePnPRansac(
            X.reshape(-1, 1, 3),
            np.ascontiguousarray(xn).reshape(-1, 1, 2),
            np.eye(3),
            None,
            reprojectionError=float(thresh_px) / float(intr[0]),
            iterationsCount=500,
            flags=cv2.SOLVEPNP_EPNP,
        )
    except cv2.error:
        return None
    if not ok or inl is None or len(inl) < 4:
        return None
    mask = np.zeros(len(X), bool)
    mask[inl.ravel()] = True
    # LM refinement on the inliers (cv2 minimizes reprojection directly)
    try:
        rvec, tvec = cv2.solvePnPRefineLM(
            X[mask].reshape(-1, 1, 3),
            np.ascontiguousarray(xn[mask]).reshape(-1, 1, 2),
            np.eye(3), None, rvec, tvec,
        )
    except cv2.error:
        pass
    R = rotvec_to_matrix(rvec.ravel())
    t = tvec.ravel()
    # recompute the inlier set under the refined pose
    Xc = X @ R.T + t
    z = Xc[:, 2]
    proj = Xc[:, :2] / np.where(np.abs(z) < 1e-12, 1e-12, z)[:, None]
    err = np.sum((proj - xn) ** 2, axis=1)
    mask = (err < (thresh_px / float(intr[0])) ** 2) & (z > 0)
    if mask.sum() < 4:
        return None
    return R, t, mask
