"""Batched fundamental-matrix RANSAC on the device (PyTorch port of
``deep_image_matching_tpu/ops/ransac.py``).

All hypotheses of all pairs in a batch are evaluated together: Hartley
normalisation, 8-point minimal samples drawn with replacement from each
pair's valid correspondences, one null-space solve per hypothesis (the
kernel of ``ops/nullspace.py`` on CUDA), Sampson-distance scoring, the
best hypothesis per pair, one least-squares refit on its inliers (kept only
if it loses no inliers), and denormalisation. The JAX package's ``vmap``
over pairs is an explicit batch dimension here.

Draws come from a ``torch.Generator``; ``sample_u`` injects the integer
draws instead (B, 8, iters) in [0, n_valid), so a test can feed the JAX
package's ``jax.random.randint`` draws and compare inlier sets.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .nullspace import nullspace_planes


def _normalize_points(pts: torch.Tensor, mask: torch.Tensor):
    """Hartley normalisation per pair: zero mean, mean distance sqrt(2).
    pts (B, M, 2), mask (B, M) -> (pts_n (B, M, 2), T (B, 3, 3))."""
    w = mask.to(pts.dtype)
    count = w.sum(1).clamp(min=1.0)
    mean = (pts * w[..., None]).sum(1) / count[:, None]
    centered = (pts - mean[:, None]) * w[..., None]
    dist = torch.sqrt((centered ** 2).sum(-1))
    mean_dist = ((dist * w).sum(1) / count).clamp(min=1e-8)
    scale = np.float32(np.sqrt(2.0)) / mean_dist
    T = torch.zeros(pts.shape[0], 3, 3, dtype=pts.dtype, device=pts.device)
    T[:, 0, 0] = scale
    T[:, 1, 1] = scale
    T[:, 0, 2] = -scale * mean[:, 0]
    T[:, 1, 2] = -scale * mean[:, 1]
    T[:, 2, 2] = 1.0
    return (pts - mean[:, None]) * scale[:, None, None], T


def _build_constraints(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Epipolar rows a_i with a_i . vec(F) = 0 for x1^T F x0 = 0.
    p0, p1 (..., N, 2) -> (..., N, 9)."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    return torch.stack(
        [x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, torch.ones_like(x0)], -1
    )


def _solve_f(A: torch.Tensor) -> torch.Tensor:
    """Least-squares epipolar solve (smallest eigenvector of A^T A) with the
    rank-2 projection. A (B, N, 9) -> F (B, 3, 3). ``torch.linalg`` here, as
    the JAX package leaves this refit to XLA."""
    AtA = torch.einsum("bni,bnj->bij", A, A)
    _, eigvecs = torch.linalg.eigh(AtA)
    F = eigvecs[..., :, 0].reshape(-1, 3, 3)
    U, S, Vh = torch.linalg.svd(F)
    S = S.clone()
    S[..., 2] = 0.0
    return U @ torch.diag_embed(S) @ Vh


def _sampson_sq(F: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance. F (B, 3, 3); p0/p1 (B, M, 2) -> (B, M)."""
    x0 = torch.cat([p0, torch.ones_like(p0[..., :1])], -1)
    x1 = torch.cat([p1, torch.ones_like(p1[..., :1])], -1)
    Fx0 = torch.einsum("bij,bmj->bmi", F, x0)
    Ftx1 = torch.einsum("bji,bmj->bmi", F, x1)
    num = torch.einsum("bmi,bmi->bm", x1, Fx0) ** 2
    den = Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2 + Ftx1[..., 0] ** 2 + Ftx1[..., 1] ** 2
    return num / den.clamp(min=1e-12)


def _score_planes(f9, p0n, p1n, valid, th_n):
    """Inlier masks (B, I, M) of every hypothesis; f9 (B, 9, I) row-major F
    entries. Component planes, no (B, I, 3, 3) intermediates."""
    x0, y0 = p0n[:, None, :, 0], p0n[:, None, :, 1]          # (B, 1, M)
    x1, y1 = p1n[:, None, :, 0], p1n[:, None, :, 1]
    c = [f9[:, i, :, None] for i in range(9)]                 # (B, I, 1)
    Fx0_0 = c[0] * x0 + c[1] * y0 + c[2]
    Fx0_1 = c[3] * x0 + c[4] * y0 + c[5]
    Fx0_2 = c[6] * x0 + c[7] * y0 + c[8]
    Ftx1_0 = c[0] * x1 + c[3] * y1 + c[6]
    Ftx1_1 = c[1] * x1 + c[4] * y1 + c[7]
    num = (x1 * Fx0_0 + y1 * Fx0_1 + Fx0_2) ** 2
    den = Fx0_0 ** 2 + Fx0_1 ** 2 + Ftx1_0 ** 2 + Ftx1_1 ** 2
    inl = num < (th_n ** 2)[:, None, None] * den.clamp(min=1e-12)
    return inl & valid[:, None, :]


def ransac_fundamental_batch(
    kpts0: torch.Tensor,   # (B, M, 2)
    kpts1: torch.Tensor,   # (B, M, 2)
    mask: torch.Tensor,    # (B, M)
    threshold: float = 4.0,
    iters: int = 2048,
    generator: Optional[torch.Generator] = None,
    sample_u: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Verify a pair batch. Returns (F (B, 3, 3) in pixels, inliers (B, M)
    bool, n_inliers (B,)). Pairs with fewer than 8 valid correspondences get
    no inliers."""
    kpts0 = kpts0.float()
    kpts1 = kpts1.float()
    valid = mask.bool()
    B, M, _ = kpts0.shape
    dev = kpts0.device
    n_valid = valid.sum(1)
    p0n, T0 = _normalize_points(kpts0, valid)
    p1n, T1 = _normalize_points(kpts1, valid)

    # 8 valid indices per hypothesis WITH replacement: draws over
    # [0, n_valid) map to valid positions through a compaction table
    if sample_u is None:
        r = torch.rand((B, 8, iters), generator=generator, device=dev)
        hi = n_valid.clamp(min=1)[:, None, None]
        sample_u = torch.minimum((r * hi).long(), hi - 1)
    cum = torch.cumsum(valid.long(), 1)
    slot = torch.where(valid, cum - 1, torch.full_like(cum, M))
    compact = torch.zeros((B, M + 1), dtype=torch.long, device=dev)
    compact.scatter_(1, slot, torch.arange(M, device=dev).expand(B, M))
    sample_idx = torch.gather(compact[:, :M], 1, sample_u.to(dev).long().reshape(B, -1))

    def gather_pts(pn):
        idx = sample_idx[..., None].expand(-1, -1, 2)
        return torch.gather(pn, 1, idx).reshape(B, 8, iters, 2)

    s0, s1 = gather_pts(p0n), gather_pts(p1n)
    x0, y0, x1, y1 = s0[..., 0], s0[..., 1], s1[..., 0], s1[..., 1]
    A9 = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0,
                      torch.ones_like(x0)], 1)              # (B, 9, 8, I)
    planes = A9.permute(1, 2, 0, 3).reshape(9, 8, B * iters)
    f = nullspace_planes(planes.contiguous())               # (9, B*I)
    f9 = f.reshape(9, B, iters).permute(1, 0, 2)            # (B, 9, I)

    th_n = threshold * torch.sqrt(T0[:, 0, 0] * T1[:, 0, 0])
    inl = _score_planes(f9, p0n, p1n, valid, th_n)          # (B, I, M)
    best = inl.sum(2).argmax(1)                             # first on ties
    ar = torch.arange(B, device=dev)
    best_inl = inl[ar, best]                                # (B, M)
    F_hyp = f9[ar, :, best].reshape(B, 3, 3)

    A_all = _build_constraints(p0n, p1n) * best_inl.float()[..., None]
    F_refit = _solve_f(A_all)
    inl_refit = (_sampson_sq(F_refit, p0n, p1n) < (th_n ** 2)[:, None]) & valid
    better = inl_refit.sum(1) >= best_inl.sum(1)
    F_best = torch.where(better[:, None, None], F_refit, F_hyp)
    inliers = torch.where(better[:, None], inl_refit, best_inl)

    F_px = T1.transpose(1, 2) @ F_best @ T0
    f22 = F_px[:, 2, 2]
    F_px = F_px / torch.where(f22.abs() > 1e-12, f22, torch.ones_like(f22))[:, None, None]
    inliers = inliers & (n_valid >= 8)[:, None]
    return F_px, inliers, inliers.sum(1)


def ransac_fundamental_store_batch(
    kpts_store: torch.Tensor,  # (N_images, K, 2) padded keypoint table
    idx0: torch.Tensor,        # (B,) image indices, side 0
    idx1: torch.Tensor,        # (B,) image indices, side 1
    matches0: torch.Tensor,    # (B, K) index into side-1 keypoints (junk where ~valid)
    valid: torch.Tensor,       # (B, K)
    threshold: float = 4.0,
    iters: int = 2048,
    generator: Optional[torch.Generator] = None,
    sample_u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gather the matched coordinates from the device keypoint table and
    verify them; returns the (B, K) inlier mask."""
    K = kpts_store.shape[1]
    mk0 = kpts_store[idx0]
    k1 = kpts_store[idx1]
    gi = matches0.long().clamp(0, K - 1)
    mk1 = torch.gather(k1, 1, gi[..., None].expand(-1, -1, 2))
    _, inl, _ = ransac_fundamental_batch(
        mk0, mk1, valid, threshold, iters, generator, sample_u
    )
    return inl


def ransac_fundamental_np(
    kpts0: np.ndarray,
    kpts1: np.ndarray,
    threshold: float = 4.0,
    iters: int = 2048,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host convenience: numpy in and out, one pair, on the CPU."""
    m = len(kpts0)
    cap = max(256, int(2 ** np.ceil(np.log2(max(m, 1)))))
    p0 = np.zeros((1, cap, 2), np.float32)
    p1 = np.zeros((1, cap, 2), np.float32)
    msk = np.zeros((1, cap), bool)
    p0[0, :m] = kpts0
    p1[0, :m] = kpts1
    msk[0, :m] = True
    F, inl, _ = ransac_fundamental_batch(
        torch.from_numpy(p0), torch.from_numpy(p1), torch.from_numpy(msk),
        threshold, iters, torch.Generator().manual_seed(seed),
    )
    return F[0].numpy(), inl[0, :m].numpy()
