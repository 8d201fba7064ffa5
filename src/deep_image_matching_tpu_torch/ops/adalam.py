"""AdaLAM, adaptive locally-affine match filtering (Cavalli et al., ECCV
2020; PyTorch port of ``deep_image_matching_tpu/ops/adalam.py``).

The exact algorithm of kornia's ``match_adalam`` in the JAX package's
fixed-capacity form: seeds by ratio-score NMS over the image-0 radius
(top ``n_seeds``, ties at the lower index as ``jax.lax.top_k``), each seed's
neighbourhood (close in both images, optional orientation and scale gates;
top ``neigh_cap`` by image-0 distance), ``ransac_iters`` two-point local
affine hypotheses per seed, the adaptive inlier count under a
uniform-residual null model (confidence k / (n r_k^2 / R^2) >= c_min), one
weighted refit, and a candidate kept when any accepted seed counts it an
inlier. The JAX package runs it as XLA, outside any Pallas kernel, so this
is plain tensor arithmetic on every device.

The hypotheses' samples (``jax.random.randint`` there) come in as
``samples`` (S, iters, 2) when given; otherwise they are drawn from
``generator`` (a ``torch.Generator`` on the inputs' device).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 2) x (M, 2) -> (N, M) squared distances (the product identity)."""
    return (a ** 2).sum(-1)[:, None] + (b ** 2).sum(-1)[None, :] - 2.0 * (a @ b.T)


def _topk_stable(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis, ties at the lower index."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _solve_2x2(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """A with X A = Y from two correspondences (rows of X, Y (..., 2, 2));
    a degenerate X (|det| <= 1e-8) gives A = 0."""
    det = X[..., 0, 0] * X[..., 1, 1] - X[..., 0, 1] * X[..., 1, 0]
    safe = det.abs() > 1e-8
    inv_det = torch.where(safe, 1.0 / torch.where(safe, det, det.new_tensor(1.0)),
                          det.new_tensor(0.0))
    Xinv = torch.stack([torch.stack([X[..., 1, 1], -X[..., 0, 1]], -1),
                        torch.stack([-X[..., 1, 0], X[..., 0, 0]], -1)], -2) * inv_det[..., None, None]
    return Xinv @ Y


def _weighted_refit(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The weighted least-squares A minimising sum w ||x A - y||^2, with a
    1e-6 ridge on the normal equations."""
    xw = x * w[..., None]
    G = xw.transpose(-1, -2) @ x + 1e-6 * torch.eye(2, dtype=x.dtype, device=x.device)
    return torch.linalg.solve(G, xw.transpose(-1, -2) @ y)


@torch.no_grad()
def adalam_filter(
    kpts0: torch.Tensor,      # (K, 2)
    kpts1: torch.Tensor,      # (K1, 2) the full image-1 set
    matches0: torch.Tensor,   # (K,) index into kpts1, -1 where none
    valid: torch.Tensor,      # (K,) candidates
    ratios: torch.Tensor,     # (K,) Lowe ratios (lower is better)
    im0_wh: torch.Tensor,     # (2,) (w, h); 0 takes the keypoints' extent
    im1_wh: torch.Tensor,
    samples: Optional[torch.Tensor] = None,   # (S, iters, 2) in [0, M)
    generator: Optional[torch.Generator] = None,
    mnn: Optional[torch.Tensor] = None,       # (K,) mutual mask for seeds
    ori0: Optional[torch.Tensor] = None,      # (K,) degrees
    ori1: Optional[torch.Tensor] = None,      # (K1,) degrees
    scale0: Optional[torch.Tensor] = None,
    scale1: Optional[torch.Tensor] = None,
    area_ratio: float = 100.0,
    search_expansion: float = 4.0,
    ransac_iters: int = 128,
    n_seeds: int = 256,
    neigh_cap: int = 256,
    min_inliers: int = 6,
    min_confidence: float = 200.0,
    ort_th_deg: float = 30.0,
    scale_th: float = 1.5,
    refit: bool = True,
    force_seed_mnn: bool = True,
) -> torch.Tensor:
    """The (K,) keep mask of the candidates that local affinities verify."""
    f32 = torch.float32
    dev = kpts0.device
    K = kpts0.shape[0]
    kpts0, kpts1 = kpts0.to(f32), kpts1.to(f32)
    valid = valid.bool()
    midx = matches0.long().clamp(0, kpts1.shape[0] - 1)
    pts1m = kpts1[midx]

    ext0 = (kpts0.max(0).values - kpts0.min(0).values).clamp(min=1.0)
    ext1 = (kpts1.max(0).values - kpts1.min(0).values).clamp(min=1.0)
    wh0 = torch.where(im0_wh.to(f32) > 0, im0_wh.to(f32), ext0)
    wh1 = torch.where(im1_wh.to(f32) > 0, im1_wh.to(f32), ext1)
    R1 = torch.sqrt(torch.prod(wh0) / (area_ratio * np.pi))
    R2 = torch.sqrt(torch.prod(wh1) / (area_ratio * np.pi))
    ninf = torch.tensor(-float("inf"), device=dev)
    goodness = torch.where(valid, -ratios.to(f32), ninf)

    # seeds: ratio-score NMS over the image-0 R1 neighbourhood
    neigh0 = (_sqdist(kpts0, kpts0) < R1 ** 2) & valid[None, :]
    better = goodness[None, :] > goodness[:, None]
    seed_ok = valid & ~(neigh0 & better).any(dim=1)
    if force_seed_mnn and mnn is not None:
        seed_ok = seed_ok & mnn.bool()
    seed_idx = _topk_stable(torch.where(seed_ok, goodness, ninf), min(n_seeds, K))
    S = seed_idx.shape[0]
    seed_valid = seed_ok[seed_idx]
    s_k0, s_k1 = kpts0[seed_idx], pts1m[seed_idx]

    # neighbourhoods: close in both images, optional orientation / scale gates
    dst0 = _sqdist(s_k0, kpts0)
    dst1 = _sqdist(s_k1, pts1m)
    R1e2 = (R1 * search_expansion) ** 2
    R2e2 = (R2 * search_expansion) ** 2
    member = (dst0 < R1e2) & (dst1 < R2e2) & valid[None, :]
    if ori0 is not None and ori1 is not None:
        dori = (ori1[midx] - ori0).to(f32)
        diff = (torch.remainder(dori[None, :] - dori[seed_idx][:, None] + 180.0, 360.0)
                - 180.0).abs()
        member = member & (diff < ort_th_deg)
    if scale0 is not None and scale1 is not None:
        drate = (scale1[midx] / scale0.clamp(min=1e-8)).to(f32)
        rr = drate[None, :] / drate[seed_idx].clamp(min=1e-8)[:, None]
        member = member & (rr < scale_th) & (rr > 1.0 / scale_th)
    M = min(neigh_cap, K)
    n_idx = _topk_stable(torch.where(member, -dst0, ninf), M)             # (S, M)
    n_ok = torch.gather(member, 1, n_idx)
    x = kpts0[n_idx] - s_k0[:, None]
    y = pts1m[n_idx] - s_k1[:, None]
    n_count = n_ok.sum(1).to(f32)

    # local-affine RANSAC: (S, iters) two-point hypotheses
    if samples is None:
        samples = torch.randint(0, M, (S, ransac_iters, 2), generator=generator, device=dev)
    samp = samples.long().to(dev).reshape(S, -1)
    Xs = torch.gather(x, 1, samp[..., None].expand(-1, -1, 2)).reshape(S, ransac_iters, 2, 2)
    Ys = torch.gather(y, 1, samp[..., None].expand(-1, -1, 2)).reshape(S, ransac_iters, 2, 2)
    samp_ok = torch.gather(n_ok, 1, samp).reshape(S, ransac_iters, 2).all(-1)
    A = _solve_2x2(Xs, Ys)
    pred = torch.einsum("smd,side->sime", x, A)
    res = ((pred - y[:, None]) ** 2).sum(-1)
    inf = torch.tensor(float("inf"), device=dev)
    res = torch.where(n_ok[:, None] & samp_ok[..., None], res, inf)

    pos = torch.arange(1, M + 1, dtype=f32, device=dev)
    idxs = torch.arange(M, device=dev)

    def adaptive_select(res_sq):
        """(count, threshold) of the largest significant sorted prefix."""
        srt = torch.sort(res_sq, dim=-1).values
        n = n_count.clamp(min=1.0).reshape((S,) + (1,) * (srt.ndim - 1))
        conf = pos / (n * (srt / R2e2)).clamp(min=1e-12)
        sig = (conf >= min_confidence) & torch.isfinite(srt)
        last = torch.where(sig, idxs, idxs.new_tensor(-1)).amax(-1)
        thr = torch.gather(srt, -1, last.clamp(0, M - 1)[..., None])[..., 0]
        return last + 1, torch.where(last >= 0, thr, thr.new_tensor(0.0))

    counts, thrs = adaptive_select(res)
    best = counts.argmax(dim=1)
    best_thr = torch.gather(thrs, 1, best[:, None])[:, 0]
    best_res = torch.gather(res, 1, best[:, None, None].expand(-1, 1, M))[:, 0]
    inl = n_ok & (best_res <= best_thr[:, None]) & (best_thr[:, None] > 0)
    if refit:
        A_fit = _weighted_refit(x, y, inl.to(f32))
        res_fit = ((x @ A_fit - y) ** 2).sum(-1)
        res_fit = torch.where(n_ok, res_fit, inf)
        cnt2, thr2 = adaptive_select(res_fit)
        inl = n_ok & (res_fit <= thr2[:, None]) & (thr2[:, None] > 0)
        seed_accept = seed_valid & (cnt2 >= min_inliers)
    else:
        seed_accept = seed_valid & (torch.gather(counts, 1, best[:, None])[:, 0] >= min_inliers)

    votes = torch.zeros(K, dtype=torch.int32, device=dev)
    votes.index_add_(0, n_idx.reshape(-1), (inl & seed_accept[:, None]).int().reshape(-1))
    return valid & (votes > 0)


def adalam_filter_np(kpts0, kpts1, matches0, valid, ratios, im0_wh, im1_wh, seed: int = 0,
                     **kw) -> np.ndarray:
    """Host wrapper: numpy in, numpy out, samples drawn from a generator
    seeded with ``seed``, on the CPU."""
    t = torch.from_numpy
    out = adalam_filter(
        t(np.asarray(kpts0, np.float32)), t(np.asarray(kpts1, np.float32)),
        t(np.asarray(matches0)), t(np.asarray(valid, bool)), t(np.asarray(ratios, np.float32)),
        t(np.asarray(im0_wh, np.float32)), t(np.asarray(im1_wh, np.float32)),
        generator=torch.Generator().manual_seed(seed), **kw)
    return out.numpy()


@torch.no_grad()
def motion_consistency_filter(kpts0: torch.Tensor, kpts1: torch.Tensor, matches0: torch.Tensor,
                              valid: torch.Tensor, radius_frac: float = 0.1,
                              tolerance: float = 0.35, min_votes: int = 4) -> torch.Tensor:
    """``adalam_fast``: keep a (K,) candidate whose displacement agrees,
    within ``tolerance`` of the radius, with at least ``min_votes``
    neighbours inside ``radius_frac`` of the keypoints' diagonal."""
    valid = valid.bool()
    tgt = kpts1[matches0.long().clamp(0, kpts0.shape[0] - 1)]
    disp = tgt - kpts0
    radius = radius_frac * torch.linalg.norm(
        (kpts0.max(0).values - kpts0.min(0).values).clamp(min=1.0))
    d_space = torch.linalg.norm(kpts0[:, None] - kpts0[None, :], dim=-1)
    d_disp = torch.linalg.norm(disp[:, None] - disp[None, :], dim=-1)
    neighbor = valid[:, None] & valid[None, :] & (d_space < radius) & (d_space > 0)
    votes = (neighbor & (d_disp <= tolerance * radius)).sum(1)
    return valid & (votes >= min_votes)
