"""Keypoint detection ops: NMS, masked top-k selection, descriptor sampling.

Port of ``deep_image_matching_tpu/ops/detect.py``, batch-first (B, H, W)
score maps and fixed-capacity (B, K) outputs with validity masks. Selection
is a stable descending sort, so tied scores keep the lower index first, as
``jax.lax.top_k`` keeps them (``torch.topk`` orders ties in no set order, and
on plateaus of equal scores that picks other keypoints); the JAX package's
recursive ``topk_flat`` works around a TPU compiler abort and has no
counterpart here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def max_pool_same(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(B, H, W) max pool with kernel 2r+1, stride 1, SAME padding (padding
    never wins: it is -inf)."""
    k = 2 * radius + 1
    return F.max_pool2d(x[:, None], k, stride=1, padding=radius)[:, 0]


def simple_nms(scores: torch.Tensor, nms_radius: int, iters: int = 2) -> torch.Tensor:
    """Keep local maxima, iteratively recovering secondary maxima outside
    suppressed neighbourhoods (the reference SuperPoint algorithm)."""
    if nms_radius < 0:
        raise ValueError("nms_radius must be >= 0")
    if nms_radius == 0:
        return scores
    zeros = torch.zeros_like(scores)
    max_mask = scores == max_pool_same(scores, nms_radius)
    for _ in range(iters):
        supp_mask = max_pool_same(max_mask.to(scores.dtype), nms_radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == max_pool_same(supp_scores, nms_radius)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def select_topk(
    scores: torch.Tensor,
    k: int,
    threshold: float = 0.0,
    border: int = 0,
    valid_hw: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k keypoints of a (B, H, W) score map with static shapes.

    Positions below ``threshold``, inside the ``border`` margin or outside
    ``valid_hw`` (the unpadded (h, w) per batch element) are masked out.
    Returns kpts (B, k, 2) float32 (x, y), kscores (B, k), valid (B, k);
    valid rows come first (masked positions carry -1, real scores > 0), in
    descending score order, ties by ascending position.
    """
    B, H, W = scores.shape
    dev = scores.device
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    if valid_hw is not None:
        h_hi = valid_hw[0].to(dev)[:, None, None] - border
        w_hi = valid_hw[1].to(dev)[:, None, None] - border
    else:
        h_hi, w_hi = H - border, W - border
    ok = (ys >= border) & (ys < h_hi) & (xs >= border) & (xs < w_hi) & (scores > threshold)
    masked = torch.where(ok, scores, scores.new_tensor(-1.0))
    top_vals, top_idx = torch.sort(masked.reshape(B, H * W), dim=1, descending=True,
                                   stable=True)
    top_vals, top_idx = top_vals[:, :k], top_idx[:, :k]
    valid = top_vals > 0.0
    kpts = torch.stack([(top_idx % W).float(), (top_idx // W).float()], dim=-1)
    kpts = torch.where(valid[..., None], kpts, kpts.new_tensor(0.0))
    kscores = torch.where(valid, top_vals, top_vals.new_tensor(0.0))
    return kpts, kscores, valid


def bilinear_sample(fmap: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample (B, H, W, C) at float (B, K, 2) (x, y) positions, clipped to
    the edges (grid_sample align_corners=True over in-range coords)."""
    B, H, W, C = fmap.shape
    x = coords[..., 0].clamp(0.0, W - 1.0)
    y = coords[..., 1].clamp(0.0, H - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    x1 = torch.clamp(x0 + 1, max=W - 1.0)
    y1 = torch.clamp(y0 + 1, max=H - 1.0)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    flat = fmap.reshape(B, H * W, C)

    def at(yy, xx):
        idx = (yy.long() * W + xx.long())[..., None].expand(-1, -1, C)
        return torch.gather(flat, 1, idx)

    return (
        at(y0, x0) * (1 - wx) * (1 - wy)
        + at(y0, x1) * wx * (1 - wy)
        + at(y1, x0) * (1 - wx) * wy
        + at(y1, x1) * wx * wy
    )


def sample_descriptors_sp(
    kpts: torch.Tensor, desc_map: torch.Tensor, s: int = 8
) -> torch.Tensor:
    """SuperPoint descriptor sampling: kpts (B, K, 2) in full-res pixels,
    desc_map (B, Hc, Wc, C) at stride ``s``, the reference's normalisation;
    output L2-normalised (B, K, C)."""
    _, Hc, Wc, _ = desc_map.shape
    kp = kpts - s / 2 + 0.5
    denom = kpts.new_tensor([Wc * s - s / 2 - 0.5, Hc * s - s / 2 - 0.5])
    grid = kp / denom * 2.0 - 1.0
    coords = (grid + 1.0) / 2.0 * kpts.new_tensor([Wc - 1, Hc - 1])
    desc = bilinear_sample(desc_map, coords)
    norm = torch.linalg.norm(desc, dim=-1, keepdim=True)
    return desc / norm.clamp(min=1e-12)
