"""Descriptor nearest-neighbour matching over the dense distance matrix
(port of ``deep_image_matching_tpu/ops/nn_match.py``).

The kornia ``DescriptorMatcher`` semantics (modes nn / mnn / snn / smnn with
a Lowe ratio threshold) on fixed-capacity padded batches: invalid rows and
columns get +inf distance. ``nn_match_auto`` routes CUDA tensors to the
kernel route ``ops/nn.py::nn_match_fused`` and CPU tensors to the dense
``nn_match_batch``, as the JAX package routes an accelerator and the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .nn import check_mode, nn_match_fused

_INF = float("inf")


def _dist_matrix(d0, d1, m0, m1) -> torch.Tensor:
    """(B, N0, N1) squared L2 distances through the product identity,
    clamped at 0; +inf where either side is invalid."""
    d0, d1 = d0.float(), d1.float()
    sq0 = (d0 ** 2).sum(-1)[:, :, None]
    sq1 = (d1 ** 2).sum(-1)[:, None, :]
    cross = torch.bmm(d0, d1.transpose(1, 2))
    dist = torch.clamp(sq0 + sq1 - 2.0 * cross, min=0.0)
    return torch.where(m0[:, :, None] & m1[:, None, :], dist, dist.new_tensor(_INF))


def nn_match_batch(desc0, desc1, mask0, mask1, mode: str = "smnn",
                   ratio_th: float = 0.95) -> Tuple[torch.Tensor, torch.Tensor]:
    """Match (B, N0, D) x (B, N1, D) padded descriptors. Returns matches0
    (B, N0) int32 (index into desc1, -1 if none) and valid (B, N0)."""
    check_mode(mode)
    mask0, mask1 = mask0.bool(), mask1.bool()
    dist = _dist_matrix(desc0, desc1, mask0, mask1)
    nn1_idx = dist.argmin(dim=2)
    nn1_val = torch.gather(dist, 2, nn1_idx[..., None])[..., 0]
    cols = torch.arange(dist.shape[2], device=dist.device)
    nn2_val = torch.where(cols[None, None, :] == nn1_idx[..., None],
                          dist.new_tensor(_INF), dist).amin(2)
    valid = mask0 & torch.isfinite(nn1_val)
    if mode in ("snn", "smnn"):
        # Lowe ratio test on (non-squared) distances
        ratio = torch.sqrt(nn1_val) / torch.sqrt(torch.clamp(nn2_val, min=1e-12))
        valid = valid & torch.where(torch.isfinite(nn2_val), ratio <= ratio_th, True)
    if mode in ("mnn", "smnn"):
        back = dist.argmin(dim=1)  # (B, N1)
        mutual = torch.gather(back, 1, nn1_idx) == torch.arange(
            dist.shape[1], device=dist.device)[None]
        valid = valid & mutual
    matches0 = torch.where(valid, nn1_idx, nn1_idx.new_tensor(-1)).int()
    return matches0, valid


def nn_match_auto(desc0, desc1, mask0, mask1, mode: str = "smnn", ratio_th: float = 0.95):
    """The kernel route for CUDA tensors, the dense route for CPU tensors."""
    if desc0.is_cuda:
        return nn_match_fused(desc0, desc1, mask0, mask1, mode=mode, ratio_th=ratio_th)
    return nn_match_batch(desc0, desc1, mask0, mask1, mode=mode, ratio_th=ratio_th)


def nn_match_with_ratios(desc0, desc1, mask0, mask1, mode: str = "smnn",
                         ratio_th: float = 0.95):
    """``nn_match_batch`` plus the Lowe ratios and the mutual mask, which
    AdaLAM takes as seed scores and for seed selection: (B, N0, D) x
    (B, N1, D) -> matches0 (B, N0) int32, valid, ratios (B, N0) (1 where a
    row has no second neighbour), mutual (B, N0). The JAX package's version
    is dense XLA, so this is plain tensor arithmetic on every device."""
    check_mode(mode)
    mask0, mask1 = mask0.bool(), mask1.bool()
    dist = _dist_matrix(desc0, desc1, mask0, mask1)
    nn1_idx = dist.argmin(dim=2)
    nn1_val = torch.gather(dist, 2, nn1_idx[..., None])[..., 0]
    cols = torch.arange(dist.shape[2], device=dist.device)
    nn2_val = torch.where(cols[None, None, :] == nn1_idx[..., None],
                          dist.new_tensor(_INF), dist).amin(2)
    valid = mask0 & torch.isfinite(nn1_val)
    ratio = torch.sqrt(nn1_val) / torch.sqrt(torch.clamp(nn2_val, min=1e-12))
    ratio = torch.where(torch.isfinite(nn2_val), ratio, ratio.new_tensor(1.0))
    back = dist.argmin(dim=1)
    rows = torch.arange(dist.shape[1], device=dist.device)[None]
    mutual = valid & (torch.gather(back, 1, nn1_idx) == rows)
    if mode in ("snn", "smnn"):
        valid = valid & (ratio <= ratio_th)
    if mode in ("mnn", "smnn"):
        valid = valid & mutual
    matches0 = torch.where(valid, nn1_idx, nn1_idx.new_tensor(-1)).int()
    return matches0, valid, ratio, mutual
