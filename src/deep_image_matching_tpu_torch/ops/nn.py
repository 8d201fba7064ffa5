"""Nearest-neighbour descriptor matching without the distance matrix
(kernel 5).

``nn_top2`` returns, for every query row of ``d0`` (B, K0, D), the running
top-2 of ``sq1_j - 2 d0_i . d1_j`` over the rows j of ``d1`` (B, K1, D):
min1, min2 (the multiset's second element, equal to min1 on a double
minimum) and the smallest index reaching min1. Columns are padded to a
multiple of 128 with squared norm 1e12, as the Pallas wrapper pads them. For
CUDA tensors it launches the kernel of ``csrc/nn.cu``; for CPU tensors it
runs ``nn_top2_reference`` on the dense distances.

``nn_match_fused`` is the JAX package's accelerator route
(``ops/pallas_nn.py::nn_match_fused``): the ratio test, the rule that a
match with one finite neighbour is kept, and the mutual check (a second
``nn_top2`` with the operands swapped) are plain tensor code around it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import _lib

_INF = 3.0e38
_BIG = 1.0e12  # squared-norm offset of invalid and padded reference rows


def nn_top2_reference(d0, d1, sq1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the dense (B, K0, K1) distances padded to a multiple
    of 128 columns, argmin (first index), and the minimum with the argmin's
    column set to +inf."""
    dist = sq1.float()[:, None, :] - 2.0 * torch.bmm(d0.float(), d1.float().transpose(1, 2))
    pad = (-dist.shape[2]) % 128
    if pad:
        dist = F.pad(dist, (0, pad), value=_BIG)
    arg = dist.argmin(dim=2)
    min1 = torch.gather(dist, 2, arg[..., None])[..., 0]
    cols = torch.arange(dist.shape[2], device=dist.device)
    min2 = torch.where(cols[None, None, :] == arg[..., None], dist.new_tensor(_INF), dist).amin(2)
    return min1, min2, arg.int()


def nn_top2(d0, d1, sq1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(min1, min2, arg), each (B, K0). On CUDA the kernel takes f32,
    contiguous inputs with a width divisible by 16 (ORB 32, SIFT 128,
    SuperPoint 256) and raises otherwise."""
    if not d0.is_cuda:
        return nn_top2_reference(d0, d1, sq1)
    B, K0, D = d0.shape
    K1 = d1.shape[1]
    if D % 16 or D == 0:
        raise ValueError(f"nn kernel takes a width divisible by 16, got {D}")
    if K0 == 0 or K1 == 0:
        raise ValueError(f"nn kernel needs keypoints on both sides, got {K0} and {K1}")
    dev = d0.device
    _lib.check_cuda("d0", d0, torch.float32, (B, K0, D), dev)
    _lib.check_cuda("d1", d1, torch.float32, (B, K1, D), dev)
    _lib.check_cuda("sq1", sq1, torch.float32, (B, K1), dev, align=4)
    min1 = torch.empty((B, K0), dtype=torch.float32, device=dev)
    min2 = torch.empty_like(min1)
    arg = torch.empty((B, K0), dtype=torch.int32, device=dev)
    _lib.launch(
        "nn", "dim_nn_top2", dev.index, d0.data_ptr(), d1.data_ptr(), sq1.data_ptr(),
        min1.data_ptr(), min2.data_ptr(), arg.data_ptr(), B, K0, K1, D, _lib.stream_of(d0),
    )
    return min1, min2, arg


def check_mode(mode: str) -> None:
    if mode not in ("nn", "mnn", "snn", "smnn"):
        raise ValueError(f"match_mode {mode!r}; expected nn, mnn, snn or smnn")


def nn_match_fused(desc0, desc1, mask0, mask1, mode: str = "smnn", ratio_th: float = 0.95):
    """Match padded descriptor batches (B, K0, D) x (B, K1, D) with masks;
    modes nn / mnn / snn / smnn with the Lowe ratio ``ratio_th``. Invalid
    reference rows carry a 1e12 offset on their squared norms, so they never
    win a minimum. Returns matches0 (B, K0) int32 (-1 = none) and valid."""
    check_mode(mode)
    K0, K1 = desc0.shape[1], desc1.shape[1]
    mask0, mask1 = mask0.bool(), mask1.bool()
    d0 = torch.where(mask0[..., None], desc0.float(), 0.0).contiguous()
    d1 = torch.where(mask1[..., None], desc1.float(), 0.0).contiguous()
    sq1 = (d1 ** 2).sum(-1) + torch.where(mask1, 0.0, _BIG)
    row_sq = (d0 ** 2).sum(-1)
    min1, min2, arg = nn_top2(d0, d1, sq1)
    dist1 = torch.clamp(min1 + row_sq, min=0.0)
    dist2 = torch.clamp(min2 + row_sq, min=0.0)

    valid = mask0 & (min1 < _BIG / 2)
    if mode in ("snn", "smnn"):
        ratio = torch.sqrt(dist1) / torch.clamp(torch.sqrt(dist2), min=1e-12)
        # a query with one finite neighbour keeps its match
        valid = valid & torch.where(min2 < _BIG / 2, ratio <= ratio_th, True)
    if mode in ("mnn", "smnn"):
        sq0 = row_sq + torch.where(mask0, 0.0, _BIG)
        _, _, arg_back = nn_top2(d1, d0, sq0)
        back = torch.gather(arg_back, 1, arg.long().clamp(0, K1 - 1))
        valid = valid & (back == torch.arange(K0, device=back.device)[None])
    matches0 = torch.where(valid, arg, arg.new_tensor(-1)).int()
    return matches0, valid
