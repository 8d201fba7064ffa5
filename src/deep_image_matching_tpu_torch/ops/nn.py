"""Nearest-neighbour descriptor matching without the distance matrix
(kernel 5).

``nn_top2`` returns, for every query row of ``d0`` (B, K0, D), the running
top-2 of ``sq1_j - 2 d0_i . d1_j`` over the rows j of ``d1`` (B, K1, D):
min1, min2 (the multiset's second element, equal to min1 on a double
minimum) and the smallest index reaching min1. Columns are padded to a
multiple of 128 with squared norm 1e12, as the Pallas wrapper pads them. For
CUDA tensors it splits both operands into TF32 halves and runs the product
as three TF32 products on the tensor cores (``csrc/nn.cu``, with a merge
where the columns are split across blocks), from one host call; for CPU
tensors it runs ``nn_top2_reference`` on the dense distances.

``nn_match_fused`` is the JAX package's accelerator route
(``ops/pallas_nn.py::nn_match_fused``): the ratio test, the rule that a
match with one finite neighbour is kept, and the mutual check (a second
launch of the kernel with the operands' halves swapped) are plain tensor
code around it.
"""

from __future__ import annotations

import functools
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


ROWS = COLS = 128  # query rows a block, reference columns a tile


def column_slices(B: int, K0: int, K1: int, D: int, sms: int) -> int:
    """How many column slices the kernel splits the reference tiles into,
    one block each, the slices of a query tile neighbours in the grid: as
    many as fill the ``sms`` SMs where the B ceil(K0 / 128) query blocks
    would not, and at least ceil(D / 128), so that the blocks that run
    together share few query tiles in L2 (132 blocks re-read 132 query tiles
    of 128 x D in hi and lo, which outgrow the 50 MB L2 past D ~ 128); at most
    one a tile, none of them empty (``tune_nn.py`` times the choices)."""
    blocks = B * -(-K0 // ROWS)
    tiles = -(-K1 // COLS)
    want = min(tiles, max(sms // blocks, -(-D // 128), 1))
    per = -(-tiles // want)
    return -(-tiles // per)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tf32_halves(d0, d1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scratch for the TF32 halves of d0 (B, K0, D) and d1 (B, K1, D):
    (2, B, K, D) f32 each, hi then lo, in one allocation; ``top2_launch``
    with ``fill`` writes them (``_lib.tf32_split`` is the split's plain
    version) and later launches over the same d0 and d1 reuse them."""
    B, K0, D = d0.shape
    K1 = d1.shape[1]
    buf = torch.empty(2 * (d0.numel() + d1.numel()), dtype=torch.float32, device=d0.device)
    return buf[:2 * d0.numel()].view(2, B, K0, D), buf[2 * d0.numel():].view(2, B, K1, D)


def top2_launch(d0, d1, sq1, halves, fill: bool, slices: int = None):
    """(min1, min2, arg) of the queries d0 (B, K0, D) against the references
    d1 (B, K1, D), f32 CUDA tensors, from one call of the C entry: the split
    of both into ``halves`` (``tf32_halves(d0, d1)``) where ``fill``, else
    the halves an earlier call over the same d0 and d1 wrote; the kernel; and
    the merge where the columns are split across blocks. Each of the three
    launches is counted. ``slices`` overrides ``column_slices``' pick, for
    timing the choices (``tune_nn.py``)."""
    B, K0, D = d0.shape
    K1 = d1.shape[1]
    if D % 16 or D == 0:
        raise ValueError(f"nn kernel takes a width divisible by 16, got {D}")
    if K0 == 0 or K1 == 0:
        raise ValueError(f"nn kernel needs keypoints on both sides, got {K0} and {K1}")
    dev = d0.device
    s0, s1 = halves
    _lib.check_cuda("d0", d0, torch.float32, (B, K0, D), dev)
    _lib.check_cuda("d1", d1, torch.float32, (B, K1, D), dev)
    _lib.check_cuda("d0's halves", s0, torch.float32, (2, B, K0, D), dev)
    _lib.check_cuda("d1's halves", s1, torch.float32, (2, B, K1, D), dev)
    _lib.check_cuda("sq1", sq1, torch.float32, (B, K1), dev, align=4)
    slices = slices or column_slices(B, K0, K1, D, _sm_count(dev.index))
    # min1, min2, arg (int32 words), then each slice's partials: one allocation
    out = torch.empty((3 + 3 * slices * (slices > 1), B, K0), dtype=torch.float32, device=dev)
    ptr, row = out.data_ptr(), B * K0 * 4
    _lib.launch("nn", "dim_nn_top2", dev.index, d0.data_ptr(), d1.data_ptr(), s0.data_ptr(),
                s1.data_ptr(), int(fill), sq1.data_ptr(), ptr, ptr + row, ptr + 2 * row,
                ptr + 3 * row, B, K0, K1, D, slices, _lib.stream_of(d0))
    # the split and the merge run inside the same call
    _lib.LAUNCHES["nn_split"] += int(fill)
    _lib.LAUNCHES["nn_merge"] += int(slices > 1)
    return out[0], out[1], out[2].view(torch.int32)


def nn_top2(d0, d1, sq1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(min1, min2, arg), each (B, K0). On CUDA the kernel takes f32,
    contiguous inputs with a width divisible by 16 (ORB 32, SIFT 128,
    SuperPoint 256) and raises otherwise."""
    if not d0.is_cuda:
        return nn_top2_reference(d0, d1, sq1)
    return top2_launch(d0, d1, sq1, tf32_halves(d0, d1), fill=True)


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
    # on CUDA both sides are split into TF32 halves once; the mutual check
    # runs the kernel on them with the roles swapped
    halves = tf32_halves(d0, d1) if d0.is_cuda else None
    if halves is None:
        min1, min2, arg = nn_top2(d0, d1, sq1)
    else:
        min1, min2, arg = top2_launch(d0, d1, sq1, halves, fill=True)
    dist1 = torch.clamp(min1 + row_sq, min=0.0)
    dist2 = torch.clamp(min2 + row_sq, min=0.0)

    valid = mask0 & (min1 < _BIG / 2)
    if mode in ("snn", "smnn"):
        ratio = torch.sqrt(dist1) / torch.clamp(torch.sqrt(dist2), min=1e-12)
        # a query with one finite neighbour keeps its match
        valid = valid & torch.where(min2 < _BIG / 2, ratio <= ratio_th, True)
    if mode in ("mnn", "smnn"):
        sq0 = row_sq + torch.where(mask0, 0.0, _BIG)
        if halves is None:
            _, _, arg_back = nn_top2(d1, d0, sq0)
        else:
            _, _, arg_back = top2_launch(d1, d0, sq0, halves[::-1], fill=False)
        back = torch.gather(arg_back, 1, arg.long().clamp(0, K1 - 1))
        valid = valid & (back == torch.arange(K0, device=back.device)[None])
    matches0 = torch.where(valid, arg, arg.new_tensor(-1)).int()
    return matches0, valid
