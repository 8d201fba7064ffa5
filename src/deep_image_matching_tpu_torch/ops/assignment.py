"""LightGlue's dual-softmax assignment without the score matrix (kernel 3).

``assignment_fused`` returns the row and column maxima and argmaxima of the
dense dual-softmax scores

    scores_ij = log_softmax_j(sim)_ij + log_softmax_i(sim)_ij
                + logsig(z0_i) + logsig(z1_j),   sim = md0 . md1^T

over valid entries. For CUDA tensors it launches the kernel of
``csrc/assignment.cu`` twice (a logsumexp pass, then an argmax pass, each
for rows and columns at once, the product in split TF32 on the tensor
cores) and nothing (B, M, N)-shaped is allocated; for CPU tensors it runs
``assignment_reference`` on the dense scores.
``filter_matches_fused`` adds the mutual-nearest-neighbour check and the
threshold.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils.device import upload_blocking
from . import _lib

_NEG = -1e30


def log_assignment_dense(md0, md1, z0, z1, mask0, mask1) -> torch.Tensor:
    """The dense (B, M, N) dual-softmax scores, -1e30 where either side is
    masked (the JAX package's ``_log_assignment`` after the projections)."""
    sim = torch.einsum("bmd,bnd->bmn", md0.float(), md1.float())
    neg = sim.new_tensor(_NEG)
    sim0 = torch.where(mask1[:, None, :], sim, neg)
    sim1 = torch.where(mask0[:, :, None], sim, neg)
    scores = (
        F.log_softmax(sim0, dim=2) + F.log_softmax(sim1, dim=1)
        + F.logsigmoid(z0.float())[:, :, None] + F.logsigmoid(z1.float())[:, None, :]
    )
    both = mask0[:, :, None] & mask1[:, None, :]
    return torch.where(both, scores, neg)


def assignment_reference(md0, md1, z0, z1, mask0, mask1):
    """Plain version: (max0, arg0, max1, arg1) of the dense scores."""
    scores = log_assignment_dense(md0, md1, z0, z1, mask0, mask1)
    max0, arg0 = scores.max(dim=2)
    max1, arg1 = scores.max(dim=1)
    return max0, arg0.int(), max1, arg1.int()


def _scratch(a, b):
    """Scratch that one pass fills and later passes over the same a (B, M,
    Dm), b (B, N, Dm) and masks reuse: the TF32 split of each, (2, B, rows,
    Dp) f32, hi then lo, Dp = Dm rounded up to 32, and the blocks' order, B
    ceil(M / 128) int32."""
    Dp = -(-a.shape[-1] // 32) * 32
    B, M = a.shape[:2]
    return tuple(torch.empty((2,) + tuple(t.shape[:2]) + (Dp,), dtype=torch.float32,
                             device=t.device) for t in (a, b)) + (
        torch.empty(B * -(-M // 128), dtype=torch.int32, device=a.device),)


def _pass(a, b, row_bias, col_bias, scale: float, argmax: bool, scratch=None, fill=True):
    """One kernel pass over s = scale * a . b^T: statistics over j of
    s_ij + col_bias_j for every row i, and over i of s_ij + row_bias_i for
    every column j (logsumexp, or max and first argmax). ``scratch``: the
    buffers of ``_scratch(a, b)``, filled by this launch when ``fill``, else
    holding an earlier pass's over the same a, b and masks; None makes them.
    A bias <= -1e29 marks a masked row or column: its own statistics come out
    as 0 (logsumexp) or -1e30 at index 0 (max), and tiles whose rows or whose
    columns are all masked are skipped. Returns (row_val, row_arg, col_val,
    col_arg); the args are None for logsumexp."""
    B, M, Dm = a.shape
    N = b.shape[1]
    dev = a.device
    if Dm % 16:
        raise ValueError(f"assignment kernel takes a width divisible by 16, got {Dm}")
    if N > 65536:
        raise ValueError(f"assignment kernel takes at most 65536 columns, got {N}")
    _lib.check_cuda("a", a, torch.float32, (B, M, Dm), dev)
    _lib.check_cuda("b", b, torch.float32, (B, N, Dm), dev)
    _lib.check_cuda("row_bias", row_bias, torch.float32, (B, M), dev, align=4)
    _lib.check_cuda("col_bias", col_bias, torch.float32, (B, N), dev, align=4)
    if scratch is None:
        scratch, fill = _scratch(a, b), True
    Dp = -(-Dm // 32) * 32
    a_split, b_split, order = scratch
    _lib.check_cuda("a_split", a_split, torch.float32, (2, B, M, Dp), dev)
    _lib.check_cuda("b_split", b_split, torch.float32, (2, B, N, Dp), dev)
    _lib.check_cuda("order", order, torch.int32, (B * -(-M // 128),), dev, align=4)
    f32, i32 = torch.float32, torch.int32
    row_val = torch.empty((B, M), dtype=f32, device=dev)
    col_val = torch.empty((B, N), dtype=f32, device=dev)
    row_arg = torch.empty((B, M), dtype=i32, device=dev) if argmax else None
    col_arg = torch.empty((B, N), dtype=i32, device=dev) if argmax else None
    row_halves = -(-M // 64)
    part_val = torch.empty((B, row_halves, N), dtype=f32, device=dev)
    part_aux = torch.empty((B, row_halves, N), dtype=i32 if argmax else f32, device=dev)
    _lib.launch(
        "assignment", "dim_assignment_pass", dev.index, a.data_ptr(), b.data_ptr(),
        a_split.data_ptr(), b_split.data_ptr(), order.data_ptr(), int(fill),
        row_bias.data_ptr(), col_bias.data_ptr(), row_val.data_ptr(),
        None if row_arg is None else row_arg.data_ptr(), col_val.data_ptr(),
        None if col_arg is None else col_arg.data_ptr(), part_val.data_ptr(),
        part_aux.data_ptr(), B, M, N, Dm, float(scale), int(argmax), _lib.stream_of(a),
    )
    return row_val, row_arg, col_val, col_arg


def assignment_fused(
    md0: torch.Tensor,   # (B, M, D) final-projected descriptors / d^0.25
    md1: torch.Tensor,   # (B, N, D)
    z0: torch.Tensor,    # (B, M) matchability logits
    z1: torch.Tensor,    # (B, N)
    mask0: torch.Tensor,
    mask1: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(max0, arg0, max1, arg1) of the dual-softmax scores. Inputs are taken
    in f32, as the Pallas kernel takes them. Argmaxima keep the first index
    on ties. Rows of masked points are not meaningful."""
    if not md0.is_cuda:
        return assignment_reference(md0, md1, z0, z1, mask0, mask1)
    md0 = md0.float().contiguous()
    md1 = md1.float().contiguous()
    neg0 = torch.where(mask0, 0.0, _NEG).float()
    neg1 = torch.where(mask1, 0.0, _NEG).float()
    # the first pass splits md0 and md1 into TF32 halves and orders the
    # blocks; the second reuses both
    scratch = _scratch(md0, md1)
    lse_row, _, lse_col, _ = _pass(md0, md1, neg0, neg1, 1.0, False, scratch, fill=True)
    ls0 = F.logsigmoid(z0.float())
    ls1 = F.logsigmoid(z1.float())
    # rows: argmax_j (2 sim_ij - lse_col_j + ls1_j [- 1e30 on invalid j]);
    # columns: argmax_i (2 sim_ij - lse_row_i + ls0_i [- 1e30 on invalid i])
    g_max, arg0, h_max, arg1 = _pass(
        md0, md1, (-lse_row + ls0 + neg0).contiguous(), (-lse_col + ls1 + neg1).contiguous(),
        2.0, True, scratch, fill=False)
    max0 = g_max - lse_row + ls0
    max1 = h_max - lse_col + ls1
    return max0, arg0, max1, arg1


def filter_matches_fused(md0, md1, z0, z1, mask0, mask1, threshold: float):
    """Mutual-NN + threshold filtering from the assignment statistics: the
    outputs of ``models.lightglue.filter_matches_static`` on the dense
    scores. Returns matches0 (B, M) int32 (-1 = none), mscores0, valid0."""
    max0, arg0, _max1, arg1 = assignment_fused(md0, md1, z0, z1, mask0, mask1)
    M = arg0.shape[1]
    idx = torch.arange(M, device=arg0.device)[None]
    mutual0 = torch.gather(arg1, 1, arg0.clamp(min=0).long()) == idx
    mscores0 = torch.where(mutual0, torch.exp(max0),
                           upload_blocking(0.0, max0.device, max0.dtype))
    valid0 = mutual0 & (mscores0 > threshold) & mask0
    matches0 = torch.where(valid0, arg0, upload_blocking(-1, arg0.device, arg0.dtype)).int()
    return matches0, mscores0, valid0
