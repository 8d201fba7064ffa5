"""Batched 8x9 null-space solve for RANSAC hypotheses (kernel 4).

``nullspace_planes`` takes constraint systems in the JAX package's plane
layout (9, 8, N) — entry (c, r, n) is coefficient c of constraint row r of
hypothesis n — and returns (9, N) unit null vectors (sign arbitrary). CUDA
tensors go through the one-thread-per-hypothesis Householder kernel of
``csrc/nullspace.cu``; CPU tensors through ``nullspace_reference``.
"""

from __future__ import annotations

import torch

from . import _lib


def nullspace_reference(A9: torch.Tensor) -> torch.Tensor:
    """Plain version: the last column of the complete QR of A^T."""
    At = A9.float().permute(2, 0, 1)                 # (N, 9, 8) = A_n^T
    Q, _ = torch.linalg.qr(At, mode="complete")      # (N, 9, 9)
    return Q[..., 8].T.contiguous()                  # (9, N)


def nullspace_planes(A9: torch.Tensor) -> torch.Tensor:
    if not A9.is_cuda:
        return nullspace_reference(A9)
    if A9.dim() != 3 or A9.shape[:2] != (9, 8):
        raise ValueError(f"expected (9, 8, N) planes, got {tuple(A9.shape)}")
    N = A9.shape[2]
    _lib.check_cuda("A9", A9, torch.float32, device=A9.device, align=4)
    f = torch.empty((9, N), dtype=torch.float32, device=A9.device)
    _lib.launch(
        "nullspace", "dim_nullspace_8x9", A9.device.index, A9.data_ptr(),
        f.data_ptr(), N, _lib.stream_of(A9),
    )
    return f


def nullspace_8x9(A: torch.Tensor) -> torch.Tensor:
    """Adapter for (..., 8, 9) constraint stacks -> (..., 9) null vectors."""
    batch = A.shape[:-2]
    planes = A.reshape(-1, 8, 9).permute(2, 1, 0).contiguous()  # (9, 8, N)
    return nullspace_planes(planes).T.reshape(*batch, 9)
