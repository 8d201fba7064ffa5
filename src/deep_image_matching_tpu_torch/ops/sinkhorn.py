"""Log-space Sinkhorn iterations for SuperGlue's optimal transport
(kernels 7 and 8).

``sinkhorn_iteration`` is one Gauss-Seidel iteration over couplings z
(B, M, N) f32:

    u_i = max(log_mu_i - lse_j(z_ij + v_j), -1e30)
    v_j = max(log_nu_j - lse_i(z_ij + u_i), -1e30)    (with the new u)

and ``logsumexp_rows`` the row pass alone without the clamp,
``u_i = log_mu_i - lse_j(z_ij + v_j)``. Every lse is ``m + log(max(s,
1e-38))`` with the running maxima of the Pallas kernels (the column maxima
and the rows of ``logsumexp_rows`` start at -1e30). For CUDA tensors they
launch the kernels of ``csrc/sinkhorn.cu``; for CPU tensors they run the
plain versions. ``sinkhorn_fused`` runs the iterations from u = v = 0 on
couplings of any shape: the kernel masks its ragged edges, so nothing is
padded, and its scratch is allocated once per call.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import _lib

_NEG = -1e30


def _lse(x: torch.Tensor, dim: int, floor: bool) -> torch.Tensor:
    """``m + log(max(sum(exp(x - m)), 1e-38))`` with m the maximum along
    ``dim`` (raised to -1e30 where ``floor``)."""
    m = x.amax(dim, keepdim=True)
    if floor:
        m = torch.clamp(m, min=_NEG)
    s = torch.exp(x - m).sum(dim, keepdim=True)
    return (m + torch.log(torch.clamp(s, min=1e-38))).squeeze(dim)


def logsumexp_rows_reference(z, v, log_mu) -> torch.Tensor:
    return log_mu - _lse(z + v[:, None, :], 2, floor=True)


def sinkhorn_iteration_reference(z, v, log_mu, log_nu) -> Tuple[torch.Tensor, torch.Tensor]:
    u = torch.clamp(log_mu - _lse(z + v[:, None, :], 2, floor=False), min=_NEG)
    v = torch.clamp(log_nu - _lse(z + u[:, :, None], 1, floor=True), min=_NEG)
    return u, v


def _check(z, vecs, z_align=4):
    B, M, N = z.shape
    dev = z.device
    _lib.check_cuda("z", z, torch.float32, (B, M, N), dev, align=z_align)
    for name, t, n in vecs:
        _lib.check_cuda(name, t, torch.float32, (B, n), dev, align=4)


def logsumexp_rows(z, v, log_mu) -> torch.Tensor:
    """(B, M) row potentials from z (B, M, N), v (B, N), log_mu (B, M)."""
    if not z.is_cuda:
        return logsumexp_rows_reference(z, v, log_mu)
    B, M, N = z.shape
    _check(z, (("v", v, N), ("log_mu", log_mu, M)))
    u = torch.empty_like(log_mu)
    _lib.launch("lse_rows", "dim_lse_rows", z.device.index, z.data_ptr(), v.data_ptr(),
                log_mu.data_ptr(), u.data_ptr(), B, M, N, _lib.stream_of(z))
    return u


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sinkhorn_scratch(z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's (B, G, N) partial column maxima and sums for couplings
    ``z``: G blocks per batch element, a few per element so that one wave
    fills the card, each folding its run of rows into column accumulators."""
    B, M, N = z.shape
    G = max(1, min(M, _sm_count(z.device.index) // B))
    part_max = torch.empty((B, G, N), dtype=torch.float32, device=z.device)
    return part_max, torch.empty_like(part_max)


def sinkhorn_iteration(z, v, log_mu, log_nu,
                       scratch: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u_new, v_new) from v in one read of z. On CUDA the kernel takes f32
    contiguous tensors, z 16-byte aligned, and raises on anything else, or
    when two rows of width N do not fit in shared memory (N above ~28900 on
    the H100). ``scratch`` (from ``sinkhorn_scratch``) is allocated here
    when not given."""
    if not z.is_cuda:
        return sinkhorn_iteration_reference(z, v, log_mu, log_nu)
    B, M, N = z.shape
    _check(z, (("v", v, N), ("log_mu", log_mu, M), ("log_nu", log_nu, N)), z_align=16)
    part_max, part_sum = scratch if scratch is not None else sinkhorn_scratch(z)
    if part_max.shape[::2] != (B, N) or part_sum.shape != part_max.shape:
        raise ValueError(f"scratch of shape {tuple(part_max.shape)} for couplings {(B, M, N)}")
    u_new = torch.empty_like(log_mu)
    v_new = torch.empty_like(log_nu)
    _lib.launch(
        "sinkhorn", "dim_sinkhorn_iteration", z.device.index, z.data_ptr(), v.data_ptr(),
        log_mu.data_ptr(), log_nu.data_ptr(), u_new.data_ptr(), v_new.data_ptr(),
        part_max.data_ptr(), part_sum.data_ptr(), B, M, N, part_max.shape[1],
        _lib.stream_of(z),
    )
    return u_new, v_new


def sinkhorn_fused(couplings, log_mu, log_nu, iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iters`` iterations from u = v = 0; returns (u, v). On CUDA the
    kernel's scratch is allocated once for all iterations."""
    couplings = couplings.float().contiguous()
    if couplings.is_cuda and couplings.data_ptr() % 16:
        couplings = couplings.clone()  # the kernel's bulk copies need 16-byte alignment
    log_mu = log_mu.float().contiguous()
    log_nu = log_nu.float().contiguous()
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    scratch = sinkhorn_scratch(couplings) if couplings.is_cuda else None
    for _ in range(iters):
        u, v = sinkhorn_iteration(couplings, v, log_mu, log_nu, scratch)
    return u, v
