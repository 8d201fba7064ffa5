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
padded.
"""

from __future__ import annotations

from typing import Tuple

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


def _check(z, vecs):
    B, M, N = z.shape
    dev = z.device
    _lib.check_cuda("z", z, torch.float32, (B, M, N), dev, align=4)
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


def sinkhorn_iteration(z, v, log_mu, log_nu) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u_new, v_new) from v in one read of z. On CUDA the kernel takes f32
    contiguous tensors and raises on anything else, or when one row of
    width N does not fit in shared memory (N above ~19000)."""
    if not z.is_cuda:
        return sinkhorn_iteration_reference(z, v, log_mu, log_nu)
    B, M, N = z.shape
    _check(z, (("v", v, N), ("log_mu", log_mu, M), ("log_nu", log_nu, N)))
    dev = z.device
    # a few blocks per batch, one wave on the card: each block walks its rows
    # and folds them into column accumulators in shared memory
    G = max(1, min(M, torch.cuda.get_device_properties(dev).multi_processor_count // B))
    u_new = torch.empty_like(log_mu)
    v_new = torch.empty_like(log_nu)
    part_max = torch.empty((B, G, N), dtype=torch.float32, device=dev)
    part_sum = torch.empty_like(part_max)
    _lib.launch(
        "sinkhorn", "dim_sinkhorn_iteration", dev.index, z.data_ptr(), v.data_ptr(),
        log_mu.data_ptr(), log_nu.data_ptr(), u_new.data_ptr(), v_new.data_ptr(),
        part_max.data_ptr(), part_sum.data_ptr(), B, M, N, G, _lib.stream_of(z),
    )
    return u_new, v_new


def sinkhorn_fused(couplings, log_mu, log_nu, iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iters`` iterations from u = v = 0; returns (u, v)."""
    couplings = couplings.float().contiguous()
    log_mu = log_mu.float().contiguous()
    log_nu = log_nu.float().contiguous()
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u, v = sinkhorn_iteration(couplings, v, log_mu, log_nu)
    return u, v
