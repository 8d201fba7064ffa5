"""Each CUDA kernel of the port against its plain PyTorch version, on the
card. Skipped on hosts without a CUDA device; the file imports no JAX, so
it also runs on GPU hosts without it:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import pytest
import torch

from deep_image_matching_tpu_torch.ops import _lib
from deep_image_matching_tpu_torch.ops import assignment as tassign
from deep_image_matching_tpu_torch.ops import attention as tattn
from deep_image_matching_tpu_torch.ops import ffn as tffn
from deep_image_matching_tpu_torch.ops import nn as tnn
from deep_image_matching_tpu_torch.ops import nullspace as tnull
from deep_image_matching_tpu_torch.ops import ransac as transac
from deep_image_matching_tpu_torch.ops import sinkhorn as tsink

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The first CUDA device; the test is skipped on hosts without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _prefix_masks(gen, B, N, low):
    counts = torch.randint(low, N + 1, (B,), generator=gen)
    counts[0] = N
    return torch.arange(N)[None] < counts[:, None]


def test_attention_kernel_matches_plain(cuda):
    gen = torch.Generator().manual_seed(1)
    B, H, N, M = 2, 4, 200, 150  # ragged against the 64-row tiles
    q, k, v = (torch.randn(B, H, n, 64, generator=gen).to(cuda, torch.bfloat16)
               for n in (N, M, M))
    qm = _prefix_masks(gen, B, N, 10).to(cuda)
    km = _prefix_masks(gen, B, M, 10).to(cuda)
    km[1] = False  # every key masked: the uniform average of all keys
    before = _lib.LAUNCHES["attention"]
    got = tattn.fused_attention(q, k, v, qm, km, 0.125).float()
    assert _lib.LAUNCHES["attention"] == before + 1
    ref = tattn.attention_reference(q, k, v, km, 0.125).float()
    rows = qm[:, None, :, None].expand_as(got)
    diff = (got - ref).abs()[rows]
    # two bf16 ulps: the output's rounding and the probabilities' rounding
    assert bool((diff <= 2.0 ** -6 * ref.abs()[rows].clamp(min=1.0)).all())


@pytest.mark.parametrize("mode", ["ln_gelu", "relu"])
def test_ffn_kernel_matches_plain(cuda, mode):
    gen = torch.Generator().manual_seed(3)
    B, K, D = 3, 77, 256  # 231 rows: a partial 32-row tile

    def rnd(*shape, s=1.0, mean=0.0):
        return (mean + s * torch.randn(*shape, generator=gen)).to(cuda, torch.bfloat16)

    args = (rnd(B, K, D), rnd(B, K, D), rnd(2 * D, 2 * D, s=(2 * D) ** -0.5),
            rnd(2 * D, s=0.1), rnd(2 * D, s=0.1, mean=1.0), rnd(2 * D, s=0.1),
            rnd(D, 2 * D, s=(2 * D) ** -0.5), rnd(D, s=0.1))
    got = tffn.ffn_fused(*args, mode=mode).float()
    ref = tffn.ffn_reference(*args, mode=mode).float()
    # one bf16 ulp of the output
    assert bool(((got - ref).abs() <= 2.0 ** -7 * ref.abs().clamp(min=1.0) + 1e-6).all())


def test_assignment_kernel_matches_plain(cuda):
    gen = torch.Generator().manual_seed(6)
    B, M, N, D = 2, 300, 200, 256
    md0 = (torch.randn(B, M, D, generator=gen) / 4).to(cuda)
    md1 = (torch.randn(B, N, D, generator=gen) / 4).to(cuda)
    md1[:, :100] = md0[:, :100] + 0.01 * torch.randn(B, 100, D, generator=gen).to(cuda)
    z0 = torch.randn(B, M, generator=gen).to(cuda)
    z1 = torch.randn(B, N, generator=gen).to(cuda)
    m0 = _prefix_masks(gen, B, M, 150).to(cuda)
    m1 = _prefix_masks(gen, B, N, 150).to(cuda)
    got = tassign.assignment_fused(md0, md1, z0, z1, m0, m1)
    ref = tassign.assignment_reference(md0, md1, z0, z1, m0, m1)
    # f32 FMAs in another order than the dense product
    assert float((got[0] - ref[0]).abs()[m0].max()) < 1e-3
    assert float((got[2] - ref[2]).abs()[m1].max()) < 1e-3
    assert bool((got[1] == ref[1])[m0].all()) and bool((got[3] == ref[3])[m1].all())
    # ties keep the first index, in rows and in columns: rows 0 and 1 of a
    # and columns 0 and 1 of b are equal
    a = torch.tensor([1.0, 1.0, 0.2], device=cuda)[None, :, None].repeat(1, 1, 16)
    _, row_arg, _, col_arg = tassign._pass(a, a, torch.zeros(1, 3, device=cuda),
                                           torch.zeros(1, 3, device=cuda), 1.0, True)
    assert row_arg.tolist() == [[0, 0, 0]] and col_arg.tolist() == [[0, 0, 0]]


def test_nullspace_kernel_matches_plain(cuda):
    gen = torch.Generator().manual_seed(8)
    N = 1000
    p0 = torch.rand(N, 8, 2, generator=gen) * 2 - 1
    translated = (torch.arange(N) % 2 == 0)[:, None, None]  # f33 = 0 systems
    p1 = torch.where(translated, p0 + torch.rand(N, 1, 2, generator=gen) - 0.5,
                     torch.rand(N, 8, 2, generator=gen) * 2 - 1)
    A = transac._build_constraints(p0, p1)  # (N, 8, 9)
    A[::7] = 0.0  # all-zero systems stay finite
    planes = A.permute(2, 1, 0).contiguous().to(cuda)
    got = tnull.nullspace_planes(planes).cpu()
    ref = tnull.nullspace_reference(planes).cpu()
    assert bool(torch.isfinite(got).all())
    live = A.abs().amax((1, 2)) > 0
    res = torch.einsum("nrc,cn->nr", A, got).abs().amax(1)
    assert float(res[live].max()) < 1e-4
    generic = ~translated[:, 0, 0] & live
    dots = (got * ref).sum(0).abs()
    assert float((1 - dots[generic]).abs().max()) < 1e-4


def test_ransac_on_cuda_matches_cpu(cuda):
    """Exact two-view projections plus outliers; the same draws on both
    devices give the same inlier sets (kernel vs QR null vectors)."""
    import numpy as np

    rng = np.random.default_rng(9)
    B, M, n_in, iters = 2, 256, 200, 256
    Kmat = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    p0 = rng.uniform(0, 640, (B, M, 2)).astype(np.float32)
    p1 = rng.uniform(0, 640, (B, M, 2)).astype(np.float32)
    for b in range(B):
        a = rng.uniform(-0.2, 0.2)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        X = np.c_[rng.uniform(-2, 2, (n_in, 2)), rng.uniform(4, 8, n_in)]
        x0, x1 = (Kmat @ X.T).T, (Kmat @ (R @ X.T + [[0.5], [0.05], [0.1]])).T
        p0[b, :n_in], p1[b, :n_in] = x0[:, :2] / x0[:, 2:], x1[:, :2] / x1[:, 2:]
    p0, p1 = torch.from_numpy(p0), torch.from_numpy(p1)
    valid = torch.ones(B, M, dtype=torch.bool)
    u = torch.randint(0, M, (B, 8, iters), generator=torch.Generator().manual_seed(0))
    _, inl_cpu, _ = transac.ransac_fundamental_batch(p0, p1, valid, 1.0, iters, sample_u=u)
    _, inl_gpu, _ = transac.ransac_fundamental_batch(
        p0.to(cuda), p1.to(cuda), valid.to(cuda), 1.0, iters, sample_u=u.to(cuda))
    assert bool(inl_gpu.cpu()[:, :n_in].all())
    assert torch.equal(inl_gpu.cpu(), inl_cpu)


def test_nn_kernel_matches_plain(cuda):
    """Float descriptors: values within 1e-4, argmins equal away from
    near-ties; integer descriptors with planted duplicates: bitwise equal,
    at an unaligned capacity."""
    gen = torch.Generator().manual_seed(10)
    B, K0, K1, D = 2, 300, 250, 128
    d0 = torch.nn.functional.normalize(torch.randn(B, K0, D, generator=gen), dim=-1).to(cuda)
    d1 = torch.nn.functional.normalize(torch.randn(B, K1, D, generator=gen), dim=-1).to(cuda)
    sq1 = (d1 ** 2).sum(-1)
    sq1[:, 200:] += 1e12  # invalid reference rows
    before = _lib.LAUNCHES["nn"]
    got = tnn.nn_top2(d0, d1, sq1)
    assert _lib.LAUNCHES["nn"] == before + 1
    ref = tnn.nn_top2_reference(d0, d1, sq1)
    assert float((got[0] - ref[0]).abs().max()) < 1e-4
    assert float((got[1] - ref[1]).abs().max()) < 1e-4
    clear = (ref[1] - ref[0]) > 1e-3
    assert bool((got[2] == ref[2])[clear].all())

    for D in (32, 128):
        K = 1000
        q = torch.randint(0, 256, (B, K, D), generator=gen).float()
        r = torch.randint(0, 256, (B, K, D), generator=gen).float()
        r[:, 10:20] = q[:, :10]          # exact neighbours
        r[:, 20:30] = q[:, :10]          # ... attained twice: ties
        r[:, 500:] = r[:, :500]          # duplicated columns
        q, r = q.to(cuda), r.to(cuda)
        sq = (r ** 2).sum(-1)
        got = tnn.nn_top2(q, r, sq)
        ref = tnn.nn_top2_reference(q, r, sq)
        for a, b in zip(got, ref):
            assert torch.equal(a, b), D
        assert bool((got[0] == got[1])[:, :10].all())  # double minimum
        assert got[2][:, :10].tolist() == [list(range(10, 20))] * B
    with pytest.raises(ValueError, match="divisible by 16"):
        tnn.nn_top2(torch.zeros(1, 4, 24, device=cuda), torch.zeros(1, 4, 24, device=cuda),
                    torch.zeros(1, 4, device=cuda))


def _couplings(gen, B, M, N, cuda):
    z = torch.randn(B, M, N, generator=gen) * 3
    m0 = torch.arange(M)[None] < torch.tensor([M, M // 2])[:B, None]
    m1 = torch.arange(N)[None] < torch.tensor([N - 3, N])[:B, None]
    z = torch.where(m0[:, :, None] & m1[:, None, :], z, torch.tensor(-1e30))
    log_mu = torch.where(m0, -6.0, -1e30)
    log_nu = torch.where(m1, -6.0, -1e30)
    return z.to(cuda), log_mu.to(cuda), log_nu.to(cuda)


def test_sinkhorn_kernel_matches_plain(cuda):
    gen = torch.Generator().manual_seed(11)
    z, log_mu, log_nu = _couplings(gen, 2, 301, 257, cuda)
    v = torch.randn(2, 257, generator=gen).to(cuda)
    before = _lib.LAUNCHES["sinkhorn"]
    u1, v1 = tsink.sinkhorn_iteration(z, v, log_mu, log_nu)
    assert _lib.LAUNCHES["sinkhorn"] == before + 1
    ru, rv = tsink.sinkhorn_iteration_reference(z, v, log_mu, log_nu)
    assert float((u1 - ru).abs().max()) < 1e-4 and float((v1 - rv).abs().max()) < 1e-4
    u, v = tsink.sinkhorn_fused(z, log_mu, log_nu, 50)
    cu, cv = tsink.sinkhorn_fused(z.cpu(), log_mu.cpu(), log_nu.cpu(), 50)
    assert float((u.cpu() - cu).abs().max()) < 1e-3 and float((v.cpu() - cv).abs().max()) < 1e-3


def test_lse_rows_kernel_matches_plain(cuda):
    gen = torch.Generator().manual_seed(12)
    z, log_mu, _ = _couplings(gen, 2, 130, 1000, cuda)
    v = torch.randn(2, 1000, generator=gen).to(cuda)
    got = tsink.logsumexp_rows(z, v, log_mu)
    ref = tsink.logsumexp_rows_reference(z, v, log_mu)
    assert bool(((got - ref).abs() <= 1e-5 * ref.abs().clamp(min=1.0)).all())
