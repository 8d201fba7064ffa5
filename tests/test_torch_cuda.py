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
from deep_image_matching_tpu_torch.ops import bidir_attention as tbidir
from deep_image_matching_tpu_torch.ops import ffn as tffn
from deep_image_matching_tpu_torch.ops import nn as tnn
from deep_image_matching_tpu_torch.ops import nullspace as tnull
from deep_image_matching_tpu_torch.ops import qkv as tqkv
from deep_image_matching_tpu_torch.ops import ransac as transac
from deep_image_matching_tpu_torch.ops import refiner as trefiner
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


def _within_two_ulps(got, ref, mask):
    """Two bf16 ulps elementwise on the rows ``mask`` (B, T) keeps: the
    output's rounding and the probabilities', which the kernel rounds before
    normalising and the plain version after."""
    rows = mask[:, None, :, None].expand_as(got)
    got, ref = got.float(), ref.float()
    return bool(((got - ref).abs()[rows] <= 2.0 ** -6 * ref.abs()[rows].clamp(min=1.0)).all())


# the float32 forms' bounds, relative to the output's largest magnitude (the
# CPU models' tolerances, tests/test_torch_attention_tiles.py and
# tests/test_torch_f32_tiles.py): attention's f32 scores carry ~1e-6 relative
# rounding, which exp() turns into a few 1e-6 of the output; the FFN's and
# the QKV prologue's split-TF32 products stay within 1e-5
F32_ATTENTION_TOL = 5e-5
F32_PRODUCT_TOL = 1e-5
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _within_f32(got, ref, tol, mask=None):
    """|got - ref| <= tol max|ref| over the rows ``mask`` (B, T) keeps."""
    if mask is not None:
        rows = mask[:, None, :, None].expand_as(got)
        got, ref = got[rows], ref[rows]
    return float((got - ref).abs().max()) <= tol * float(ref.abs().max())


def _middle_tile_masks(gen, B, N, cuda):
    """Random non-prefix masks; in element 0 the second 128-key tile is
    masked whole (the kernels skip it), element 1 keeps every key."""
    m = torch.rand(B, N, generator=gen) < 0.7
    m[0, 128:256] = False
    m[1] = True
    return m.to(cuda)


# (B, H, Tq, Tk, masks): ragged against the 128-row tiles, fewer than 64
# queries, DINOv2's unmasked ragged 1601 tokens at 16 heads, and a non-prefix
# key mask with a fully masked 128-key tile in the middle
ATTENTION_CASES = {
    "ragged": (2, 4, 300, 131, "prefix"),
    "short": (2, 4, 40, 200, "prefix"),
    "dinov2": (2, 16, 1601, 1601, None),
    "middle_tile": (3, 4, 300, 520, "middle"),
}


@pytest.mark.parametrize("case", list(ATTENTION_CASES))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_kernel_matches_plain(cuda, nan_shared, dtype, case):
    """Both forms; the float32 one with NaN left in shared memory before it,
    so that padding it never writes would show."""
    B, H, N, M, masks = ATTENTION_CASES[case]
    gen = torch.Generator().manual_seed(1)
    dt = DTYPES[dtype]
    q, k, v = (torch.randn(B, H, n, 64, generator=gen).to(cuda, dt) for n in (N, M, M))
    qm = km = None
    if masks == "prefix":
        qm = _prefix_masks(gen, B, N, 10).to(cuda)
        km = _prefix_masks(gen, B, M, 10).to(cuda)
        km[1] = False  # every key masked: the uniform average of all keys
    elif masks == "middle":
        qm = _prefix_masks(gen, B, N, 10).to(cuda)
        km = _middle_tile_masks(gen, B, M, cuda)
        qm[2, :] = False  # every query masked: the kernel writes zeros
    counter = "attention" if dtype == "bf16" else "attention_f32"
    if dtype == "f32":
        nan_shared()
    before = _lib.LAUNCHES[counter]
    got = tattn.fused_attention(q, k, v, qm, km, 0.125)
    assert _lib.LAUNCHES[counter] == before + 1
    ref = tattn.attention_reference(q, k, v, km, 0.125)
    rows = qm if qm is not None else torch.ones(B, N, dtype=torch.bool, device=cuda)
    assert got.dtype == dt
    if dtype == "bf16":
        assert _within_two_ulps(got, ref, rows)
    else:
        assert _within_f32(got, ref, F32_ATTENTION_TOL, rows)
    if masks == "prefix":  # the all-masked element: every key weighted alike
        mean = v[1].float().mean(1, keepdim=True).expand(H, N, 64)
        if dtype == "bf16":
            assert _within_two_ulps(got[1:2], mean[None].to(torch.bfloat16), rows[1:2])
        else:
            assert _within_f32(got[1:2], mean[None], F32_ATTENTION_TOL, rows[1:2])
    if masks == "middle":
        assert bool((got[2] == 0).all())


# head dim 96, LighterGlue's one head: (B, H, Tq, Tk, masks), ragged against
# the 64-row blocks and the 64- (bf16) / 32-key (f32) tiles
ATTENTION_HD96_CASES = {
    "ragged": (2, 1, 300, 131, "prefix"),
    "short": (2, 1, 40, 200, "prefix"),
    "lighterglue": (2, 1, 1024, 1024, "prefix"),
    "middle_tile": (3, 2, 300, 520, "middle"),
}


@pytest.mark.parametrize("case", list(ATTENTION_HD96_CASES))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_hd96_kernel_matches_plain(cuda, nan_shared, dtype, case):
    """Kernel 1's head-dim-96 forms (``attention_mma``) against the plain
    version on valid query rows: partial masks, a batch element whose keys
    are all masked (the uniform average) and one whose queries are all
    masked (zeros); NaN left in shared memory before each, so that padding
    the kernel never writes would show."""
    B, H, N, M, masks = ATTENTION_HD96_CASES[case]
    gen = torch.Generator().manual_seed(3)
    dt = DTYPES[dtype]
    q, k, v = (torch.randn(B, H, n, 96, generator=gen).mul(s).to(cuda, dt)
               for n, s in ((N, 2.0), (M, 2.0), (M, 1.0)))
    qm = _prefix_masks(gen, B, N, 10).to(cuda)
    if masks == "prefix":
        km = _prefix_masks(gen, B, M, 10).to(cuda)
        km[1] = False
    else:
        km = _middle_tile_masks(gen, B, M, cuda)
        qm[2, :] = False
    counter = "attention_hd96" if dtype == "bf16" else "attention_hd96_f32"
    nan_shared()
    before = _lib.LAUNCHES[counter]
    scale = 96 ** -0.5
    got = tattn.fused_attention(q, k, v, qm, km, scale)
    assert _lib.LAUNCHES[counter] == before + 1
    ref = tattn.attention_reference(q, k, v, km, scale)
    assert got.dtype == dt and got.shape == q.shape
    if dtype == "bf16":
        assert _within_two_ulps(got, ref, qm)
    else:
        assert _within_f32(got, ref, F32_ATTENTION_TOL, qm)
    if masks == "prefix":
        mean = v[1].float().mean(1, keepdim=True).expand(H, N, 96)
        if dtype == "bf16":
            assert _within_two_ulps(got[1:2], mean[None].to(torch.bfloat16), qm[1:2])
        else:
            assert _within_f32(got[1:2], mean[None], F32_ATTENTION_TOL, qm[1:2])
    else:
        assert bool((got[2] == 0).all())


def test_attention_refuses_other_head_dims(cuda):
    for d in (32, 80, 128):
        q = torch.zeros(1, 1, 16, d, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dim 64 or 96"):
            tattn.fused_attention(q, q, q, None, None, 0.1)


# (B, K): fewer rows than one 64-row tile, a ragged last tile (231 rows),
# and SuperGlue's 16 x 4096 rows
FFN_CASES = {"short": (1, 40), "ragged": (3, 77), "superglue": (16, 4096)}


@pytest.mark.parametrize("case", list(FFN_CASES))
@pytest.mark.parametrize("mode", ["ln_gelu", "relu"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ffn_kernel_matches_plain(cuda, nan_shared, dtype, mode, case):
    gen = torch.Generator().manual_seed(3)
    (B, K), D = FFN_CASES[case], 256
    dt = DTYPES[dtype]

    def rnd(*shape, s=1.0, mean=0.0):
        return (mean + s * torch.randn(*shape, generator=gen)).to(cuda, dt)

    args = (rnd(B, K, D), rnd(B, K, D), rnd(2 * D, 2 * D, s=(2 * D) ** -0.5),
            rnd(2 * D, s=0.1), rnd(2 * D, s=0.1, mean=1.0), rnd(2 * D, s=0.1),
            rnd(D, 2 * D, s=(2 * D) ** -0.5), rnd(D, s=0.1))
    counter = "ffn" if dtype == "bf16" else "ffn_f32"
    if dtype == "f32":
        nan_shared()
    before = _lib.LAUNCHES[counter]
    got = tffn.ffn_fused(*args, mode=mode)
    assert _lib.LAUNCHES[counter] == before + 1
    assert got.dtype == dt
    got, ref = got.float(), tffn.ffn_reference(*args, mode=mode).float()
    if dtype == "f32":
        assert _within_f32(got, ref, F32_PRODUCT_TOL)
    else:
        # one bf16 ulp of the output
        assert bool(((got - ref).abs() <= 2.0 ** -7 * ref.abs().clamp(min=1.0) + 1e-6).all())


# (B, M, N, masks): ragged against the 128 x 128 tiles with planted matches
# (argmax held exactly), scattered masks as LightGlue's pruning leaves them, a
# fully masked tile in the middle of both sides, one element whose side 1 is
# all masked, and ALIKED's 4096 points
ASSIGNMENT_CASES = {
    "ragged": (2, 300, 200, "prefix"),
    "ragged_131": (2, 300, 131, "prefix"),
    "scattered": (2, 520, 400, "scattered"),
    "middle_tile": (3, 300, 520, "middle"),
    "masked_side": (2, 256, 300, "side"),
    "aliked": (2, 4096, 4096, "prefix"),
    "width96_ragged": (2, 300, 131, "prefix"),
    "lighterglue": (2, 4096, 4096, "prefix"),
}
# LighterGlue's assignment runs at width 96; the others at LightGlue's 256
ASSIGNMENT_WIDTHS = {"width96_ragged": 96, "lighterglue": 96}


@pytest.mark.parametrize("case", list(ASSIGNMENT_CASES))
def test_assignment_kernel_matches_plain(cuda, case):
    gen = torch.Generator().manual_seed(6)
    B, M, N, masks = ASSIGNMENT_CASES[case]
    D = ASSIGNMENT_WIDTHS.get(case, 256)
    md0 = (torch.randn(B, M, D, generator=gen) / 4).to(cuda)
    md1 = (torch.randn(B, N, D, generator=gen) / 4).to(cuda)
    md1[:, :100] = md0[:, :100] + 0.01 * torch.randn(B, 100, D, generator=gen).to(cuda)
    z0 = torch.randn(B, M, generator=gen).to(cuda)
    z1 = torch.randn(B, N, generator=gen).to(cuda)
    if masks == "scattered":
        m0, m1 = (torch.rand(B, n, generator=gen) < 0.6 for n in (M, N))
    else:
        low0, low1 = (150, 150) if case == "ragged" else (M // 2, N // 2)
        m0 = _prefix_masks(gen, B, M, low0)
        m1 = _prefix_masks(gen, B, N, low1)
    if masks == "middle":
        m0[0, 128:256] = False
        m1[0, 256:512] = False
        m1[1, 256:384] = False
    if masks == "side":
        m1[1] = False
    m0, m1 = m0.to(cuda), m1.to(cuda)
    args = (md0, md1, z0, z1, m0, m1)
    before = _lib.LAUNCHES["assignment"]
    got = tassign.assignment_fused(*args)
    assert _lib.LAUNCHES["assignment"] == before + 2  # one per pass
    ref = tassign.assignment_reference(*args)
    # the side-1-masked element: its valid rows come out as the Pallas
    # kernels leave them (max logsigmoid(z0) at index 0), not as the dense
    # -1e30; its columns are all masked
    keep0 = m0 & m1.any(1, keepdim=True)
    # split-TF32 products, f32-level, summed in another order than the dense one
    assert float((got[0] - ref[0]).abs()[keep0].max()) < 1e-3
    assert float((got[2] - ref[2]).abs()[m1].max()) < 1e-3
    if masks == "side":
        ls0 = torch.nn.functional.logsigmoid(z0[1])
        assert bool((got[0][1] - ls0).abs()[m0[1]].max() < 1e-6)
        assert bool((got[1][1][m0[1]] == 0).all())
    if case == "ragged":
        assert bool((got[1] == ref[1])[m0].all()) and bool((got[3] == ref[3])[m1].all())
    else:
        # argmax: equal, or a near-tie whose dense score is within 1e-4 of the max
        scores = tassign.log_assignment_dense(*args)
        s0 = torch.gather(scores, 2, got[1].long()[..., None])[..., 0]
        s1 = torch.gather(scores, 1, got[3].long()[:, None, :])[:, 0, :]
        assert bool(((got[1] == ref[1]) | ((ref[0] - s0).abs() <= 1e-4))[keep0].all())
        assert bool(((got[3] == ref[3]) | ((ref[2] - s1).abs() <= 1e-4))[m1].all())
    if case == "ragged":
        # ties keep the first index, in rows and in columns: rows 0 and 1 of
        # a and columns 0 and 1 of b are equal
        a = torch.tensor([1.0, 1.0, 0.2], device=cuda)[None, :, None].repeat(1, 1, 16)
        before = _lib.LAUNCHES["assignment"]
        _, row_arg, _, col_arg = tassign._pass(a, a, torch.zeros(1, 3, device=cuda),
                                               torch.zeros(1, 3, device=cuda), 1.0, True)
        assert _lib.LAUNCHES["assignment"] == before + 1
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


def _masked_couplings(gen, B, M, N, cuda):
    """Random prefix masks per batch element with the last row and column
    (the dustbins) kept; element 1 loses a row and a column in the middle
    (fully masked), element 2, where there is one, is masked whole."""
    m0 = torch.arange(M)[None] < torch.randint(1, M + 1, (B,), generator=gen)[:, None]
    m1 = torch.arange(N)[None] < torch.randint(1, N + 1, (B,), generator=gen)[:, None]
    m0[:, -1] = True
    m1[:, -1] = True
    if B > 1:
        m0[1, M // 2] = False
        m1[1, N // 2] = False
    if B > 2:
        m0[2] = False
        m1[2] = False
    z = torch.randn(B, M, N, generator=gen) * 3
    z = torch.where(m0[:, :, None] & m1[:, None, :], z, torch.tensor(-1e30))
    norm = -torch.log((m0.sum(1) + m1.sum(1)).clamp(min=1).float())[:, None]
    log_mu = torch.where(m0, norm, torch.tensor(-1e30))
    log_nu = torch.where(m1, norm, torch.tensor(-1e30))
    return z.to(cuda), log_mu.to(cuda), log_nu.to(cuda)


# (B, M, N): row widths N = 1, 2, 3 and 0 (mod 4), so a chunk's start is not
# 16-byte aligned for the bulk copy; a single row (fewer than one two-row
# stage); runs of rows per block that are not a multiple of the stage's
# rows; enough batch elements for one block per element; a width whose
# column count is an instantiated one (SuperGlue's 4097) and one rounded up
# to the next; rows so wide that the ring takes one-row stages; and rows
# wider than the widest register instantiation (10240), whose column
# accumulators live in global memory
SINKHORN_CASES = {
    "n_mod1": (2, 301, 257),
    "n_mod2": (3, 130, 258),
    "n_mod3": (3, 77, 259),
    "n_mod0": (2, 64, 256),
    "one_row": (2, 1, 203),
    "ragged_rows": (3, 1000, 131),
    "one_block_per_element": (140, 9, 37),
    "exact_columns": (2, 33, 4097),
    "columns_rounded_up": (2, 40, 3001),
    "wide_one_row_stages": (2, 7, 10001),
    "wider_than_registers": (2, 7, 12289),
    "wider_than_registers_16001": (2, 5, 16001),
}


@pytest.mark.parametrize("case", list(SINKHORN_CASES))
def test_sinkhorn_kernel_matches_plain(cuda, case):
    B, M, N = SINKHORN_CASES[case]
    gen = torch.Generator().manual_seed(11)
    z, log_mu, log_nu = _masked_couplings(gen, B, M, N, cuda)
    v = torch.randn(B, N, generator=gen).to(cuda)
    before = _lib.LAUNCHES["sinkhorn"]
    u1, v1 = tsink.sinkhorn_iteration(z, v, log_mu, log_nu)
    assert _lib.LAUNCHES["sinkhorn"] == before + 1
    ru, rv = tsink.sinkhorn_iteration_reference(z, v, log_mu, log_nu)
    assert float((u1 - ru).abs().max()) < 1e-4 and float((v1 - rv).abs().max()) < 1e-4
    u, v = tsink.sinkhorn_fused(z, log_mu, log_nu, 50)
    assert _lib.LAUNCHES["sinkhorn"] == before + 51
    cu, cv = tsink.sinkhorn_fused(z.cpu(), log_mu.cpu(), log_nu.cpu(), 50)
    assert float((u.cpu() - cu).abs().max()) < 1e-3 and float((v.cpu() - cv).abs().max()) < 1e-3
    if case == "wider_than_registers_16001":  # two one-row stages no longer fit
        n = 30000
        row, col = torch.zeros(1, n, device=cuda), torch.zeros(1, 2, device=cuda)
        with pytest.raises(RuntimeError, match="CUDA error"):
            tsink.sinkhorn_iteration(torch.zeros(1, 2, n, device=cuda), row, col, row)


def test_lse_rows_kernel_matches_plain(cuda):
    gen = torch.Generator().manual_seed(12)
    z, log_mu, _ = _couplings(gen, 2, 130, 1000, cuda)
    v = torch.randn(2, 1000, generator=gen).to(cuda)
    got = tsink.logsumexp_rows(z, v, log_mu)
    ref = tsink.logsumexp_rows_reference(z, v, log_mu)
    assert bool(((got - ref).abs() <= 1e-5 * ref.abs().clamp(min=1.0)).all())


# (B, H, W, C, N): C = 5, 6 and 13 take the plain-load instantiation (a TMA
# box needs C % 4 == 0; 5 and 13 pad K of the 1x1 to 8 and 16), 24 (RoMa's
# scale 1) its own TMA one and 64 the run-time-C TMA one; N = 1, 3, 9 and 10;
# H and W ragged against the strips and bands, or below the 4-pixel halo;
# RoMa's coarse pass
REFINER_CASES = {
    "c6_n3_ragged": (2, 21, 45, 6, 3),
    "c5_n3_ragged": (2, 21, 45, 5, 3),
    "c13_n9_ragged": (2, 19, 77, 13, 9),
    "c24_n3_ragged": (2, 21, 45, 24, 3),
    "c24_n10_ragged": (2, 37, 101, 24, 10),
    "c64_n9_ragged": (2, 29, 33, 64, 9),
    "c24_n1": (1, 17, 50, 24, 1),
    "c6_n10_below_halo": (2, 3, 70, 6, 10),
    "c24_n9_below_halo": (2, 40, 5, 24, 9),
    "c64_n3_tiny": (1, 2, 3, 64, 3),
    "roma_560_n9": (2, 560, 560, 24, 9),
}

FILL_SHARED = r"""
extern "C" __global__ void fill_shared(unsigned word, int words) {
  extern __shared__ unsigned s[];
  for (int i = threadIdx.x; i < words; i += blockDim.x) s[i] = word;
}
extern "C" int fill_all_shared(unsigned word) {
  int dev = 0, sms = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncSetAttribute(fill_shared, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  fill_shared<<<4 * sms, 1024, bytes>>>(word, bytes / 4);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


@pytest.fixture(scope="module")
def nan_shared(tmp_path_factory):
    """A function that fills every SM's shared memory with 0xFFFFFFFF (a
    NaN), so that a kernel reading shared memory it never wrote sees NaN
    rather than whatever a passing test left there."""
    import ctypes
    import subprocess

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = tmp_path_factory.mktemp("fill_shared")
    (d / "fill.cu").write_text(FILL_SHARED)
    subprocess.run([_lib._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(d / "fill.so"), str(d / "fill.cu")],
                   check=True, capture_output=True)
    fill = ctypes.CDLL(str(d / "fill.so")).fill_all_shared
    fill.argtypes, fill.restype = [ctypes.c_uint], ctypes.c_int

    def run():
        torch.cuda.synchronize()
        assert fill(0xFFFFFFFF) == 0

    return run


@pytest.mark.parametrize("case", list(REFINER_CASES), ids=list(REFINER_CASES))
def test_refiner_kernel_matches_plain(cuda, nan_shared, case):
    B, H, W, C, N = REFINER_CASES[case]
    gen = torch.Generator().manual_seed(13)
    x = torch.randn(B, H, W, C, generator=gen).to(cuda)
    w1 = (0.3 * torch.randn(N, 5, 5, 1, C, generator=gen)).to(cuda)
    b1 = (0.1 * torch.randn(N, C, generator=gen)).to(cuda)
    w2 = (C ** -0.5 * torch.randn(N, 1, 1, C, C, generator=gen)).to(cuda)
    b2 = (0.1 * torch.randn(N, C, generator=gen)).to(cuda)
    nan_shared()
    before = _lib.LAUNCHES["refiner"]
    got = trefiner.refiner_dw_stack(x, w1, b1, w2, b2)
    assert _lib.LAUNCHES["refiner"] == before + N  # one launch per block
    ref = trefiner.refiner_dw_stack_reference(x, w1, b1, w2, b2)
    # f32 sums of 25 taps and C split-TF32 products in another order, over N
    # blocks
    assert float((got - ref).abs().max()) <= 1e-5 * max(float(ref.abs().max()), 1.0)


def test_refiner_kernel_refuses_65_channels(cuda):
    with pytest.raises(ValueError, match="channels"):
        trefiner.refiner_dw_stack(torch.zeros(1, 4, 4, 65, device=cuda),
                                  torch.zeros(1, 5, 5, 1, 65, device=cuda),
                                  torch.zeros(1, 65, device=cuda),
                                  torch.zeros(1, 1, 1, 65, 65, device=cuda),
                                  torch.zeros(1, 65, device=cuda))


# (B, H, M, N, masks): ragged M != N against the 128-row tiles, fewer than
# 64 rows on one side, and non-prefix masks with a fully masked 128-column
# tile in the middle
BIDIR_CASES = {
    "ragged": (3, 4, 200, 130, "prefix"),
    "ragged_131": (3, 4, 300, 131, "prefix"),
    "short": (3, 4, 40, 600, "prefix"),
    "middle_tile": (3, 4, 520, 400, "middle"),
}


@pytest.mark.parametrize("case", list(BIDIR_CASES))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bidir_attention_kernel_matches_plain(cuda, nan_shared, dtype, case):
    """Partial masks, a fully masked row on one side and a fully masked
    batch element on the other (its outputs stay finite); both forms."""
    B, H, M, N, masks = BIDIR_CASES[case]
    gen = torch.Generator().manual_seed(15)
    dt = DTYPES[dtype]
    qk0, v0 = (torch.randn(B, H, M, 64, generator=gen).to(cuda, dt) for _ in range(2))
    qk1, v1 = (torch.randn(B, H, N, 64, generator=gen).to(cuda, dt) for _ in range(2))
    if masks == "prefix":
        m0 = _prefix_masks(gen, B, M, 10).to(cuda)
        m1 = _prefix_masks(gen, B, N, 10).to(cuda)
    else:
        m0 = _middle_tile_masks(gen, B, M, cuda)
        m1 = _middle_tile_masks(gen, B, N, cuda)
    m0[1, 5] = False
    m1[2] = False  # every side-1 token of element 2 masked
    counter = "bidir_attention" if dtype == "bf16" else "bidir_attention_f32"
    if dtype == "f32":
        nan_shared()
    before = _lib.LAUNCHES[counter]
    got = tbidir.bidir_cross_attention(qk0, qk1, v0, v1, m0, m1)
    assert _lib.LAUNCHES[counter] == before + 1
    ref = tbidir.bidir_cross_attention_reference(qk0, qk1, v0, v1, m0, m1)
    for g, r, m in zip(got, ref, (m0, m1)):
        assert g.dtype == dt
        if dtype == "bf16":
            assert _within_two_ulps(g, r, m)
        else:
            assert _within_f32(g, r, F32_ATTENTION_TOL, m)
        assert bool(torch.isfinite(g.float()).all())


# (B, N): fewer rows than one 128-row tile; 2 x 100 rows, whose tiles
# straddle two images; 3 x 300 rows, a ragged last tile and straddling tiles
QKV_CASES = {"short": (1, 40), "straddle": (2, 100), "ragged": (3, 300)}


@pytest.mark.parametrize("case", list(QKV_CASES))
@pytest.mark.parametrize("sections", [3, 2])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_qkv_kernel_matches_plain(cuda, nan_shared, dtype, sections, case):
    """Self mode (3 sections, rotary on q and k) and cross mode (2 sections,
    no rotary); both forms, the float32 one with f32 cos and sin."""
    gen = torch.Generator().manual_seed(16)
    (B, N), D, H = QKV_CASES[case], 256, 4
    dt = DTYPES[dtype]
    rot = (0, 1) if sections == 3 else ()
    x = torch.randn(B, N, D, generator=gen).to(cuda, dt)
    w = (torch.randn(sections * D, D, generator=gen) / 16).to(cuda, dt)
    b = (0.1 * torch.randn(sections * D, generator=gen)).to(cuda, dt)
    ang = torch.rand(B, N, 32, generator=gen) * 6.3
    cos = torch.repeat_interleave(torch.cos(ang), 2, -1).to(cuda)
    sin = torch.repeat_interleave(torch.sin(ang), 2, -1).to(cuda)
    counter = "qkv" if dtype == "bf16" else "qkv_f32"
    if dtype == "f32":
        nan_shared()
    before = _lib.LAUNCHES[counter]
    got = tqkv.proj_rotary_fused(x, w, b, cos, sin, H, sections, rot)
    assert _lib.LAUNCHES[counter] == before + 1
    ref = tqkv.proj_rotary_reference(x, w, b, cos, sin, H, sections, rot)
    if dtype == "f32":
        for g, r in zip(got, ref):
            assert g.shape == (B, H, N, 64) and g.dtype == dt
            assert _within_f32(g, r, F32_PRODUCT_TOL)
        return
    y = tqkv.proj_rotary_reference(x.float(), w, b, None, None, H, sections, ())
    equal = 0.0
    for g, r, ys in zip(got, ref, y):
        assert g.shape == (B, H, N, 64)
        g, r = g.float(), r.float()
        # one bf16 ulp of each rounded operand: the f32 sums run in another
        # order, so a rounding of t may fall on the other side
        bound = 2.0 ** -7 * (r.abs() + ys.abs() + tqkv.rotate_half(ys).abs())
        assert bool(((g - r).abs() <= bound).all())
        equal += float((g == r).float().mean()) / sections
    assert equal > 0.99


def _wrapper_calls(cuda, dt, mixed):
    """Each wrapper of a kernel with a bf16 and a float32 form, called on
    CUDA tensors of ``dt`` (the first operand f32 if ``mixed``)."""
    def t(*shape, first=False):
        return torch.zeros(*shape, device=cuda, dtype=torch.float32 if first and mixed else dt)

    m = torch.ones(1, 128, dtype=torch.bool, device=cuda)
    D = 256
    return {
        "attention": lambda: tattn.fused_attention(t(1, 4, 128, 64, first=True), t(1, 4, 128, 64),
                                                   t(1, 4, 128, 64), m, m, 0.125),
        "bidir_attention": lambda: tbidir.bidir_cross_attention(
            t(1, 4, 128, 64, first=True), t(1, 4, 128, 64), t(1, 4, 128, 64), t(1, 4, 128, 64),
            m, m),
        "ffn": lambda: tffn.ffn_fused(t(1, 128, D, first=True), t(1, 128, D), t(2 * D, 2 * D),
                                      t(2 * D), t(2 * D), t(2 * D), t(D, 2 * D), t(D)),
        "qkv": lambda: tqkv.proj_rotary_fused(t(1, 128, D, first=True), t(3 * D, D), t(3 * D),
                                              t(1, 128, 64), t(1, 128, 64), 4),
    }


@pytest.mark.parametrize("wrapper", ["attention", "bidir_attention", "ffn", "qkv"])
def test_kernel_wrappers_refuse_other_dtypes(cuda, wrapper):
    """float16 operands, and bf16 operands beside an f32 one, raise on CUDA
    and name the two dtypes the kernel takes: no cast, no plain version."""
    before = dict(_lib.LAUNCHES)
    for dt, mixed in ((torch.float16, False), (torch.bfloat16, True)):
        with pytest.raises(ValueError, match="torch.bfloat16 or torch.float32"):
            _wrapper_calls(cuda, dt, mixed)[wrapper]()
    assert _lib.LAUNCHES == before


# -- reconstruction: bundle adjustment and the mapper on the card ------------


def _ba_scene(seed, n_cams=6, n_pts=600, f=900.0, k1=-0.05):
    """tests/test_sfm.py's scene on the port's geometry: ``n_cams`` cameras
    along x looking at points 6-12 m away, 640 x 480, (f, cx, cy, k1)."""
    import numpy as np

    from deep_image_matching_tpu_torch.sfm import geometry as G

    rng = np.random.default_rng(seed)
    intr = np.array([f, 320.0, 240.0, k1])
    X = rng.uniform([-3, -3, 6], [3, 3, 12], (n_pts, 3))
    poses = []
    for i in range(n_cams):
        rv = rng.normal(0, 0.08, 3)
        c = np.array([i * 0.8 - 2, rng.normal(0, 0.2), rng.normal(0, 0.2)])
        poses.append(np.concatenate([rv, -G.rotvec_to_matrix(rv) @ c]))
    poses = np.array(poses)
    obs = [[], [], []]
    for i, p in enumerate(poses):
        uv, z = G.project_points(intr, G.rotvec_to_matrix(p[:3]), p[3:], X)
        idx = np.where((z > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < 640)
                       & (uv[:, 1] >= 0) & (uv[:, 1] < 480))[0]
        obs[0].append(np.full(len(idx), i))
        obs[1].append(idx)
        obs[2].append(uv[idx] + rng.normal(0, 0.4, (len(idx), 2)))
    return rng, intr, X, poses, [np.concatenate(o) for o in obs]


def test_bundle_adjust_on_cuda_matches_cpu(cuda):
    """The perturbed 6-camera scene: float64 cost traces (20 CG steps, where
    two summation orders still agree) card against CPU within 1e-3, and the
    float32 default solve on the card down to test_sfm.py's 0.8 px with the
    gauge pose held, and the same again bit for bit."""
    import numpy as np

    from deep_image_matching_tpu_torch.sfm import ba, geometry as G

    rng, intr, X, poses, (obs_pose, obs_pt, obs_uv) = _ba_scene(5)
    poses0 = poses + rng.normal(0, 0.02, poses.shape)
    poses0[0] = poses[0]
    X0 = X + rng.normal(0, 0.05, X.shape)
    pose_free = np.ones((len(poses), 6))
    pose_free[0] = 0
    pose_free[1, 3] = 0
    args = (poses0, np.array([[950.0, 320.0, 240.0, 0.0]]), X0, obs_pose,
            np.zeros_like(obs_pose), obs_pt, obs_uv, pose_free, np.array([[1.0, 0, 0, 1.0]]))
    kw = dict(n_lm_iters=30, n_cg_iters=20, dtype=np.float64)
    got, ref = ba.bundle_adjust(*args, **kw, device=cuda), ba.bundle_adjust(*args, **kw,
                                                                           device="cpu")
    n = min(len(got["costs"]), len(ref["costs"]))
    assert n >= 10
    np.testing.assert_allclose(got["costs"][:n], ref["costs"][:n], rtol=1e-3)
    out = ba.bundle_adjust(*args, n_lm_iters=30, n_cg_iters=30, device=cuda)
    sq = [np.sum((G.project_points(out["intr"][0], G.rotvec_to_matrix(p[:3]), p[3:],
                                   out["points"][obs_pt[obs_pose == i]])[0]
                  - obs_uv[obs_pose == i]) ** 2) for i, p in enumerate(out["poses"])]
    assert np.sqrt(np.sum(sq) / len(obs_pose)) < 0.8
    assert np.allclose(out["poses"][0], poses[0], atol=1e-6)
    again = ba.bundle_adjust(*args, n_lm_iters=30, n_cg_iters=30, device=cuda)
    for k in out:  # the segment sums add in a fixed order: the card repeats bit for bit
        assert np.array_equal(out[k], again[k]), k


def test_mapper_on_cuda_matches_ground_truth(cuda, tmp_path):
    """tests/test_sfm.py's 6-image mapper scene with BA on the card: every
    image registered, focal within 2 %, relative rotations within 0.5 deg."""
    import numpy as np

    from deep_image_matching_tpu_torch.io.colmap_db import COLMAPDatabase
    from deep_image_matching_tpu_torch.io.colmap_read_write_model import qvec2rotmat
    from deep_image_matching_tpu_torch.sfm import geometry as G
    from deep_image_matching_tpu_torch.sfm.incremental import native_incremental_mapping

    rng, intr, X, poses, _ = _ba_scene(6, n_pts=900, k1=0.0)
    db = COLMAPDatabase.connect(tmp_path / "database.db")
    db.create_tables()
    cam_id = db.add_camera(2, 640, 480, intr)
    vis_ids, img_ids = [], []
    for i, p in enumerate(poses):
        uv, z = G.project_points(intr, G.rotvec_to_matrix(p[:3]), p[3:], X)
        ids = np.where((z > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < 640)
                       & (uv[:, 1] >= 0) & (uv[:, 1] < 480))[0]
        ids = ids[rng.permutation(len(ids))]
        img_ids.append(db.add_image(f"img{i}.jpg", cam_id))
        db.add_keypoints(img_ids[-1], (uv[ids] + rng.normal(0, 0.4, (len(ids), 2)))
                         .astype(np.float32))
        vis_ids.append(ids)
    for i in range(len(poses)):
        for j in range(i + 1, min(i + 4, len(poses))):
            _, ia, ib = np.intersect1d(vis_ids[i], vis_ids[j], return_indices=True)
            m = np.stack([ia, ib], axis=1).astype(np.uint32)
            m = m[rng.random(len(m)) < 0.8]
            db.add_matches(img_ids[i], img_ids[j], m)
            db.add_two_view_geometry(img_ids[i], img_ids[j], m)
    db.commit()
    db.close()
    cameras, images, points3D = native_incremental_mapping(tmp_path / "database.db", tmp_path,
                                                           tmp_path, device=cuda)
    assert len(images) == len(poses) and len(points3D) > 500
    assert abs(cameras[cam_id].params[0] - intr[0]) / intr[0] < 0.02
    R = {im.name: qvec2rotmat(im.qvec) for im in images.values()}
    for i in range(len(poses)):
        for j in range(i + 1, len(poses)):
            Rg = G.rotvec_to_matrix(poses[j, :3]) @ G.rotvec_to_matrix(poses[i, :3]).T
            Rr = R[f"img{j}.jpg"] @ R[f"img{i}.jpg"].T
            assert np.degrees(np.linalg.norm(G.matrix_to_rotvec(Rr @ Rg.T))) < 0.5, (i, j)


def test_tile_cut_and_merge_on_cuda_match_cpu(cuda):
    """The tiled extraction's device steps (``ops/tile_merge.py``: the tile
    cut from one upload and the merge of the tiles' features) on the card
    against the CPU, bitwise: sorts, gathers and products by 0 or 1 only.
    Planted duplicates across tiles and tied scores exercise the dedup's and
    the cap's tie rules."""
    import numpy as np

    from deep_image_matching_tpu_torch.ops import tile_merge as tmerge
    from deep_image_matching_tpu_torch.utils.tiling import Tiler

    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (1000, 1500), np.uint8)
    origins, pad, hw = Tiler().tile_origins(img.shape, (600, 500), 10)
    starts = np.stack([origins[:, 1] + pad[0], origins[:, 0] + pad[2]], 1)
    cpu = tmerge.cut_tiles(torch.from_numpy(img), starts, hw, pad)
    gpu = tmerge.cut_tiles(torch.from_numpy(img).to(cuda), starts, hw, pad)
    assert torch.equal(gpu.cpu(), cpu)

    T, K = len(origins), 2048
    kpts = rng.uniform(0, 600, (T, K, 2)).astype(np.float32)
    kpts[1, :64] = kpts[0, :64] + (origins[0] - origins[1])
    scores = rng.uniform(0.1, 1.0, (T, K)).astype(np.float32)
    scores[2, :32] = scores[0, 0]
    args = [torch.from_numpy(a) for a in (
        kpts, scores, rng.normal(size=(T, K, 256)).astype(np.float32),
        rng.uniform(size=(T, K)) < 0.6, origins.astype(np.float32))]
    for cap in (1024, 8192):
        ref = tmerge.merge_tile_features(*args, (1500.0, 1000.0), cap)
        got = tmerge.merge_tile_features(*(a.to(cuda) for a in args), (1500.0, 1000.0), cap)
        for k in ref:
            assert torch.equal(got[k].cpu(), ref[k]), k


@pytest.mark.parametrize("D", [256, 128])
def test_nn_match_at_the_upright_probe_shapes(cuda, D):
    """The upright probe's batch: 4 rotations of 512 padded keypoints against
    the reference (SuperPoint's D = 256, ALIKED's 128), valid rows 30-100 %
    of the capacity as prefixes. ``nn_match_fused`` (kernel 5, two launches:
    forward and the mutual check) against the dense plain route on the CPU:
    the planted matches equal, other rows equal but for near-ties."""
    from deep_image_matching_tpu_torch.ops.nn_match import nn_match_batch

    gen = torch.Generator().manual_seed(20 + D)
    B, K = 4, 512
    F = torch.nn.functional
    d0 = F.normalize(torch.randn(B, K, D, generator=gen), dim=-1)
    d1 = F.normalize(torch.randn(B, K, D, generator=gen), dim=-1)
    perm = torch.randperm(K, generator=gen)[:K // 4]
    d1[:, perm] = F.normalize(d0[:, :K // 4] + 0.05 * torch.randn(B, K // 4, D, generator=gen),
                              dim=-1)
    counts0 = torch.tensor([K, int(0.3 * K), int(0.6 * K), int(0.9 * K)])
    counts1 = torch.tensor([int(0.3 * K), K, int(0.8 * K), int(0.45 * K)])
    m0 = torch.arange(K)[None] < counts0[:, None]
    m1 = torch.arange(K)[None] < counts1[:, None]
    before = _lib.LAUNCHES["nn"]
    got, got_valid = tnn.nn_match_fused(d0.to(cuda), d1.to(cuda), m0.to(cuda), m1.to(cuda))
    assert _lib.LAUNCHES["nn"] == before + 2
    ref, ref_valid = nn_match_batch(d0, d1, m0, m1)
    got, got_valid = got.cpu(), got_valid.cpu()
    planted = torch.zeros(B, K, dtype=torch.bool)
    planted[:, :K // 4] = (perm[None] < counts1[:, None]) & m0[:, :K // 4]
    assert int(ref_valid[planted].sum()) > 0
    assert torch.equal(got[planted], ref[planted])
    assert float((got == ref).float().mean()) >= 0.995
    assert not bool(got_valid[~m0].any())


@pytest.mark.parametrize("kind", ["netvlad", "cosplace", "dir", "tiny"])
def test_retrieval_descriptors_on_cuda_match_cpu(cuda, kind, tmp_path):
    """The retrieval networks at full width with seeded weights,
    ``compute_global_descriptors`` on the card (under ``full_f32``) against
    the CPU on the demo images: descriptors within 1e-4, the same top-2
    pairs but where two similarities tie within 1e-5 (random weights make
    the demo images' descriptors nearly equal)."""
    from pathlib import Path

    import numpy as np

    from deep_image_matching_tpu_torch import image_retrieval as tir
    from deep_image_matching_tpu_torch.models import retrieval as tr
    from deep_image_matching_tpu_torch.utils.image import ImageList

    torch.manual_seed(0)
    model = {"netvlad": lambda: tr.VGG16NetVLAD(pca_dim=4096),
             "cosplace": lambda: tr.ResNetGeM(tr.R18_STAGES, False, proj_dim=512),
             "dir": lambda: tr.ResNetGeM(tr.R101_STAGES, True, proj_dim=2048),
             "tiny": lambda: None}[kind]()
    if model is not None:
        model = model.eval()
    il = ImageList(Path(__file__).resolve().parents[1] / "notebooks" / "demo_project" / "images")
    cpu = tir.compute_global_descriptors(il, kind, device="cpu", model=model)
    gpu = tir.compute_global_descriptors(il, kind, device="cuda", model=model)
    assert float(abs(gpu - cpu).max()) <= 1e-4
    names, k = il.img_names, 2
    sim = cpu @ cpu.T
    np.fill_diagonal(sim, -np.inf)
    kth = np.sort(sim, axis=1)[:, ::-1][:, k - 1]
    idx = {n: i for i, n in enumerate(names)}
    differ = set(tir.pairs_from_descriptors(names, gpu, k)) ^ set(
        tir.pairs_from_descriptors(names, cpu, k))
    for x, y in differ:
        i, j = idx[x], idx[y]
        assert min(abs(sim[i, j] - kth[i]), abs(sim[i, j] - kth[j])) <= 1e-5, (x, y)
