"""The tile algorithm of kernel 3 (csrc/assignment.cu, LightGlue's dual-softmax
assignment) against the JAX package's Pallas kernels in interpret mode, on the
CPU.

The CUDA kernel runs only on the card (tests/test_torch_cuda.py holds it
against its plain version there). What can be checked here is the arithmetic
and the algorithm it implements: each operand split into TF32 halves by bit
rounding, hi = rna_tf32(x) and lo = rna_tf32(x - hi); each product as
lo.hi + hi.lo + hi.hi in f32; 128 x 128 tiles with the row statistics online
across column tiles; the column statistics of each 64-row half as partials,
combined in row order; tiles whose rows or whose columns are all masked
skipped; masked rows and columns given the sentinels (0 for a logsumexp,
-1e30 at index 0 for a max). ``tiled_pass`` follows the kernel one tile at a
time; ``tiled_assignment`` chains its two passes as ``ops/assignment.py``
does.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from deep_image_matching_tpu.ops import pallas_assignment as jassign
from deep_image_matching_tpu_torch.ops import assignment as tassign

BM = BN = 128   # rows per block, columns per tile
HALF = 64       # rows per consumer warpgroup: one column partial each
NEG = -1e30
MASKED = -1e29  # a bias at or below it marks a masked row or column


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: f32 rounded to 10 mantissa bits, ties away from
    zero (the low 13 bits of the word cleared)."""
    bits = x.float().contiguous().numpy().view(np.uint32)
    return torch.from_numpy(((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32))


def split_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (B, M, D) . b (B, N, D)^T as the kernel's three TF32 products, with
    f32 sums."""
    ah, bh = rna_tf32(a), rna_tf32(b)
    al, bl = rna_tf32(a - ah), rna_tf32(b - bh)

    def mm(x, y):
        return torch.einsum("bmd,bnd->bmn", x, y)

    return (mm(al, bh) + mm(ah, bl)) + mm(ah, bh)


def tiled_pass(a, b, row_bias, col_bias, scale, argmax, skip=True):
    """One kernel pass: statistics over j of s_ij + col_bias_j for every row
    and over i of s_ij + row_bias_i for every column, s = scale * a . b^T
    (logsumexp, or max and first argmax). ``skip`` leaves out the tiles whose
    rows or whose columns are all masked, as the kernel does."""
    B, M, _ = a.shape
    N = b.shape[1]
    s = split_product(a, b) * scale
    halves = -(-M // HALF)
    row_val = torch.zeros(B, M)
    row_arg = torch.zeros(B, M, dtype=torch.int64)
    part_v = torch.full((B, halves, N), -torch.inf)
    part_a = torch.zeros(B, halves, N, dtype=torch.int64 if argmax else torch.float32)
    for bi in range(B):
        rb, cb = row_bias[bi], col_bias[bi]
        for r0 in range(0, M, BM):
            rows = slice(r0, min(r0 + BM, M))
            if skip and not bool((rb[rows] > MASKED).any()):
                continue  # neutral partials; the rows get the sentinels below
            run_max = torch.full((rows.stop - r0,), NEG)
            run_sum = torch.zeros(rows.stop - r0)
            run_arg = torch.zeros(rows.stop - r0, dtype=torch.int64)
            for c0 in range(0, N, BN):
                cols = slice(c0, min(c0 + BN, N))
                if skip and not bool((cb[cols] > MASKED).any()):
                    continue  # neutral partials (-inf, 0)
                t = s[bi, rows, cols]
                v = t + cb[cols]
                if argmax:  # strict '>' across tiles, the first index inside one
                    targ = torch.argmax(v, 1)
                    tmax = v.gather(1, targ[:, None])[:, 0]
                    better = tmax > run_max
                    run_max = torch.where(better, tmax, run_max)
                    run_arg = torch.where(better, targ + c0, run_arg)
                else:
                    m_new = torch.maximum(run_max, v.amax(1))
                    ssum = torch.exp(v - m_new[:, None]).sum(1)
                    run_sum = run_sum * torch.exp(run_max - m_new) + ssum
                    run_max = m_new
                for h in range(r0 // HALF, min(halves, r0 // HALF + 2)):
                    hr = slice(h * HALF, min(h * HALF + HALF, M))
                    u = s[bi, hr, cols] + rb[hr][:, None]
                    if argmax:
                        harg = torch.argmax(u, 0)
                        part_v[bi, h, cols] = u.gather(0, harg[None])[0]
                        part_a[bi, h, cols] = harg + hr.start
                    else:
                        hm = u.amax(0)
                        part_v[bi, h, cols] = hm
                        part_a[bi, h, cols] = torch.exp(u - hm).sum(0)
            if argmax:
                row_val[bi, rows], row_arg[bi, rows] = run_max, run_arg
            else:
                row_val[bi, rows] = run_max + torch.log(run_sum.clamp(min=1e-38))
    # the partials of each column in row order
    col_val = torch.full((B, N), NEG)
    col_arg = torch.zeros(B, N, dtype=torch.int64)
    if argmax:
        for k in range(halves):
            better = part_v[:, k] > col_val
            col_val = torch.where(better, part_v[:, k], col_val)
            col_arg = torch.where(better, part_a[:, k], col_arg)
    else:
        m = torch.maximum(col_val, part_v.amax(1))
        ssum = torch.zeros(B, N)
        for k in range(halves):
            ssum = ssum + part_a[:, k] * torch.exp(part_v[:, k] - m)
        col_val = m + torch.log(ssum.clamp(min=1e-38))
    # masked rows and columns: the sentinels
    sentinel = NEG if argmax else 0.0
    row_val[row_bias <= MASKED] = sentinel
    col_val[col_bias <= MASKED] = sentinel
    row_arg[row_bias <= MASKED] = 0
    col_arg[col_bias <= MASKED] = 0
    return row_val, row_arg if argmax else None, col_val, col_arg if argmax else None


def tiled_assignment(md0, md1, z0, z1, m0, m1, skip=True):
    """(max0, arg0, max1, arg1) through the kernel's two passes."""
    neg0 = torch.where(m0, 0.0, NEG)
    neg1 = torch.where(m1, 0.0, NEG)
    lse_row, _, lse_col, _ = tiled_pass(md0, md1, neg0, neg1, 1.0, False, skip)
    ls0, ls1 = F.logsigmoid(z0), F.logsigmoid(z1)
    g, arg0, h, arg1 = tiled_pass(md0, md1, -lse_row + ls0 + neg0, -lse_col + ls1 + neg1, 2.0,
                                  True, skip)
    return g - lse_row + ls0, arg0, h - lse_col + ls1, arg1


def _inputs(rng, B, M, N, D, kind):
    """LightGlue-like descriptors (scaled by D^-0.25, unit-variance scores)
    with planted matches, matchability logits and masks of ``kind``."""
    md0 = rng.normal(size=(B, M, D)).astype(np.float32) * D ** -0.25
    md1 = rng.normal(size=(B, N, D)).astype(np.float32) * D ** -0.25
    k = min(M, N) // 3
    md1[:, :k] = md0[:, :k] + 0.3 * D ** -0.25 * rng.normal(size=(B, k, D)).astype(np.float32)
    if kind == "ties":
        # exact ties (a repeated point) and near-ties, across and inside tiles
        md1[:, 200] = md1[:, 7]
        md1[:, 9] = md1[:, 8]
        md0[:, 150] = md0[:, 3]
        md1[:, 131] = md1[:, 5] + 1e-6 * rng.normal(size=(B, D)).astype(np.float32)
        md0[:, 140] = md0[:, 2] + 1e-6 * rng.normal(size=(B, D)).astype(np.float32)
    z0 = rng.normal(size=(B, M)).astype(np.float32)
    z1 = rng.normal(size=(B, N)).astype(np.float32)
    if kind in ("prefix", "ties", "side"):
        m0 = np.arange(M)[None] < rng.integers(M // 2, M + 1, size=B)[:, None]
        m1 = np.arange(N)[None] < rng.integers(N // 2, N + 1, size=B)[:, None]
        m0[0], m1[0] = True, True
    else:  # scattered, as LightGlue's pruning leaves them
        m0 = rng.random((B, M)) < 0.6
        m1 = rng.random((B, N)) < 0.6
    if kind == "middle":
        m0[0, BM:2 * BM] = False  # a fully masked row block
        m1[0, BN:2 * BN] = False  # a fully masked column tile
        m1[1, 2 * BN:3 * BN] = False
    if kind == "side":
        m1[1] = False  # every side-1 point of element 1 masked
    t = torch.from_numpy
    return t(md0), t(md1), t(z0), t(z1), t(m0), t(m1)


# (B, M, N, D, masks): prefix masks at ragged sizes, scattered (pruned) masks,
# fully masked middle tiles, one all-masked side, planted exact ties and
# near-ties, and LightGlue's width at 1024 points
ASSIGNMENT_CASES = {
    "prefix_ragged": (3, 300, 260, 64, "prefix"),
    "scattered": (2, 390, 300, 64, "scattered"),
    "middle_tile": (2, 400, 520, 64, "middle"),
    "masked_side": (2, 256, 300, 64, "side"),
    "ties": (2, 300, 260, 64, "ties"),
    "lightglue_width": (1, 1024, 1024, 256, "prefix"),
}


@pytest.mark.parametrize("case", list(ASSIGNMENT_CASES))
def test_tiled_assignment_matches_pallas_interpret(case):
    """Values within 1e-4 of the Pallas kernels on valid rows and columns;
    argmaxima equal but for near-ties, whose dense score is within 1e-4 of
    the row's (column's) maximum. The split arithmetic holds the argmax."""
    from jax.experimental.pallas import tpu as pltpu

    B, M, N, D, kind = ASSIGNMENT_CASES[case]
    args = _inputs(np.random.default_rng(11), B, M, N, D, kind)
    got = tiled_assignment(*args)
    with pltpu.force_tpu_interpret_mode():
        ref = [torch.from_numpy(np.array(r)) for r in
               jassign.assignment_fused(*(jnp.asarray(t.numpy()) for t in args))]
    m0, m1 = args[4], args[5]
    rows, cols = m0, m1 & m0.any(1, keepdim=True)
    assert float((got[0] - ref[0]).abs()[rows].max()) <= 1e-4
    assert float((got[2] - ref[2]).abs()[cols].max()) <= 1e-4
    scores = tassign.log_assignment_dense(*args)
    best0, best1 = scores.amax(2), scores.amax(1)
    at0 = scores.gather(2, got[1][..., None])[..., 0]
    at1 = scores.gather(1, got[3][:, None, :])[:, 0, :]
    same0 = got[1] == ref[1].long()
    same1 = got[3] == ref[3].long()
    assert bool((same0 | ((best0 - at0).abs() <= 1e-4))[rows].all())
    assert bool((same1 | ((best1 - at1).abs() <= 1e-4))[cols].all())
    # away from planted ties the argmaxima agree exactly
    if kind != "ties":
        assert bool(same0[rows].all()) and bool(same1[cols].all())


SKIP_CASES = ("prefix_ragged", "scattered", "middle_tile", "masked_side")


@pytest.mark.parametrize("case", SKIP_CASES)
def test_skipping_masked_tiles_is_exact(case):
    """Both passes give bitwise the same statistics, on every row and column,
    with and without the skipped tiles."""
    B, M, N, D, kind = ASSIGNMENT_CASES[case]
    md0, md1, z0, z1, m0, m1 = _inputs(np.random.default_rng(12), B, M, N, D, kind)
    m0[-1, :BM] = False  # the first row block of the last element masked whole
    a = tiled_assignment(md0, md1, z0, z1, m0, m1, skip=True)
    b = tiled_assignment(md0, md1, z0, z1, m0, m1, skip=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_tf32_split_keeps_f32_accuracy():
    """hi + lo holds x to 2^-21 of its magnitude, and the three products hold
    the f32 product to a few f32 ulps of the scores' scale."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(size=(1, 300, 256)).astype(np.float32) / 4)
    hi, lo = rna_tf32(x), rna_tf32(x - rna_tf32(x))
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((hi + lo) - x).abs().max() / x.abs().max()) <= 2.0 ** -21
    y = torch.from_numpy(rng.normal(size=(1, 200, 256)).astype(np.float32) / 4)
    exact = torch.einsum("bmd,bnd->bmn", x.double(), y.double())
    split = split_product(x, y).double()
    plain = torch.einsum("bmd,bnd->bmn", x, y).double()
    one_tf32 = torch.einsum("bmd,bnd->bmn", rna_tf32(x), rna_tf32(y)).double()
    assert float((split - exact).abs().max()) <= 4 * float((plain - exact).abs().max()) + 1e-6
    # a single TF32 product is three orders of magnitude further off
    assert float((one_tf32 - exact).abs().max()) > 100 * float((split - exact).abs().max())
