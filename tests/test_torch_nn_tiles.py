"""The tile algorithm of kernel 5 (csrc/nn.cu, the nearest-neighbour top-2)
against the JAX package's Pallas kernel in interpret mode, on the CPU.

The CUDA kernel runs only on the card (tests/test_torch_cuda.py holds it
against its plain version there). What can be checked here is the arithmetic
and the algorithm it implements: each operand split into TF32 halves by bit
rounding (``_lib.tf32_split``, the split launch's plain version); each
product as lo.hi + hi.lo + hi.hi with f32 sums; 128-column tiles, in which
each of the four lanes of a quad folds its own 32 columns into a running
top-2 of the row in ascending column order; the quad's merge; the column
slices (small grids, wide descriptors) merged in any order. ``tiled_top2``
follows the kernel one tile at a time.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from deep_image_matching_tpu.ops import pallas_nn as jpnn
from deep_image_matching_tpu_torch.ops import _lib
from deep_image_matching_tpu_torch.ops import nn as tnn

BN = 128        # columns a tile
QUAD = 4        # lanes of a quad, which share a row
INF = 3.0e38
PAD_SQ = 1.0e12
H100_SMS = 132


def split_product(a: torch.Tensor, b: torch.Tensor, products: int = 3) -> torch.Tensor:
    """a (B, M, D) . b (B, N, D)^T from the TF32 halves of each: the kernel's
    three products (lo.hi + hi.lo + hi.hi) in f32, or hi.hi alone."""
    (ah, al), (bh, bl) = _lib.tf32_split(a), _lib.tf32_split(b)

    def mm(x, y):
        return torch.einsum("bmd,bnd->bmn", x, y)

    if products == 1:
        return mm(ah, bh)
    return (mm(al, bh) + mm(ah, bl)) + mm(ah, bh)


def merge_top2(m1, m2, a, n1, n2, nb):
    """The kernel's merge of two top-2 states: order-free, a tie of min1
    keeps the smaller index."""
    m2 = torch.minimum(torch.maximum(m1, n1), torch.minimum(m2, n2))
    a = torch.where(n1 < m1, nb, torch.where(m1 < n1, a, torch.minimum(a, nb)))
    return torch.minimum(m1, n1), m2, a


def tiled_top2(d0, d1, sq1, slices: int = 1, order=None, products: int = 3):
    """(min1, min2, arg) as the kernel computes them: the column tiles cut
    into ``slices`` slices of consecutive tiles (one block each), every
    lane's running top-2 over its columns, the quad's merge (lanes 1 apart,
    then 2), then the slices' partials merged in ``order``."""
    B, K0, _ = d0.shape
    K1 = d1.shape[1]
    Kn = -(-K1 // 128) * 128
    acc = split_product(d0.float(), d1.float(), products)
    dist = sq1.float()[:, None, :] - 2.0 * acc
    dist = F.pad(dist, (0, Kn - K1), value=PAD_SQ)  # zero descriptors, squared norm 1e12
    tiles = Kn // BN
    per = -(-tiles // slices)
    lanes = torch.arange(QUAD)
    parts = []
    for s in range(slices):
        m1 = torch.full((B, K0, QUAD), INF)
        m2 = torch.full((B, K0, QUAD), INF)
        a = torch.zeros((B, K0, QUAD), dtype=torch.int64)
        for t in range(s * per, min(tiles, (s + 1) * per)):
            for j in range(BN // 8):
                for e in range(2):
                    cols = t * BN + 8 * j + 2 * lanes + e  # lane q's next column
                    v = dist[:, :, cols]
                    lt = v < m1
                    m2 = torch.where(lt, m1, torch.minimum(m2, v))
                    a = torch.where(lt, cols.expand_as(a), a)
                    m1 = torch.where(lt, v, m1)
        for o in (1, 2):
            partner = lanes ^ o
            m1, m2, a = merge_top2(m1, m2, a, m1[..., partner], m2[..., partner], a[..., partner])
        parts.append((m1[..., 0], m2[..., 0], a[..., 0]))
    order = list(range(slices)) if order is None else order
    out = parts[order[0]]
    for s in order[1:]:
        out = merge_top2(*out, *parts[s])
    return out[0], out[1], out[2].int()


def pallas_top2(d0, d1, sq1):
    with pltpu.force_tpu_interpret_mode():
        out = jpnn.nn_top2(jnp.asarray(d0.numpy()), jnp.asarray(d1.numpy()),
                           jnp.asarray(sq1.numpy()))
    return [torch.from_numpy(np.array(o)) for o in out]


def _bytes(rng, B, K0, K1, D):
    """Byte-valued descriptors (SIFT, ORB) with exact neighbours, double
    minima and duplicated columns; the last 40 references invalid."""
    d0 = rng.integers(0, 256, (B, K0, D)).astype(np.float32)
    d1 = rng.integers(0, 256, (B, K1, D)).astype(np.float32)
    d1[:, 10:30] = d0[:, :20]
    d1[:, 150:160] = d0[:, :10]     # queries 0-9 reach their minimum twice, across tiles
    d1[:, 60:90] = d1[:, 40:70]     # duplicated columns
    d1[:, K1 - 40:] = 0.0
    sq1 = (d1 ** 2).sum(-1)
    sq1[:, K1 - 40:] += 1e12
    return torch.from_numpy(d0), torch.from_numpy(d1), torch.from_numpy(sq1.astype(np.float32))


def _floats(rng, B, K0, K1, D):
    """Unit-norm descriptors, a third of the queries with a near copy among
    the references, invalid references with the 1e12 offset."""
    d0 = rng.normal(size=(B, K0, D)).astype(np.float32)
    d1 = rng.normal(size=(B, K1, D)).astype(np.float32)
    k = K0 // 3
    d1[:, 50:50 + k] = d0[:, :k] + 0.3 * rng.normal(size=(B, k, D)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    m1 = np.arange(K1)[None] < np.array([K1, K1 - 70])[:B, None]
    d1 *= m1[..., None]
    sq1 = ((d1 ** 2).sum(-1) + np.where(m1, 0.0, 1e12)).astype(np.float32)
    return torch.from_numpy(d0), torch.from_numpy(d1), torch.from_numpy(sq1)


def _within_rule(got, ref):
    """check_nn's rule: min1 and min2 within 1e-4, argmins equal on >= 0.999
    of the rows and wherever min2 - min1 > 1e-3."""
    err = max(float((got[0] - ref[0]).abs().max()), float((got[1] - ref[1]).abs().max()))
    same = got[2] == ref[2].int()
    return (err <= 1e-4 and float(same.float().mean()) >= 0.999
            and bool(same[(ref[1] - ref[0]) > 1e-3].all()))


@pytest.mark.parametrize("D", [32, 128])
def test_tiled_top2_bitwise_on_bytes(D):
    """SIFT's and ORB's widths at an unaligned capacity (333 references, 3
    tiles): every output bitwise equal to the Pallas kernel's, with one slice
    and with a slice a tile."""
    d0, d1, sq1 = _bytes(np.random.default_rng(D), 2, 300, 333, D)
    ref = pallas_top2(d0, d1, sq1)
    for slices in (1, 3):
        got = tiled_top2(d0, d1, sq1, slices)
        for g, r in zip(got, ref):
            assert torch.equal(g, r.to(g.dtype)), slices
    assert torch.equal(got[0][:, :10], got[1][:, :10])          # double minima
    assert got[2][:, :10].tolist() == [list(range(10, 20))] * 2  # the smaller index


@pytest.mark.parametrize("D", [64, 256])
def test_tiled_top2_matches_pallas_on_floats(D):
    """LiftFeat's and SuperPoint's widths: the 1e-4 / argmin rule against the
    Pallas kernel, with the columns whole and split in 3 slices."""
    d0, d1, sq1 = _floats(np.random.default_rng(100 + D), 2, 200, 333, D)
    ref = pallas_top2(d0, d1, sq1)
    for slices in (1, 3):
        assert _within_rule(tiled_top2(d0, d1, sq1, slices), ref), slices


def test_merge_order_is_free():
    """Any order of the slices' merges, and any cut of the columns into
    slices, gives bitwise the same result (floats, with planted ties)."""
    d0, d1, sq1 = _floats(np.random.default_rng(7), 2, 130, 600, 64)
    d1[:, 400] = d1[:, 60]  # a double minimum across slices
    one = tiled_top2(d0, d1, sq1)
    for slices, order in ((5, [4, 2, 0, 3, 1]), (5, [1, 0, 4, 3, 2]), (3, [2, 1, 0]),
                          (2, [1, 0])):
        got = tiled_top2(d0, d1, sq1, slices, order)
        for g, r in zip(got, one):
            assert torch.equal(g, r), (slices, order)


def test_one_tf32_product_breaks_the_rule():
    """The split exists because a single TF32 product (hi.hi) moves min1 and
    min2 by more than 1e-4 on SuperPoint's unit-norm floats, where the three
    products hold them."""
    d0, d1, sq1 = _floats(np.random.default_rng(3), 2, 300, 400, 256)
    ref = pallas_top2(d0, d1, sq1)
    assert _within_rule(tiled_top2(d0, d1, sq1), ref)
    assert not _within_rule(tiled_top2(d0, d1, sq1, products=1), ref)


@pytest.mark.parametrize("shape", [(4, 512, 512, 256), (16, 4096, 4096, 128), (1, 300, 5000, 128),
                                   (3, 100, 260, 256), (16, 4096, 4096, 256),
                                   (16, 4096, 4096, 960)])
def test_column_slices(shape):
    """The wrapper's column split: as many slices as fill the SMs where the
    query blocks do not, at least ceil(D / 128) (the query tiles' L2 reuse),
    at most one a tile, none empty; equal slices of consecutive tiles."""
    B, K0, K1, D = shape
    blocks = B * -(-K0 // 128)
    tiles = -(-K1 // 128)
    slices = tnn.column_slices(B, K0, K1, D, H100_SMS)
    per = -(-tiles // slices)
    assert 1 <= slices <= tiles and (slices - 1) * per < tiles  # no slice is empty
    want = min(tiles, max(H100_SMS // blocks, -(-D // 128)))
    assert slices == -(-tiles // -(-tiles // want))  # the fewest tiles a slice that gives want
    assert slices >= want / 2
    expect = {(4, 512, 512, 256): 4, (16, 4096, 4096, 128): 1, (16, 4096, 4096, 256): 2,
              (16, 4096, 4096, 960): 8}
    if shape in expect:
        assert slices == expect[shape]
