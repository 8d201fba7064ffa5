"""The tile algorithm of the Hopper attention core (csrc/attention_sm90.cuh,
kernels 1 and 6) against the JAX package's dense references, on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py holds them
against their plain versions there). What can be checked here is the
algorithm they implement: 192-row query tiles and 128-key tiles (64-key
tiles at head dim 96, LighterGlue's), masks as
additive key (and row) biases, the scale folded into exp2, the running
maxima from -inf (kernel 1) or -1e30 (kernel 6), P rounded to bf16 before
the PV product, a key tile skipped when all its keys are masked and its
batch element has a valid key, all-masked query tiles written as zeros, and
kernel 6 as two recomputed directions. ``tiled_attention`` below follows the
kernel step by step in f32, one key tile at a time.

The float32 form (csrc/attention_f32_sm90.cuh) runs the same algorithm on
128-row query tiles and 64-key tiles (32-key tiles at head dim 96) with both
products in split TF32: each
operand split into TF32 halves by bit rounding (hi = rna_tf32(x), lo =
rna_tf32(x - hi)), each product lo.hi + hi.lo + hi.hi in f32, and P kept in
f32. ``tiled_attention(..., form="f32")`` models it; its P fragments meet V
in a permuted key order, which ``test_p_fragments_meet_the_permuted_values``
models lane by lane.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deep_image_matching_tpu.ops import attention as jattn
from deep_image_matching_tpu.ops import pallas_bidir_attention as jbidir

# the kernels' (query rows, keys) a tile, by form and head dim: the bf16
# core at D = 64 and D = 96 (attention_sm90.cuh's Geo), the float32 core
# (attention_f32_sm90.cuh's Geo; "tf32" models it with one product)
TILES = {("bf16", 64): (192, 128), ("bf16", 96): (192, 64),
         ("f32", 64): (128, 64), ("f32", 96): (128, 32)}
NEG = -1e30
# the float32 form's tolerance relative to max|out| over valid rows (f32
# scores of |s| up to ~16 carry ~1e-6 relative rounding in both versions,
# which exp() turns into output errors of a few 1e-6)
F32_TOL = 5e-5


def tiles(form, d):
    """The kernel's tiles for ``form`` at head dim ``d``."""
    return TILES["bf16" if form == "bf16" else "f32", d]


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: f32 rounded to 10 mantissa bits, ties away from
    zero (the low 13 bits of the word cleared)."""
    bits = x.float().contiguous().numpy().view(np.uint32)
    return torch.from_numpy(((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32))


def split_mm(eq: str, a: torch.Tensor, b: torch.Tensor, terms: str = "split") -> torch.Tensor:
    """einsum ``eq`` of a and b as the kernel's tensor-core products: "split"
    (lo.hi + hi.lo + hi.hi of the TF32 halves, f32 sums) or "tf32" (one
    product of the hi halves)."""
    ah, bh = rna_tf32(a), rna_tf32(b)
    if terms == "tf32":
        return torch.einsum(eq, ah, bh)
    al, bl = rna_tf32(a - ah), rna_tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + torch.einsum(eq, ah, bh)


def tiled_attention(q, k, v, q_mask, k_mask, scale, tile, row_bias=False, skip=True,
                    form="bf16"):
    """The kernel's arithmetic: (B, H, Nq, d) x (B, H, Nk, d) f32 tensors,
    (B, Nq) / (B, Nk) bool masks (None: all valid), ``tile`` = (query rows,
    keys) of a tile (``tiles(form, d)``). ``row_bias`` selects
    kernel 6 (rows of masked queries get -1e30, maxima start at -1e30, the
    output is over max(l, 1e-30)); else kernel 1 (maxima from -inf, output
    times 1/l). ``skip``: leave out all-masked key tiles as the kernel does.
    ``form``: "bf16" (f32 scores, P rounded to bf16), "f32" (both products
    in split TF32, P in f32) or "tf32" (one TF32 product each)."""
    bq, bk = tile
    B, H, Nq, d = q.shape
    Nk = k.shape[2]
    C = scale * math.log2(math.e)
    qm = torch.ones(B, Nq, dtype=torch.bool) if q_mask is None else q_mask
    km = torch.ones(B, Nk, dtype=torch.bool) if k_mask is None else k_mask
    kbias = torch.where(km, 0.0, NEG)
    qbias = torch.where(qm, 0.0, NEG)[:, None, :, None] if row_bias else 0.0
    any_k = km.any(1)
    m = torch.full((B, H, Nq, 1), NEG if row_bias else -math.inf)
    l = torch.zeros(B, H, Nq, 1)
    o = torch.zeros(B, H, Nq, d)
    for k0 in range(0, Nk, bk):
        keys = slice(k0, min(k0 + bk, Nk))
        # per batch element: the tile is processed unless all its keys are
        # masked while some key of the element is valid
        live = ~(skip & ~km[:, keys].any(1) & any_k)
        if form == "bf16":
            s = torch.einsum("bhid,bhjd->bhij", q, k[:, :, keys]) * C
        else:
            s = split_mm("bhid,bhjd->bhij", q, k[:, :, keys], form) * C
        s = s + kbias[:, None, None, keys] + qbias
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l_new = l * corr + p.sum(-1, keepdim=True)
        if form == "bf16":
            pv = torch.einsum("bhij,bhjd->bhid", p.to(torch.bfloat16).float(), v[:, :, keys])
        else:
            pv = split_mm("bhij,bhjd->bhid", p, v[:, :, keys], form)
        o_new = o * corr + pv
        sel = live[:, None, None, None]
        m, l, o = torch.where(sel, m_new, m), torch.where(sel, l_new, l), torch.where(sel, o_new, o)
    out = o / l.clamp(min=1e-30) if row_bias else o * (1.0 / l)
    # query tiles whose rows are all masked: zeros
    for q0 in range(0, Nq, bq):
        dead = ~qm[:, q0:q0 + bq].any(1)
        out[dead, :, q0:q0 + bq] = 0.0
    return out


def _bf16(rng, *shape):
    """Normal values that bf16 holds exactly, as f32."""
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16().float()


def _masks(rng, B, N, kind, bk=128):
    if kind == "none":
        return None
    if kind == "prefix":
        counts = rng.integers(10, N + 1, size=B)
        counts[0] = N
        m = np.arange(N)[None] < counts[:, None]
    else:  # random, with a fully masked bk-key tile in the middle of element 0
        m = rng.random((B, N)) < 0.7
        m[0, bk:2 * bk] = False
    return torch.from_numpy(m)


def _within_two_ulps(got, ref, rows):
    """Two bf16 ulps on valid rows, the kernels' bound on the card."""
    rows = rows[:, None, :, None].expand_as(got)
    return bool(((got - ref).abs()[rows] <= 2.0 ** -6 * ref.abs()[rows].clamp(min=1.0)).all())


# (Nq, Nk, query masks, key masks): ragged against both tile sizes, fewer
# than 64 queries, DINOv2's unmasked ragged length, a fully masked key tile
# in the middle, one key past the float32 form's 64-key tile
ATTENTION_CASES = {
    "ragged": (300, 131, "prefix", "prefix"),
    "short": (40, 200, "prefix", "prefix"),
    "unmasked_1601": (1601, 401, "none", "none"),
    "middle_tile": (300, 520, "prefix", "middle"),
    "tile_plus_one": (100, 65, "prefix", "prefix"),
}


def _attention_case(case, d, H, seed, form):
    """One case of ATTENTION_CASES through the tile model of ``form`` at
    head dim ``d`` and through xla_attention, on the same inputs (bf16
    values for the bf16 form): (model, reference, valid rows, query masks).
    Element 1's keys are all masked (the uniform average of all keys),
    element 2's queries all masked (zeros); a "middle" key mask masks one
    whole key tile of element 0."""
    Nq, Nk, qkind, kkind = ATTENTION_CASES[case]
    rng = np.random.default_rng(seed)
    B = 3
    rnd = _bf16 if form == "bf16" else _f32
    q, k, v = rnd(rng, B, H, Nq, d) * 2, rnd(rng, B, H, Nk, d) * 2, rnd(rng, B, H, Nk, d)
    tile = tiles(form, d)
    qm, km = _masks(rng, B, Nq, qkind), _masks(rng, B, Nk, kkind, bk=tile[1] if d != 64 else 128)
    if km is not None:
        km[1] = False  # every key masked: the uniform average of all keys
    if qm is not None:
        qm[2, :] = False  # every query masked: zeros
    scale = d ** -0.5
    got = tiled_attention(q, k, v, qm, km, scale, tile, form=form)
    ref = torch.from_numpy(np.array(jattn.xla_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
        None if km is None else jnp.asarray(km.numpy()), scale)))
    rows = torch.ones(B, Nq, dtype=torch.bool) if qm is None else qm
    return got, ref, rows, qm


@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_tiled_attention_matches_xla_attention(case):
    got, ref, rows, qm = _attention_case(case, 64, 2, 7, "bf16")
    assert _within_two_ulps(got, ref, rows)
    if qm is not None:
        assert bool((got[2] == 0).all())


def _skip_is_exact(d, form):
    """A key tile whose keys are all masked changes nothing for an element
    with a valid key, wherever it lies (also before the first valid tile):
    the tile model with and without the skip, on ``form``'s tiles at head
    dim ``d``, equal bit for bit."""
    rng = np.random.default_rng(8)
    B, H, N, M = 2, 2, 200, 640
    rnd = _bf16 if form == "bf16" else _f32
    q, k, v = rnd(rng, B, H, N, d), rnd(rng, B, H, M, d), rnd(rng, B, H, M, d)
    km = torch.from_numpy(rng.random((B, M)) < 0.5)
    tile = tiles(form, d)
    bk = tile[1]
    km[0, :2 * bk] = False       # the first two tiles of element 0 masked
    km[1, 3 * bk:4 * bk] = False  # a middle tile of element 1 masked
    for row_bias in (False, True):
        a = tiled_attention(q, k, v, None, km, 0.125, tile, row_bias=row_bias, skip=True,
                            form=form)
        b = tiled_attention(q, k, v, None, km, 0.125, tile, row_bias=row_bias, skip=False,
                            form=form)
        assert torch.equal(a, b)


def test_skipping_masked_key_tiles_is_exact():
    """A key tile whose keys are all masked changes nothing for an element
    with a valid key, wherever it lies (also before the first valid tile)."""
    _skip_is_exact(64, "bf16")


# head dim 96 (LighterGlue: one head of width 96) on the tiles of the cores
# at D = 96: 192 x 64 in bf16, 128 x 32 in split TF32

@pytest.mark.parametrize("case", list(ATTENTION_CASES))
@pytest.mark.parametrize("form", ["bf16", "f32"])
def test_tiled_attention_hd96_matches_xla_attention(form, case):
    """Kernel 1's head-dim-96 forms against the JAX package's dense
    attention: two bf16 ulps on valid rows (bf16), within 5e-5 of max|out|
    (split TF32); all-masked query tiles give zeros."""
    got, ref, rows, qm = _attention_case(case, 96, 1, 27, form)
    if form == "bf16":
        assert _within_two_ulps(got, ref, rows)
    else:
        assert _rel_err(got, ref, rows) <= F32_TOL
    if qm is not None:
        assert bool((got[2] == 0).all())


@pytest.mark.parametrize("form", ["bf16", "f32"])
def test_skipping_masked_key_tiles_is_exact_hd96(form):
    """The skip of all-masked key tiles at head dim 96, on the 64-key
    (bf16) and 32-key (split TF32) tiles."""
    _skip_is_exact(96, form)


BIDIR_CASES = {
    "ragged": (200, 130, "prefix"),
    "ragged_131": (300, 131, "prefix"),
    "short": (40, 600, "prefix"),
    "middle_tile": (520, 400, "middle"),
}


@pytest.mark.parametrize("case", list(BIDIR_CASES))
def test_tiled_bidir_matches_dense_reference(case):
    """Kernel 6 as two recomputed directions: side-0 rows against side-1
    keys over v1, side-1 rows against side-0 keys over v0, each with its
    row bias; a fully masked side stays finite, and a valid row against a
    fully masked side averages all of it as the reference does."""
    M, N, kind = BIDIR_CASES[case]
    rng = np.random.default_rng(9)
    B, H, d = 3, 2, 64
    qk0, v0 = _bf16(rng, B, H, M, d) * 2, _bf16(rng, B, H, M, d)
    qk1, v1 = _bf16(rng, B, H, N, d) * 2, _bf16(rng, B, H, N, d)
    m0, m1 = _masks(rng, B, M, kind), _masks(rng, B, N, kind)
    m0[1, 5] = False
    m1[2] = False  # every side-1 token of element 2 masked
    scale = d ** -0.5
    got0 = tiled_attention(qk0, qk1, v1, m0, m1, scale, tiles("bf16", d), row_bias=True)
    got1 = tiled_attention(qk1, qk0, v0, m1, m0, scale, tiles("bf16", d), row_bias=True)
    ref0, ref1 = (torch.from_numpy(np.array(r, dtype=np.float32)) for r in
                  jbidir.bidir_cross_attention_reference(
                      *(jnp.asarray(t.numpy()) for t in (qk0, qk1, v0, v1, m0, m1))))
    assert _within_two_ulps(got0, ref0, m0)
    assert _within_two_ulps(got1, ref1, m1)
    assert bool(torch.isfinite(got0).all()) and bool(torch.isfinite(got1).all())


# ---------------------------------------------------------------------------
# the float32 form
# ---------------------------------------------------------------------------

def _f32(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _rel_err(got, ref, rows):
    """max |got - ref| / max |ref| over valid rows."""
    rows = rows[:, None, :, None].expand_as(got)
    return ((got - ref).abs()[rows].max() / ref.abs()[rows].max()).item()


@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_tiled_attention_f32_matches_xla_attention(case):
    """Kernel 1's float32 form against the JAX package's dense attention in
    f32: within 5e-5 of max|out| on valid rows (the bound chip_smoke.py holds
    the kernel to on the card); all-masked query tiles of 128 rows give
    zeros."""
    got, ref, rows, qm = _attention_case(case, 64, 2, 17, "f32")
    assert _rel_err(got, ref, rows) <= F32_TOL
    if qm is not None:
        assert bool((got[2] == 0).all())


@pytest.mark.parametrize("case", list(BIDIR_CASES))
def test_tiled_bidir_f32_matches_dense_reference(case):
    """Kernel 6's float32 form (two recomputed directions, each with its row
    bias, split-TF32 products) against the JAX package's dense reference in
    f32, within 5e-5 of max|out| on valid rows; finite everywhere."""
    M, N, kind = BIDIR_CASES[case]
    rng = np.random.default_rng(19)
    B, H, d = 3, 2, 64
    qk0, v0 = _f32(rng, B, H, M, d) * 2, _f32(rng, B, H, M, d)
    qk1, v1 = _f32(rng, B, H, N, d) * 2, _f32(rng, B, H, N, d)
    m0, m1 = _masks(rng, B, M, kind), _masks(rng, B, N, kind)
    m0[1, 5] = False
    m1[2] = False  # every side-1 token of element 2 masked
    scale = d ** -0.5
    got0 = tiled_attention(qk0, qk1, v1, m0, m1, scale, tiles("f32", d), row_bias=True,
                           form="f32")
    got1 = tiled_attention(qk1, qk0, v0, m1, m0, scale, tiles("f32", d), row_bias=True,
                           form="f32")
    ref0, ref1 = (torch.from_numpy(np.array(r, dtype=np.float32)) for r in
                  jbidir.bidir_cross_attention_reference(
                      *(jnp.asarray(t.numpy()) for t in (qk0, qk1, v0, v1, m0, m1))))
    assert _rel_err(got0, ref0, m0) <= F32_TOL
    assert _rel_err(got1, ref1, m1) <= F32_TOL
    assert bool(torch.isfinite(got0).all()) and bool(torch.isfinite(got1).all())


@pytest.mark.parametrize("row_bias", [False, True], ids=["kernel1", "kernel6"])
def test_one_tf32_product_leaves_the_attention_tolerance(row_bias):
    """Why the float32 form takes three TF32 products: one product (hi.hi)
    of each kind is far outside 5e-5 of max|out|, the split inside it."""
    rng = np.random.default_rng(21)
    B, H, N, d = 2, 2, 300, 64
    q, k, v = _f32(rng, B, H, N, d) * 2, _f32(rng, B, H, N, d) * 2, _f32(rng, B, H, N, d)
    m = _masks(rng, B, N, "prefix")
    scale = d ** -0.5
    if row_bias:
        ref = torch.from_numpy(np.array(jbidir.bidir_cross_attention_reference(
            *(jnp.asarray(t.numpy()) for t in (q, k, v, v, m, m)))[0], dtype=np.float32))
    else:
        ref = torch.from_numpy(np.array(jattn.xla_attention(
            jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
            jnp.asarray(m.numpy()), scale)))
    split = tiled_attention(q, k, v, m, m, scale, tiles("f32", d), row_bias=row_bias, form="f32")
    one = tiled_attention(q, k, v, m, m, scale, tiles("f32", d), row_bias=row_bias, form="tf32")
    assert _rel_err(split, ref, m) <= F32_TOL
    assert _rel_err(one, ref, m) > 4 * F32_TOL


def test_p_fragments_meet_the_permuted_values():
    """O += P V with P from the S accumulator: thread (g, c) of a warp holds
    rows g, g + 8 and keys c, c + 1 (c = 2 (lane % 4)) of each group of 8;
    the TF32 A fragment takes them as k = c / 2 and k + 4, and V^T holds
    each group's keys in the order 0 2 4 6 1 3 5 7 (the producer's split_v),
    so the fragment product is P V."""
    rng = np.random.default_rng(23)
    P, V = _f32(rng, 16, 8), _f32(rng, 8, 64)
    A = torch.zeros(16, 8)
    for lane in range(32):
        g, c = lane // 4, 2 * (lane % 4)
        s = [P[g, c], P[g, c + 1], P[g + 8, c], P[g + 8, c + 1]]  # s[4 j + e]
        a = [s[0], s[2], s[1], s[3]]  # the kernel's A registers
        t = lane % 4
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a
    order = [2 * p if p < 4 else 2 * (p - 4) + 1 for p in range(8)]
    torch.testing.assert_close(A @ V[order], P @ V, rtol=1e-6, atol=1e-6)
