"""The tile algorithm of the Hopper attention core (csrc/attention_sm90.cuh,
kernels 1 and 6) against the JAX package's dense references, on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py holds them
against their plain versions there). What can be checked here is the
algorithm they implement: 192-row query tiles and 128-key tiles, masks as
additive key (and row) biases, the scale folded into exp2, the running
maxima from -inf (kernel 1) or -1e30 (kernel 6), P rounded to bf16 before
the PV product, a key tile skipped when all its keys are masked and its
batch element has a valid key, all-masked query tiles written as zeros, and
kernel 6 as two recomputed directions. ``tiled_attention`` below follows the
kernel step by step in f32, one key tile at a time.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deep_image_matching_tpu.ops import attention as jattn
from deep_image_matching_tpu.ops import pallas_bidir_attention as jbidir

BQ, BK = 192, 128
NEG = -1e30


def tiled_attention(q, k, v, q_mask, k_mask, scale, row_bias=False, skip=True):
    """The kernel's arithmetic: (B, H, Nq, d) x (B, H, Nk, d) f32 tensors,
    (B, Nq) / (B, Nk) bool masks (None: all valid). ``row_bias`` selects
    kernel 6 (rows of masked queries get -1e30, maxima start at -1e30, the
    output is over max(l, 1e-30)); else kernel 1 (maxima from -inf, output
    times 1/l). ``skip``: leave out all-masked key tiles as the kernel does."""
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
    for k0 in range(0, Nk, BK):
        keys = slice(k0, min(k0 + BK, Nk))
        # per batch element: the tile is processed unless all its keys are
        # masked while some key of the element is valid
        live = ~(skip & ~km[:, keys].any(1) & any_k)
        s = torch.einsum("bhid,bhjd->bhij", q, k[:, :, keys]) * C
        s = s + kbias[:, None, None, keys] + qbias
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l_new = l * corr + p.sum(-1, keepdim=True)
        pv = torch.einsum("bhij,bhjd->bhid", p.to(torch.bfloat16).float(), v[:, :, keys])
        o_new = o * corr + pv
        sel = live[:, None, None, None]
        m, l, o = torch.where(sel, m_new, m), torch.where(sel, l_new, l), torch.where(sel, o_new, o)
    out = o / l.clamp(min=1e-30) if row_bias else o * (1.0 / l)
    # query tiles whose rows are all masked: zeros
    for q0 in range(0, Nq, BQ):
        dead = ~qm[:, q0:q0 + BQ].any(1)
        out[dead, :, q0:q0 + BQ] = 0.0
    return out


def _bf16(rng, *shape):
    """Normal values that bf16 holds exactly, as f32."""
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16().float()


def _masks(rng, B, N, kind):
    if kind == "none":
        return None
    if kind == "prefix":
        counts = rng.integers(10, N + 1, size=B)
        counts[0] = N
        m = np.arange(N)[None] < counts[:, None]
    else:  # random, with a fully masked 128-key tile in the middle of element 0
        m = rng.random((B, N)) < 0.7
        m[0, BK:2 * BK] = False
    return torch.from_numpy(m)


def _within_two_ulps(got, ref, rows):
    """Two bf16 ulps on valid rows, the kernels' bound on the card."""
    rows = rows[:, None, :, None].expand_as(got)
    return bool(((got - ref).abs()[rows] <= 2.0 ** -6 * ref.abs()[rows].clamp(min=1.0)).all())


# (Nq, Nk, query masks, key masks): ragged against both tile sizes, fewer
# than 64 queries, DINOv2's unmasked ragged length, a fully masked key tile
# in the middle
ATTENTION_CASES = {
    "ragged": (300, 131, "prefix", "prefix"),
    "short": (40, 200, "prefix", "prefix"),
    "unmasked_1601": (1601, 401, "none", "none"),
    "middle_tile": (300, 520, "prefix", "middle"),
}


@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_tiled_attention_matches_xla_attention(case):
    Nq, Nk, qkind, kkind = ATTENTION_CASES[case]
    rng = np.random.default_rng(7)
    B, H, d = 3, 2, 64
    q, k, v = _bf16(rng, B, H, Nq, d) * 2, _bf16(rng, B, H, Nk, d) * 2, _bf16(rng, B, H, Nk, d)
    qm, km = _masks(rng, B, Nq, qkind), _masks(rng, B, Nk, kkind)
    if km is not None:
        km[1] = False  # every key masked: the uniform average of all keys
    if qm is not None:
        qm[2, :] = False  # every query masked: zeros
    scale = d ** -0.5
    got = tiled_attention(q, k, v, qm, km, scale)
    ref = torch.from_numpy(np.array(jattn.xla_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
        None if km is None else jnp.asarray(km.numpy()), scale)))
    rows = torch.ones(B, Nq, dtype=torch.bool) if qm is None else qm
    assert _within_two_ulps(got, ref, rows)
    if qm is not None:
        assert bool((got[2] == 0).all())


def test_skipping_masked_key_tiles_is_exact():
    """A key tile whose keys are all masked changes nothing for an element
    with a valid key, wherever it lies (also before the first valid tile)."""
    rng = np.random.default_rng(8)
    B, H, N, M, d = 2, 2, 200, 640, 64
    q, k, v = _bf16(rng, B, H, N, d), _bf16(rng, B, H, M, d), _bf16(rng, B, H, M, d)
    km = torch.from_numpy(rng.random((B, M)) < 0.5)
    km[0, :2 * BK] = False       # the first two tiles of element 0 masked
    km[1, 3 * BK:4 * BK] = False  # a middle tile of element 1 masked
    for row_bias in (False, True):
        a = tiled_attention(q, k, v, None, km, 0.125, row_bias=row_bias, skip=True)
        b = tiled_attention(q, k, v, None, km, 0.125, row_bias=row_bias, skip=False)
        assert torch.equal(a, b)


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
    got0 = tiled_attention(qk0, qk1, v1, m0, m1, scale, row_bias=True)
    got1 = tiled_attention(qk1, qk0, v0, m1, m0, scale, row_bias=True)
    ref0, ref1 = (torch.from_numpy(np.array(r, dtype=np.float32)) for r in
                  jbidir.bidir_cross_attention_reference(
                      *(jnp.asarray(t.numpy()) for t in (qk0, qk1, v0, v1, m0, m1))))
    assert _within_two_ulps(got0, ref0, m0)
    assert _within_two_ulps(got1, ref1, m1)
    assert bool(torch.isfinite(got0).all()) and bool(torch.isfinite(got1).all())
