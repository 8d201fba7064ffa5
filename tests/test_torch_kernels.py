"""The plain versions of the port's four kernels against the JAX package's
CPU routes (the CUDA kernels against the plain versions are in
test_torch_cuda.py). Inputs come from a numpy seed and reach both packages
as the same arrays."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_image_matching_tpu.models import lightglue as jlg
from deep_image_matching_tpu.ops import attention as jattn
from deep_image_matching_tpu.ops import pallas_ffn as jffn
from deep_image_matching_tpu.ops import ransac as jransac
from deep_image_matching_tpu.ops.pallas_nullspace import nullspace_8x9 as j_nullspace_8x9
from deep_image_matching_tpu_torch.ops import assignment as tassign
from deep_image_matching_tpu_torch.ops import attention as tattn
from deep_image_matching_tpu_torch.ops import ffn as tffn
from deep_image_matching_tpu_torch.ops import nullspace as tnull


def _prefix_masks(rng, B, N, low):
    counts = rng.integers(low, N + 1, size=B)
    counts[0] = N
    return np.arange(N)[None] < counts[:, None]


# ---------------------------------------------------------------------------
# kernel 1: attention
# ---------------------------------------------------------------------------

def _attention_inputs(rng, B=2, H=4, N=100, M=90, d=16):
    q = rng.normal(size=(B, H, N, d)).astype(np.float32)
    k = rng.normal(size=(B, H, M, d)).astype(np.float32)
    v = rng.normal(size=(B, H, M, d)).astype(np.float32)
    qm = _prefix_masks(rng, B, N, 10)
    km = _prefix_masks(rng, B, M, 10)
    km[1, :] = False  # a pair with every key masked averages all keys
    return q, k, v, qm, km


def test_attention_plain_matches_xla_attention():
    rng = np.random.default_rng(0)
    q, k, v, qm, km = _attention_inputs(rng)
    scale = q.shape[-1] ** -0.5
    ref = np.asarray(jattn.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(km), scale))
    got = tattn.fused_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(qm), torch.from_numpy(km), scale).numpy()
    rows = np.broadcast_to(qm[:, None, :, None], got.shape)
    # f32 on both sides; only the summation order differs
    np.testing.assert_allclose(got[rows], ref[rows], atol=2e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# kernel 2: FFN
# ---------------------------------------------------------------------------

def _ffn_inputs(rng, B=2, K=64, D=128):
    x = rng.normal(size=(B, K, D)).astype(np.float32)
    msg = rng.normal(size=(B, K, D)).astype(np.float32)
    w1 = (rng.normal(size=(2 * D, 2 * D)) / np.sqrt(2 * D)).astype(np.float32)  # (in, out)
    b1 = (0.1 * rng.normal(size=2 * D)).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=2 * D)).astype(np.float32)
    beta = (0.1 * rng.normal(size=2 * D)).astype(np.float32)
    w2 = (rng.normal(size=(2 * D, D)) / np.sqrt(2 * D)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=D)).astype(np.float32)
    return x, msg, w1, b1, g, beta, w2, b2


def test_ffn_plain_matches_jax_reference_and_pallas_interpret():
    rng = np.random.default_rng(2)
    x, msg, w1, b1, g, beta, w2, b2 = _ffn_inputs(rng)
    jargs = [jnp.asarray(a) for a in (x, msg, w1, b1, g, beta, w2, b2)]
    ref = np.asarray(jffn.ffn_reference(*jargs))
    pallas = np.asarray(jffn.ffn_fused(*jargs, interpret=True))
    t = torch.from_numpy
    # the port takes nn.Linear (out, in) weights
    got = tffn.ffn_fused(t(x), t(msg), t(w1.T.copy()), t(b1), t(g), t(beta),
                         t(w2.T.copy()), t(b2)).numpy()
    # f32 everywhere; the Pallas erf (Abramowitz-Stegun) differs from
    # torch.erf by <= 1.5e-7 and the sums run in another order
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# kernel 3: assignment
# ---------------------------------------------------------------------------

def _assignment_inputs(rng, B=2, M=256, N=256, D=64):
    md0 = rng.normal(size=(B, M, D)).astype(np.float32)
    md1 = rng.normal(size=(B, N, D)).astype(np.float32)
    # plant mutual matches so the threshold keeps some
    md1[:, :100] = md0[:, :100] + 0.05 * rng.normal(size=(B, 100, D)).astype(np.float32)
    z0 = rng.normal(size=(B, M)).astype(np.float32)
    z1 = rng.normal(size=(B, N)).astype(np.float32)
    m0 = _prefix_masks(rng, B, M, 150)
    m1 = _prefix_masks(rng, B, N, 150)
    return md0, md1, z0, z1, m0, m1


def test_assignment_plain_matches_filter_matches_static():
    rng = np.random.default_rng(4)
    md0, md1, z0, z1, m0, m1 = _assignment_inputs(rng)
    j = [jnp.asarray(a) for a in (md0, md1, z0, z1, m0, m1)]
    sim = jnp.einsum("bmd,bnd->bmn", j[0], j[1])
    scores = (jax.nn.log_softmax(jnp.where(j[5][:, None, :], sim, -1e30), 2)
              + jax.nn.log_softmax(jnp.where(j[4][:, :, None], sim, -1e30), 1)
              + jax.nn.log_sigmoid(j[2])[:, :, None] + jax.nn.log_sigmoid(j[3])[:, None, :])
    scores = jnp.where(j[4][:, :, None] & j[5][:, None, :], scores, -1e30)
    ref_m, ref_s, ref_v = (np.asarray(a) for a in jlg.filter_matches_static(scores, j[4], j[5], 0.1))
    t = torch.from_numpy
    got_m, got_s, got_v = (a.numpy() for a in tassign.filter_matches_fused(
        t(md0), t(md1), t(z0), t(z1), t(m0), t(m1), 0.1))
    assert ref_v.sum() > 50
    np.testing.assert_array_equal(got_v, ref_v)
    np.testing.assert_array_equal(got_m, ref_m)
    np.testing.assert_allclose(got_s[ref_v], ref_s[ref_v], atol=1e-5)


def test_assignment_plain_matches_pallas_interpret():
    from jax.experimental.pallas import tpu as pltpu

    from deep_image_matching_tpu.ops.pallas_assignment import filter_matches_fused

    rng = np.random.default_rng(5)
    md0, md1, z0, z1, m0, m1 = _assignment_inputs(rng)
    with pltpu.force_tpu_interpret_mode():
        ref_m, ref_s, ref_v = (np.asarray(a) for a in filter_matches_fused(
            *(jnp.asarray(a) for a in (md0, md1, z0, z1, m0, m1)), 0.1))
    t = torch.from_numpy
    got_m, got_s, got_v = (a.numpy() for a in tassign.filter_matches_fused(
        t(md0), t(md1), t(z0), t(z1), t(m0), t(m1), 0.1))
    np.testing.assert_array_equal(got_v, ref_v)
    np.testing.assert_array_equal(got_m, ref_m)
    # streaming vs dense logsumexp in f32
    np.testing.assert_allclose(got_s[ref_v], ref_s[ref_v], atol=1e-4)


# ---------------------------------------------------------------------------
# kernel 4: null space
# ---------------------------------------------------------------------------

def _constraint_systems(rng, N=256):
    """Half generic motion, half pure translation (F has f33 = 0)."""
    p0 = rng.uniform(-1, 1, size=(N, 8, 2)).astype(np.float32)
    shift = rng.uniform(-0.5, 0.5, size=(N, 1, 2)).astype(np.float32)
    p1 = np.where((np.arange(N) % 2 == 0)[:, None, None], p0 + shift,
                  rng.uniform(-1, 1, size=(N, 8, 2)).astype(np.float32))
    return np.array(jransac._build_constraints(jnp.asarray(p0), jnp.asarray(p1)))


def test_nullspace_plain_matches_pallas_interpret():
    rng = np.random.default_rng(7)
    A = _constraint_systems(rng)
    ref = np.asarray(j_nullspace_8x9(jnp.asarray(A), interpret=True))
    got = tnull.nullspace_8x9(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    # true null vectors on every system, the f33 = 0 ones included
    assert np.abs(np.einsum("nij,nj->ni", A, got)).max() < 1e-4
    # the same direction up to sign on the generic half; the translation
    # half has a >= 3-dim null space, where both are valid but may differ
    dots = np.abs(np.einsum("ni,ni->n", got, ref))
    np.testing.assert_allclose(dots[1::2], 1.0, atol=1e-4)
