"""The port's batched RANSAC against the JAX package's, with the JAX
package's random draws injected through ``sample_u``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_image_matching_tpu.ops import ransac as jransac
from deep_image_matching_tpu_torch.ops import ransac as transac

ITERS = 128


def _scene(rng, n_in, n_out, M):
    """Exact projections of random 3D points into two calibrated views
    (inliers, Sampson error ~1e-4 px against a 1 px threshold) plus
    uniform outliers, padded to M."""
    Kmat = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    a = rng.uniform(-0.2, 0.2)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t = np.array([0.5, 0.05, 0.1])
    X = np.c_[rng.uniform(-2, 2, (n_in, 2)), rng.uniform(4, 8, n_in)]
    x0 = (Kmat @ X.T).T
    x1 = (Kmat @ (R @ X.T + t[:, None])).T
    p0 = np.zeros((M, 2), np.float32)
    p1 = np.zeros((M, 2), np.float32)
    p0[:n_in] = x0[:, :2] / x0[:, 2:]
    p1[:n_in] = x1[:, :2] / x1[:, 2:]
    p0[n_in:n_in + n_out] = rng.uniform(0, 640, (n_out, 2))
    p1[n_in:n_in + n_out] = rng.uniform(0, 640, (n_out, 2))
    valid = np.arange(M) < n_in + n_out
    return p0, p1, valid


def _batch():
    rng = np.random.default_rng(0)
    M = 200
    pairs = [_scene(rng, 150, 50, M), _scene(rng, 90, 30, M), _scene(rng, 6, 0, M)]
    return tuple(np.stack(x) for x in zip(*pairs))


def _jax_draws(valid, iters, key=jax.random.PRNGKey(0)):
    """The integer draws ``ransac_fundamental_batch`` makes for each pair
    (``jax.random.split(key, B)``, one ``randint`` per pair)."""
    keys = jax.random.split(key, valid.shape[0])
    return np.stack([
        np.asarray(jax.random.randint(keys[b], (8, iters), 0, max(int(valid[b].sum()), 1)))
        for b in range(valid.shape[0])
    ])


def test_ransac_batch_matches_jax_with_injected_draws():
    p0, p1, valid = _batch()
    F_ref, inl_ref, n_ref = (np.asarray(a) for a in jransac.ransac_fundamental_batch(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(valid), jax.random.PRNGKey(0),
        1.0, ITERS))
    u = torch.from_numpy(_jax_draws(valid, ITERS))
    F, inl, n = transac.ransac_fundamental_batch(
        torch.from_numpy(p0), torch.from_numpy(p1), torch.from_numpy(valid), 1.0, ITERS,
        sample_u=u)
    np.testing.assert_array_equal(inl.numpy(), inl_ref)
    np.testing.assert_array_equal(n.numpy(), n_ref)
    assert n_ref[0] >= 150 and n_ref[1] >= 90 and n_ref[2] == 0
    # F up to scale and sign: normalised by the Frobenius norm. The refit's
    # f32 eigh of A^T A moves its null direction by ~eps * s1 / s8 between
    # two eigensolvers; the inlier sets above are what the pipeline uses
    for b in range(2):
        f, fr = F[b].numpy().ravel(), F_ref[b].ravel()
        f, fr = f / np.linalg.norm(f), fr / np.linalg.norm(fr)
        assert min(np.abs(f - fr).max(), np.abs(f + fr).max()) < 1e-2


def test_ransac_store_batch_matches_jax():
    p0, p1, valid = _batch()
    B, M = valid.shape
    # a keypoint table of 2B images; pair b matches image b to image B + b
    table = np.concatenate([p0, p1[:, ::-1]])
    matches0 = np.tile(np.arange(M)[::-1], (B, 1)).astype(np.int32)
    idx0, idx1 = np.arange(B, dtype=np.int32), np.arange(B, 2 * B, dtype=np.int32)
    ref = np.asarray(jransac.ransac_fundamental_store_batch(
        jnp.asarray(table), jnp.asarray(idx0), jnp.asarray(idx1), jnp.asarray(matches0),
        jnp.asarray(valid), jax.random.PRNGKey(0), 1.0, ITERS))
    got = transac.ransac_fundamental_store_batch(
        torch.from_numpy(table), torch.from_numpy(idx0), torch.from_numpy(idx1),
        torch.from_numpy(matches0), torch.from_numpy(valid), 1.0, ITERS,
        sample_u=torch.from_numpy(_jax_draws(valid, ITERS)))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_ransac_own_draws_find_the_inliers():
    p0, p1, valid = _batch()
    _, inl, n = transac.ransac_fundamental_batch(
        torch.from_numpy(p0), torch.from_numpy(p1), torch.from_numpy(valid), 1.0, 512,
        generator=torch.Generator().manual_seed(0))
    assert inl[0, :150].all() and inl[1, :90].all() and int(n[2]) == 0
