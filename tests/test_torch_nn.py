"""Kernel 5's plain version and the nearest-neighbour matcher against the
JAX package: ``nn_top2`` and ``nn_match_fused`` as the JAX package's own
tests run them on the CPU (Pallas interpret mode), and the dense
``nn_match_batch``. Inputs come from a numpy seed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from deep_image_matching_tpu.ops import nn_match as jnm
from deep_image_matching_tpu.ops import pallas_nn as jpnn
from deep_image_matching_tpu_torch.ops import nn as tnn
from deep_image_matching_tpu_torch.ops import nn_match as tnm

MODES = ("nn", "mnn", "snn", "smnn")


def _integer_descriptors(rng, B, K0, K1, D):
    """Byte-valued descriptors (SIFT, ORB) with exact neighbours, exact ties
    (a query's neighbour present twice) and duplicated columns."""
    d0 = rng.integers(0, 256, (B, K0, D)).astype(np.float32)
    d1 = rng.integers(0, 256, (B, K1, D)).astype(np.float32)
    d1[:, 10:30] = d0[:, :20]
    d1[:, 30:40] = d0[:, :10]      # queries 0-9 reach their minimum twice
    d1[:, 60:90] = d1[:, 40:70]    # duplicated columns
    d0[:, 100:110] = d0[:, 90:100]  # duplicated queries
    return d0, d1


def _masks(B, K0, K1, n0, n1):
    m0 = np.arange(K0)[None] < np.asarray(n0)[:, None]
    m1 = np.arange(K1)[None] < np.asarray(n1)[:, None]
    return np.broadcast_to(m0, (B, K0)).copy(), np.broadcast_to(m1, (B, K1)).copy()


def _sq(d, m):
    return ((d ** 2).sum(-1) + np.where(m, 0.0, 1e12)).astype(np.float32)


@pytest.mark.parametrize("D", [32, 128])
def test_nn_top2_plain_equals_pallas_interpret_bitwise_on_integers(D):
    """Capacity 4000 (padded to 4096 columns by both), ties and duplicates:
    every output bitwise equal, as the f32 arithmetic is exact."""
    rng = np.random.default_rng(D)
    B, K0, K1 = 1, 4000, 4000
    d0, d1 = _integer_descriptors(rng, B, K0, K1, D)
    m0, m1 = _masks(B, K0, K1, [3900], [3800])
    d0 *= m0[..., None]
    d1 *= m1[..., None]
    sq1 = _sq(d1, m1)
    with pltpu.force_tpu_interpret_mode():
        ref = [np.asarray(a) for a in jpnn.nn_top2(jnp.asarray(d0), jnp.asarray(d1),
                                                   jnp.asarray(sq1))]
    got = [a.numpy() for a in tnn.nn_top2(torch.from_numpy(d0), torch.from_numpy(d1),
                                          torch.from_numpy(sq1))]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    # the tie rule: smallest index, and min2 == min1 on a double minimum
    np.testing.assert_array_equal(got[2][0, :10], np.arange(10, 20))
    np.testing.assert_array_equal(got[0][0, :10], got[1][0, :10])


def test_nn_top2_plain_matches_pallas_interpret_on_floats():
    rng = np.random.default_rng(1)
    B, K0, K1, D = 2, 200, 333, 256
    d0 = rng.normal(size=(B, K0, D)).astype(np.float32)
    d1 = rng.normal(size=(B, K1, D)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    m1 = np.arange(K1)[None] < np.array([[K1], [250]])
    d1 *= m1[..., None]
    sq1 = _sq(d1, m1)
    with pltpu.force_tpu_interpret_mode():
        ref = [np.asarray(a) for a in jpnn.nn_top2(jnp.asarray(d0), jnp.asarray(d1),
                                                   jnp.asarray(sq1))]
    got = [a.numpy() for a in tnn.nn_top2(torch.from_numpy(d0), torch.from_numpy(d1),
                                          torch.from_numpy(sq1))]
    # f32 products summed in another order
    np.testing.assert_allclose(got[0], ref[0], atol=1e-5)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-5)
    clear = (ref[1] - ref[0]) > 1e-4
    np.testing.assert_array_equal(got[2][clear], ref[2][clear])


@pytest.mark.parametrize("mode", MODES)
def test_nn_match_fused_plain_equals_pallas_interpret(mode):
    """Integer descriptors with ties, partial masks, and a pair whose
    reference side holds one valid point (one finite neighbour: the ratio
    test keeps the match)."""
    rng = np.random.default_rng(3)
    B, K0, K1, D = 3, 300, 260, 32
    d0, d1 = _integer_descriptors(rng, B, K0, K1, D)
    m0, m1 = _masks(B, K0, K1, [300, 250, 280], [260, 200, 1])
    d1[2, 0] = d0[2, 5] + 1  # the one valid reference point
    j = [jnp.asarray(a) for a in (d0, d1, m0, m1)]
    with pltpu.force_tpu_interpret_mode():
        ref_m, ref_v = (np.asarray(a) for a in jpnn.nn_match_fused(*j, mode=mode, ratio_th=0.9))
    t = [torch.from_numpy(a) for a in (d0, d1, m0, m1)]
    got_m, got_v = (a.numpy() for a in tnn.nn_match_fused(*t, mode=mode, ratio_th=0.9))
    np.testing.assert_array_equal(got_v, ref_v)
    np.testing.assert_array_equal(got_m, ref_m)
    assert got_v[:2].sum() > 20
    if mode in ("nn", "snn"):  # no mutual check: every valid query matches point 0
        assert got_v[2].sum() == 280 and set(got_m[2][got_v[2]]) == {0}


@pytest.mark.parametrize("mode", MODES)
def test_nn_match_plain_routes_match_dense_jax(mode):
    """Generic float descriptors: the kernel route (plain top-2) and the
    port's dense route both give the JAX package's dense matches."""
    rng = np.random.default_rng(4)
    B, K0, K1, D = 2, 256, 384, 128
    d0 = rng.normal(size=(B, K0, D)).astype(np.float32)
    d1 = rng.normal(size=(B, K1, D)).astype(np.float32)
    d1[:, :150] = d0[:, :150] + 0.05 * rng.normal(size=(B, 150, D)).astype(np.float32)
    m0, m1 = _masks(B, K0, K1, [256, 200], [384, 300])
    ref_m, ref_v = (np.asarray(a) for a in jnm.nn_match_batch(
        *(jnp.asarray(a) for a in (d0, d1, m0, m1)), mode=mode, ratio_th=0.8))
    t = [torch.from_numpy(a) for a in (d0, d1, m0, m1)]
    for fn in (tnn.nn_match_fused, tnm.nn_match_batch, tnm.nn_match_auto):
        got_m, got_v = (a.numpy() for a in fn(*t, mode=mode, ratio_th=0.8))
        np.testing.assert_array_equal(got_v, ref_v)
        np.testing.assert_array_equal(got_m[got_v], ref_m[ref_v])
    assert ref_v.sum() > 100


def test_nn_match_rejects_unknown_mode():
    z = torch.zeros(1, 4, 32)
    m = torch.ones(1, 4, dtype=torch.bool)
    for fn in (tnn.nn_match_fused, tnm.nn_match_batch, tnm.nn_match_auto):
        with pytest.raises(ValueError, match="match_mode"):
            fn(z, z, m, m, mode="ratio")
