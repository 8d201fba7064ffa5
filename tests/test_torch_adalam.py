"""AdaLAM and ``nn_match_with_ratios`` in the port against the JAX package
on the CPU: the ratios and mutual masks exactly on integer descriptors (with
ties), the exact filter with the JAX package's RANSAC draws injected (the
same kept set, with and without the orientation and scale gates, the refit
and the seed mutuality), the filter on its own draws against a scene with a
known answer, and the ``adalam_fast`` vote. Inputs come from a numpy seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_image_matching_tpu.matchers import adalam as jadm
from deep_image_matching_tpu.ops import adalam as jad
from deep_image_matching_tpu.ops import nn_match as jnn
from deep_image_matching_tpu_torch.ops import adalam as tad
from deep_image_matching_tpu_torch.ops import nn_match as tnn


@pytest.mark.parametrize("mode", ["nn", "mnn", "snn", "smnn"])
def test_nn_match_with_ratios_exact_on_integers(mode):
    rng = np.random.default_rng(0)
    B, N0, N1, D = 2, 150, 170, 16
    d0 = rng.integers(-3, 4, (B, N0, D)).astype(np.float32)
    d1 = rng.integers(-3, 4, (B, N1, D)).astype(np.float32)
    d1[:, :50] = d0[:, :50]  # exact matches, and duplicates for ties
    d1[:, 50:60] = d0[:, :10]
    m0 = np.ones((B, N0), bool)
    m1 = np.ones((B, N1), bool)
    m0[1, 120:] = m1[0, 160:] = False
    ref = jax.vmap(lambda a, b, c, d: jnn.nn_match_with_ratios(a, b, c, d, mode=mode,
                                                               ratio_th=0.9))(
        *(jnp.asarray(x) for x in (d0, d1, m0, m1)))
    got = tnn.nn_match_with_ratios(*(torch.from_numpy(x) for x in (d0, d1, m0, m1)), mode=mode,
                                   ratio_th=0.9)
    for i in (0, 1, 3):  # matches, validity, mutuality
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    # the ratios of exact distances, within one f32 ulp (XLA may take the
    # quotient of square roots through a reciprocal square root)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=2.0 ** -23, atol=0)
    assert got[1].sum() > 40


def _scene(n_in=300, n_out=60, seed=0):
    """Two locally affine motions (left and right halves) and random
    outliers, with localisation noise (the JAX package's test scene)."""
    rng = np.random.default_rng(seed)
    W = H = 1000.0
    k0 = rng.uniform([0, 0], [W, H], (n_in + n_out, 2)).astype(np.float32)
    A = [np.array([[1.05, 0.08], [-0.05, 0.97]], np.float32),
         np.array([[0.9, -0.1], [0.12, 1.1]], np.float32)]
    t = [np.array([30.0, -12.0], np.float32), np.array([-25.0, 40.0], np.float32)]
    k1 = np.empty_like(k0)
    left = k0[:, 0] < W / 2
    k1[left] = k0[left] @ A[0].T + t[0]
    k1[~left] = k0[~left] @ A[1].T + t[1]
    k1[n_in:] = rng.uniform([0, 0], [W, H], (n_out, 2))
    k1 = (k1 + rng.normal(0, 0.5, k1.shape)).astype(np.float32)
    ratios = rng.uniform(0.4, 0.8, len(k0)).astype(np.float32)
    gt = np.zeros(len(k0), bool)
    gt[:n_in] = True
    return k0, k1, np.arange(len(k0), dtype=np.int32), np.ones(len(k0), bool), ratios, gt


def _jax_draws(key, K, iters=128):
    """The JAX filter's samples: ``randint`` on the first half of the key's
    split, (S, iters, 2) in [0, M)."""
    S, M = min(256, K), min(256, K)
    k1, _ = jax.random.split(key)
    return np.array(jax.random.randint(k1, (S, iters, 2), 0, M))


CASES = {
    "plain": dict(),
    "mnn_seeds": dict(mnn=True),
    "no_refit": dict(refit=False),
    "gates": dict(gates=True),
    "few": dict(n_in=60, n_out=30),
}


@pytest.mark.parametrize("case", list(CASES))
def test_adalam_filter_matches_jax_with_its_draws(case):
    kw = dict(CASES[case])
    mnn, gates = kw.pop("mnn", False), kw.pop("gates", False)
    refit = kw.pop("refit", True)
    k0, k1, m0, valid, ratios, _ = _scene(seed=len(case), **kw)
    valid[::7] = False
    rng = np.random.default_rng(3)
    extra_j, extra_t = {}, {}
    if mnn:
        mu = rng.random(len(k0)) < 0.8
        extra_j["mnn"], extra_t["mnn"] = jnp.asarray(mu), torch.from_numpy(mu)
    if gates:
        ori0 = rng.uniform(-180, 180, len(k0)).astype(np.float32)
        ori1 = (ori0 + np.where(rng.random(len(k0)) < 0.3, 120.0, 5.0)).astype(np.float32)
        sc0 = rng.uniform(1, 4, len(k0)).astype(np.float32)
        sc1 = (sc0 * np.where(rng.random(len(k0)) < 0.2, 3.0, 1.1)).astype(np.float32)
        for name, arr in (("ori0", ori0), ("ori1", ori1), ("scale0", sc0), ("scale1", sc1)):
            extra_j[name], extra_t[name] = jnp.asarray(arr), torch.from_numpy(arr)
    wh = np.float32([1000, 800])
    key = jax.random.PRNGKey(len(case))
    ref = jad.adalam_filter(*(jnp.asarray(a) for a in (k0, k1, m0, valid, ratios, wh, wh)), key,
                            refit=refit, force_seed_mnn=mnn, **extra_j)
    got = tad.adalam_filter(*(torch.from_numpy(a) for a in (k0, k1, m0, valid, ratios, wh, wh)),
                            samples=torch.from_numpy(_jax_draws(key, len(k0))), refit=refit,
                            force_seed_mnn=mnn, **extra_t)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.sum() > 10


def test_adalam_filter_on_its_own_draws():
    """The port's generator: affine-consistent matches kept, outliers
    rejected (the JAX package's thresholds), invalid candidates stay out."""
    k0, k1, m0, valid, ratios, gt = _scene()
    valid[::5] = False
    keep = tad.adalam_filter_np(k0, k1, m0, valid, ratios, (1000, 1000), (1000, 1000),
                                force_seed_mnn=False)
    assert keep[gt & valid].mean() > 0.8
    assert keep[~gt].mean() < 0.15
    assert not keep[~valid].any()


def test_motion_consistency_matches_jax():
    k0, k1, m0, valid, _, _ = _scene(n_in=200, n_out=50, seed=9)
    valid[::4] = False
    ref = jadm.motion_consistency_filter(*(jnp.asarray(a) for a in (k0, k1, m0, valid)))
    got = tad.motion_consistency_filter(*(torch.from_numpy(a) for a in (k0, k1, m0, valid)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 50 < got.sum() < 200


@pytest.mark.parametrize("mode", ["adalam", "adalam_fast"])
def test_run_matching_adalam_over_sift_agrees_with_jax(tmp_path, monkeypatch, mode):
    """``matcher: {name: adalam, match_mode: ...}`` over sift on three demo
    images, the JAX package's draws carried into the port's sampler."""
    from test_torch_disk import demo_project, run_both_and_compare

    from deep_image_matching_tpu_torch.matchers.adalam import AdalamMatcher

    def jax_samples(self, B, K, iters, device):
        keys = jax.random.split(jax.random.PRNGKey(int(self.conf.get("seed", 0))), B)
        return [torch.from_numpy(_jax_draws(keys[b], K, iters)).to(device) for b in range(B)]

    monkeypatch.setattr(AdalamMatcher, "_samples", jax_samples)
    proj = demo_project(tmp_path / "proj", size=(320, 240))
    run_both_and_compare(tmp_path, proj, "sift+kornia_matcher",
                         f"extractor:\n  n_features: 512\nmatcher:\n  name: adalam\n"
                         f"  match_mode: {mode}\n", min_verified=1)
