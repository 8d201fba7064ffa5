"""SuperGlue's kernels and model against the JAX package: the plain versions
of the Sinkhorn iteration (kernel 7), the row logsumexp (kernel 8) and the
FFN's relu mode (kernel 2) against the Pallas kernels in interpret mode, the
whole SuperGlue forward against the JAX ``forward``, and the weight
conversion's round trip. Inputs come from a numpy seed and reach both
packages as the same arrays."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from deep_image_matching_tpu.models import superglue as jsg
from deep_image_matching_tpu.ops import pallas_ffn as jffn
from deep_image_matching_tpu.ops import pallas_sinkhorn as jsink
from deep_image_matching_tpu_torch.convert import superglue_params_from_jax
from deep_image_matching_tpu_torch.models import superglue as tsg
from deep_image_matching_tpu_torch.ops import ffn as tffn
from deep_image_matching_tpu_torch.ops import sinkhorn as tsink

_NEG = -1e30


def _couplings(rng, B, M, N):
    """SuperGlue-shaped couplings: masked rows and columns at -1e30, the
    marginals of masked entries at -1e30."""
    z = (3.0 * rng.normal(size=(B, M, N))).astype(np.float32)
    m0 = np.arange(M)[None] < np.array([M, M // 2])[:B, None]
    m1 = np.arange(N)[None] < np.array([N - 3, N])[:B, None]
    z = np.where(m0[:, :, None] & m1[:, None, :], z, np.float32(_NEG)).astype(np.float32)
    log_mu = np.where(m0, np.float32(-6.0), np.float32(_NEG)).astype(np.float32)
    log_nu = np.where(m1, np.float32(-6.0), np.float32(_NEG)).astype(np.float32)
    return z, log_mu, log_nu


def test_sinkhorn_iteration_plain_matches_pallas_interpret():
    """One iteration: the Pallas kernel walks 128-row strips (M a multiple
    of 128 there); any N."""
    rng = np.random.default_rng(0)
    B, M, N = 2, 256, 301
    z, log_mu, log_nu = _couplings(rng, B, M, N)
    v = rng.normal(size=(B, N)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ru, rv = (np.asarray(a) for a in jsink.sinkhorn_iteration(
            *(jnp.asarray(a) for a in (z, v, log_mu, log_nu))))
    gu, gv = (a.numpy() for a in tsink.sinkhorn_iteration(
        *(torch.from_numpy(a) for a in (z, v, log_mu, log_nu))))
    # f32 logsumexps summed in another order; -1e30 entries compare exactly
    np.testing.assert_allclose(gu, ru, atol=2e-5, rtol=1e-6)
    np.testing.assert_allclose(gv, rv, atol=2e-5, rtol=1e-6)
    # a fully masked row or column: log_mu = -1e30 minus an lse that f32
    # rounds to -1e30 gives 0 on both sides, and adds no mass elsewhere
    assert (gu[1, M // 2:] == 0).all() and (gv[0, N - 3:] == 0).all()


def test_sinkhorn_fused_plain_matches_pallas_interpret_at_unaligned_shapes():
    """(131, 259) couplings: the JAX package pads them to 512 multiples with
    -1e30, the port runs them as they are."""
    rng = np.random.default_rng(1)
    B, M, N = 2, 131, 259
    z, log_mu, log_nu = _couplings(rng, B, M, N)
    with pltpu.force_tpu_interpret_mode():
        ru, rv = (np.asarray(a) for a in jsink.sinkhorn_fused(
            jnp.asarray(z), jnp.asarray(log_mu), jnp.asarray(log_nu), 20))
    gu, gv = (a.numpy() for a in tsink.sinkhorn_fused(
        torch.from_numpy(z), torch.from_numpy(log_mu), torch.from_numpy(log_nu), 20))
    assert gu.shape == (B, M) and gv.shape == (B, N)
    np.testing.assert_allclose(gu, ru, atol=1e-4, rtol=1e-6)
    np.testing.assert_allclose(gv, rv, atol=1e-4, rtol=1e-6)


def test_logsumexp_rows_plain_matches_pallas_interpret():
    rng = np.random.default_rng(2)
    B, M, N = 2, 200, 300  # one Pallas block per batch
    z, log_mu, _ = _couplings(rng, B, M, N)
    v = rng.normal(size=(B, N)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jsink.logsumexp_rows(*(jnp.asarray(a) for a in (z, v, log_mu))))
    got = tsink.logsumexp_rows(*(torch.from_numpy(a) for a in (z, v, log_mu))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-6)


def test_ffn_relu_plain_matches_pallas_interpret():
    rng = np.random.default_rng(3)
    B, K, D = 2, 64, 128
    x = rng.normal(size=(B, K, D)).astype(np.float32)
    msg = rng.normal(size=(B, K, D)).astype(np.float32)
    w1 = (rng.normal(size=(2 * D, 2 * D)) / np.sqrt(2 * D)).astype(np.float32)  # (in, out)
    b1 = (0.1 * rng.normal(size=2 * D)).astype(np.float32)
    w2 = (rng.normal(size=(2 * D, D)) / np.sqrt(2 * D)).astype(np.float32)
    b2 = (0.1 * rng.normal(size=D)).astype(np.float32)
    zeros = np.zeros(2 * D, np.float32)
    ref = np.asarray(jffn.ffn_fused(*(jnp.asarray(a) for a in (x, msg, w1, b1, zeros, zeros,
                                                              w2, b2)),
                                    interpret=True, mode="relu"))
    t = torch.from_numpy
    # the port takes nn.Linear (out, in) weights; g and beta are not read
    got = tffn.ffn_fused(t(x), t(msg), t(w1.T.copy()), t(b1), None, None, t(w2.T.copy()),
                         t(b2), mode="relu").numpy()
    # f32 everywhere, sums in another order
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="mode"):
        tffn.ffn_fused(t(x), t(msg), t(w1), t(b1), None, None, t(w2), t(b2), mode="gelu")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _jax_params(rng, n_blocks, dim, kenc_channels):
    """The JAX package's random init with the given keypoint-encoder
    channels and noise on every parameter (non-zero biases included)."""
    params = jsg.init_params(jax.random.PRNGKey(3), n_blocks=n_blocks, dim=dim, num_heads=4)
    kenc = [{"w": jnp.asarray(rng.normal(size=(cin, cout)) / np.sqrt(cin), jnp.float32),
             "b": jnp.zeros((cout,), jnp.float32)}
            for cin, cout in zip(kenc_channels[:-1], kenc_channels[1:])]
    params = {**params, "kenc": kenc, "bin_score": jnp.asarray(0.7, jnp.float32)}
    return jax.tree.map(
        lambda a: a + jnp.asarray(0.05 * rng.normal(size=a.shape), jnp.float32), params)


def _model_from_jax(params, n_blocks, dim, kenc_channels):
    model = tsg.SuperGlue(n_blocks=n_blocks, dim=dim, num_heads=4, kenc_channels=kenc_channels)
    model.load_state_dict(superglue_params_from_jax(params))
    return model.eval()


def test_superglue_params_round_trip():
    """superglue_params_from_jax writes the folded weights with an identity
    BatchNorm; the JAX package's own params_from_torch folds them back to
    the same parameters within 1e-6 (the f32 BatchNorm scale 1 / sqrt(1 -
    eps + eps)). Full width: params_from_torch reads the four-layer
    keypoint encoder of the published model."""
    rng = np.random.default_rng(4)
    params = _jax_params(rng, 2, 256, tsg.KENC_CHANNELS)
    sd = superglue_params_from_jax(params)
    back = jsg.params_from_torch({k: v.numpy() for k, v in sd.items()})
    flat, tree = jax.tree.flatten(params)
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-6, rtol=0)
    # the port's module holds the reference's keys and folds back to them too
    model = _model_from_jax(params, 2, 256, tsg.KENC_CHANNELS)
    folded = model.folded_params(torch.float32)
    np.testing.assert_allclose(folded["gnn.layers.3.mlp.0.weight"].numpy(),
                               np.asarray(params["blocks"]["cross"]["mlp1"]["w"][1]).T, atol=1e-6)
    np.testing.assert_allclose(folded["kenc.encoder.3.weight"].numpy(),
                               np.asarray(params["kenc"][1]["w"]).T, atol=1e-6)


def test_superglue_forward_matches_jax():
    """2 blocks at width 64 (4 heads of 16, interleaved across channels), f32,
    partial masks, 30 Sinkhorn iterations. Image 1 holds most of image 0's
    keypoints, shuffled and shifted, with noisy descriptors."""
    rng = np.random.default_rng(5)
    n_blocks, dim, kenc = 2, 64, (3, 32, 64)
    params = _jax_params(rng, n_blocks, dim, kenc)
    model = _model_from_jax(params, n_blocks, dim, kenc)
    B, M, N = 2, 96, 80
    kpts0 = (rng.uniform(size=(B, M, 2)) * [640, 480]).astype(np.float32)
    desc0 = rng.normal(size=(B, M, dim)).astype(np.float32)
    perm = np.stack([rng.permutation(M)[:N] for _ in range(B)])
    kpts1 = (np.take_along_axis(kpts0, perm[..., None], 1) + [12.0, -7.0]).astype(np.float32)
    desc1 = (np.take_along_axis(desc0, perm[..., None], 1)
             + 0.2 * rng.normal(size=(B, N, dim))).astype(np.float32)
    scores0 = rng.uniform(size=(B, M)).astype(np.float32)
    scores1 = rng.uniform(size=(B, N)).astype(np.float32)
    mask0 = np.arange(M)[None] < np.array([[M], [70]])
    mask1 = np.arange(N)[None] < np.array([[60], [N]])
    size0 = np.array([[640.0, 480.0]] * B, np.float32)
    size1 = np.array([[652.0, 473.0]] * B, np.float32)
    args = (kpts0, kpts1, scores0, scores1, desc0, desc1, mask0, mask1, size0, size1)
    ref = jsg.forward(params, *(jnp.asarray(a) for a in args), num_heads=4,
                      sinkhorn_iterations=30, match_threshold=0.05,
                      compute_dtype="float32", attn_impl="xla")
    got = tsg.forward(model, *(torch.from_numpy(a) for a in args),
                      sinkhorn_iterations=30, match_threshold=0.05)
    ref_m, ref_v, ref_s = (np.asarray(ref[k]) for k in ("matches0", "valid0",
                                                        "matching_scores0"))
    got_m, got_v, got_s = (got[k].numpy() for k in ("matches0", "valid0", "matching_scores0"))
    assert ref_v.sum() > 20
    np.testing.assert_array_equal(got_v, ref_v)
    np.testing.assert_array_equal(got_m, ref_m)
    # f32 on both sides, sums in another order, through 4 layers and the OT
    np.testing.assert_allclose(got_s[ref_v], ref_s[ref_v], atol=1e-5, rtol=1e-4)


def test_masked_optimal_transport_matches_jax():
    """The log-coupling itself on valid entries and dustbins, the OT with
    masked marginals as the JAX package writes it."""
    rng = np.random.default_rng(6)
    B, M, N = 2, 96, 128
    scores = rng.normal(size=(B, M, N)).astype(np.float32)
    mask0 = np.arange(M)[None] < np.array([[80], [M]])
    mask1 = np.arange(N)[None] < np.array([[N], [100]])
    ref = np.asarray(jsg.masked_log_optimal_transport(
        jnp.asarray(scores), jnp.asarray(mask0), jnp.asarray(mask1), jnp.asarray(0.7), 30,
        impl="xla"))
    got = tsg.masked_log_optimal_transport(
        torch.from_numpy(scores), torch.from_numpy(mask0), torch.from_numpy(mask1),
        torch.tensor(0.7), 30).numpy()
    valid = np.zeros((B, M + 1, N + 1), bool)
    valid[:, :M, :N] = mask0[:, :, None] & mask1[:, None, :]
    valid[:, :M, N] = mask0
    valid[:, M, :N] = mask1
    valid[:, M, N] = True
    # the JAX package's jax.nn.logsumexp against the streaming lse, 30
    # iterations in f32
    np.testing.assert_allclose(got[valid], ref[valid], atol=1e-4)
