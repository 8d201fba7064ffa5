"""The port's LightGlue against the JAX package's under the same weights:
the fixed-depth path and the adaptive depth + width path, with full and
padded masks, at 2 layers, width 64 and K = 128, in f32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_image_matching_tpu.models import lightglue as jlg
from deep_image_matching_tpu_torch.convert import lightglue_params_from_jax
from deep_image_matching_tpu_torch.models import lightglue as tlg

B, K, DIM, LAYERS = 2, 128, 64, 2


def _params(input_dim=DIM, token_bias=None, match_bias=None):
    p = jlg.init_params(jax.random.PRNGKey(1), n_layers=LAYERS, dim=DIM, num_heads=4,
                        input_dim=input_dim)
    layers = dict(p["layers"])
    if token_bias is not None:  # layer 0's token-confidence logit offset
        layers["token"] = {**layers["token"], "b": layers["token"]["b"].at[0].set(token_bias)}
    if match_bias is not None:  # layer 0's matchability logit offset
        assign = dict(layers["assign"])
        assign["match"] = {**assign["match"], "b": assign["match"]["b"].at[0].set(match_bias)}
        layers["assign"] = assign
    return {**p, "layers": layers}


def _port(params, input_dim=DIM):
    model = tlg.LightGlue(n_layers=LAYERS, dim=DIM, num_heads=4, input_dim=input_dim)
    model.load_state_dict(lightglue_params_from_jax(params))
    return model.eval()


def _inputs(padded: bool, input_dim=DIM):
    """Image 1 holds image 0's keypoints permuted and shifted, with noisy
    copies of its descriptors, so there are real mutual matches."""
    rng = np.random.default_rng(0)
    kpts0 = (rng.random((B, K, 2)) * [320, 240]).astype(np.float32)
    perm = np.stack([rng.permutation(K) for _ in range(B)])
    kpts1 = np.take_along_axis(kpts0, perm[..., None], 1) + np.float32([12, -8])
    desc0 = rng.normal(size=(B, K, input_dim)).astype(np.float32)
    desc0 /= np.linalg.norm(desc0, axis=-1, keepdims=True)
    desc1 = np.take_along_axis(desc0, perm[..., None], 1)
    desc1 = desc1 + 0.1 * rng.normal(size=desc1.shape).astype(np.float32)
    mask0 = np.ones((B, K), bool)
    if padded:
        mask0[1, 100:] = False
        kpts0[1, 100:] = 0.0
    mask1 = np.take_along_axis(mask0, perm, 1)
    size = np.tile(np.float32([[320, 240]]), (B, 1))
    return kpts0, kpts1, desc0, desc1, mask0, mask1, size, size


def _run_both(params, inputs, input_dim=DIM, **kw):
    ref = jlg.forward(params, *(jnp.asarray(a) for a in inputs), num_heads=4,
                      compute_dtype="float32", attn_impl="xla", assignment_impl="dense", **kw)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = tlg.forward(_port(params, input_dim), *(torch.from_numpy(a) for a in inputs),
                      compute_dtype=torch.float32, **kw)
    return ref, got


def _assert_same(ref, got):
    assert int(got["layers_run"]) == int(ref["layers_run"])
    np.testing.assert_array_equal(got["valid0"].numpy(), ref["valid0"])
    np.testing.assert_array_equal(got["matches0"].numpy(), ref["matches0"])
    v = ref["valid0"]
    # f32 on both sides, summation order differs
    np.testing.assert_allclose(got["matching_scores0"].numpy()[v], ref["matching_scores0"][v],
                               atol=1e-4)


def test_params_round_trip():
    params = _params(input_dim=32)
    back = jlg.params_from_torch(lightglue_params_from_jax(params), n_layers=LAYERS)
    # the JAX tree's last token head is padding (zeros after the trip)
    params["layers"]["token"] = jax.tree.map(lambda x: x.at[-1].set(0.0), params["layers"]["token"])
    flat_p, tree_p = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_p == tree_b
    for a, b in zip(flat_p, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("padded", [False, True])
def test_fixed_depth_matches_jax(padded):
    ref, got = _run_both(_params(), _inputs(padded), depth_confidence=-1.0,
                         width_confidence=-1.0)
    assert ref["valid0"].sum() > 20
    _assert_same(ref, got)


def test_input_projection_matches_jax():
    ref, got = _run_both(_params(input_dim=32), _inputs(True, input_dim=32), input_dim=32,
                         depth_confidence=-1.0, width_confidence=-1.0)
    _assert_same(ref, got)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("case", ["default", "early_exit", "pruning"])
def test_adaptive_matches_jax(case, padded):
    kw = dict(depth_confidence=0.95, width_confidence=0.99, pruning_min_kpts=16)
    if case == "early_exit":
        # every token confident after layer 0: the batch exits there
        params = _params(token_bias=10.0)
    elif case == "pruning":
        # confident but unmatchable points after layer 0 are pruned; the
        # stop threshold is out of reach so layer 1 runs on pruned masks
        params = _params(token_bias=3.0, match_bias=-4.6)
        kw["depth_confidence"] = 0.9999
    else:
        params = _params()
    ref, got = _run_both(params, _inputs(padded), **kw)
    _assert_same(ref, got)
    if case == "early_exit":
        assert int(ref["layers_run"]) == 1
    if case == "pruning":
        unpruned = tlg.forward(_port(params), *(torch.from_numpy(a) for a in _inputs(padded)),
                               **{**kw, "width_confidence": -1.0})
        # pruned points leave attention and the assignment's softmaxes
        assert not torch.allclose(got["matching_scores0"], unpruned["matching_scores0"])


def test_log_assignment_and_filter_match_jax():
    params = _params()
    kpts0, kpts1, desc0, desc1, mask0, mask1, _, _ = _inputs(True)
    p = {k: v for k, v in _port(params).state_dict().items()}
    jp = jax.tree.map(lambda x: x[0], params["layers"])["assign"]
    ref = np.asarray(jlg._log_assignment(jnp.asarray(desc0), jnp.asarray(desc1),
                                         jnp.asarray(mask0), jnp.asarray(mask1), jp))
    got = tlg._log_assignment(torch.from_numpy(desc0), torch.from_numpy(desc1),
                              torch.from_numpy(mask0), torch.from_numpy(mask1), p, 0)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-5)
    ref_f = [np.asarray(a) for a in jlg.filter_matches_static(
        jnp.asarray(ref), jnp.asarray(mask0), jnp.asarray(mask1), 0.01)]
    got_f = [a.numpy() for a in tlg.filter_matches_static(
        torch.tensor(ref), torch.from_numpy(mask0), torch.from_numpy(mask1), 0.01)]
    np.testing.assert_array_equal(got_f[0], ref_f[0])
    np.testing.assert_array_equal(got_f[2], ref_f[2])
    np.testing.assert_allclose(got_f[1], ref_f[1], rtol=1e-6)
