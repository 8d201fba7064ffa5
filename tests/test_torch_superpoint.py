"""The port's SuperPoint against the JAX package's under the same weights
(JAX parameters carried across with ``superpoint_params_from_jax``)."""

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_image_matching_tpu.models import superpoint as jsp
from deep_image_matching_tpu_torch.convert import superpoint_params_from_jax
from deep_image_matching_tpu_torch.models import superpoint as tsp


@pytest.fixture(scope="module")
def weights():
    params = jsp.init_params(jax.random.PRNGKey(0))
    model = tsp.SuperPoint()
    model.load_state_dict(superpoint_params_from_jax(params))
    return params, model.eval()


def _images():
    """Two textured grayscale images in one (2, 240, 320, 1) batch; the
    second fills only 200 x 256 of it (zero padding)."""
    rng = np.random.default_rng(0)
    base = cv2.GaussianBlur(rng.integers(0, 256, (480, 640), dtype=np.uint8), (0, 0), 2)
    base = cv2.normalize(base, None, 0, 255, cv2.NORM_MINMAX)
    batch = np.zeros((2, 240, 320, 1), np.uint8)
    batch[0, :, :, 0] = base[:240, :320]
    batch[1, :200, :256, 0] = base[100:300, 200:456]
    return batch, np.array([[240, 320], [200, 256]], np.int32)


def test_params_round_trip(weights):
    params, _ = weights
    back = jsp.params_from_torch(superpoint_params_from_jax(params))
    for name in params:
        for k in ("w", "b"):
            np.testing.assert_array_equal(np.asarray(back[name][k]), np.asarray(params[name][k]))


def test_dense_forward_matches_jax(weights):
    params, model = weights
    batch, _ = _images()
    ref_s, ref_d = (np.asarray(a) for a in jsp.dense_forward(params, jnp.asarray(batch)))
    got_s, got_d = (a.numpy() for a in tsp.dense_forward(model, torch.from_numpy(batch)))
    assert got_s.shape == ref_s.shape and got_d.shape == ref_d.shape
    # f32 convolutions in another summation order (XLA vs oneDNN)
    np.testing.assert_allclose(got_s, ref_s, atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(got_d, ref_d, atol=1e-4, rtol=1e-4)


def test_extract_matches_jax(weights):
    params, model = weights
    batch, vhw = _images()
    kw = dict(max_keypoints=256, nms_radius=3, keypoint_threshold=0.0005, remove_borders=4)
    ref = {k: np.asarray(v) for k, v in
           jsp.extract(params, jnp.asarray(batch), jnp.asarray(vhw), **kw).items()}
    got = {k: v.numpy() for k, v in
           tsp.extract(model, torch.from_numpy(batch), torch.from_numpy(vhw), **kw).items()}
    for b in range(2):
        rv, gv = ref["mask"][b], got["mask"][b]
        assert rv.sum() == gv.sum() > 50
        # the same keypoints as sets (top-k may order near-equal scores
        # differently); then per keypoint, scores and descriptors
        rk = {tuple(p): i for i, p in enumerate(ref["keypoints"][b][rv])}
        gk = {tuple(p): i for i, p in enumerate(got["keypoints"][b][gv])}
        assert rk.keys() == gk.keys()
        ri = np.array([rk[p] for p in gk])
        gi = np.array([gk[p] for p in gk])
        np.testing.assert_allclose(got["scores"][b][gv][gi], ref["scores"][b][rv][ri],
                                   atol=1e-6, rtol=1e-4)
        np.testing.assert_allclose(got["descriptors"][b][gv][gi],
                                   ref["descriptors"][b][rv][ri], atol=1e-4)
        # padded rows: zero coordinates, scores and descriptors
        assert not got["keypoints"][b][~gv].any() and not got["descriptors"][b][~gv].any()
