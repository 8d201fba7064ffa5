"""RDD's ``extract`` in the port against the JAX package on the CPU, on the
demo image of ``test_torch_rdd.image`` with the seeded parameters of
``test_torch_rdd.params``: keypoints equal as sets within 1e-4 px, scores
within 1e-5, descriptors within 1e-4, zeros on invalid rows. In a file of
its own so that a test worker takes it beside the module tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_image_matching_tpu.models import rdd as jrdd
from deep_image_matching_tpu_torch.models import rdd as trdd

from test_torch_aliked import _same_rows
from test_torch_rdd import image, params  # noqa: F401  (module fixtures)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread for this file: in a test worker beside busy others
    each parallel op waits on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rdd_extract_matches_jax(params, image):
    p, _, tp = params
    img, vhw = image
    ref = jrdd.extract(p, jnp.asarray(img), jnp.asarray(vhw), max_keypoints=512,
                       detection_threshold=0.01)
    got = trdd.extract(tp, torch.from_numpy(img), torch.from_numpy(vhw.astype(np.int64)),
                       max_keypoints=512, detection_threshold=0.01)
    rm, gm = np.asarray(ref["mask"][0]), got["mask"][0].numpy()
    assert rm.sum() == gm.sum() > 100
    rk, gk = np.asarray(ref["keypoints"][0])[rm], got["keypoints"][0].numpy()[gm]
    assert (rk[:, 0] < 150).all() and (rk[:, 1] < 120).all()
    idx = _same_rows(rk, gk, 1e-4)
    np.testing.assert_allclose(got["scores"][0].numpy()[gm][idx],
                               np.asarray(ref["scores"][0])[rm], atol=1e-5)
    np.testing.assert_allclose(got["descriptors"][0].numpy()[gm][idx],
                               np.asarray(ref["descriptors"][0])[rm], atol=1e-4)
    assert not got["descriptors"][0].numpy()[~gm].any()
