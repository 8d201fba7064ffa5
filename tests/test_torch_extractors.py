"""The host extractors (SIFT, ORB) and the per-image extractor template
against the JAX package: the same OpenCV code on the same image must give
the same features, and the template's load, quality resize and rescale to
full resolution must match. ``extract_batch`` must write what ``extract``
gives and mirror the file in the feature cache."""

from pathlib import Path

import numpy as np
import pytest

from deep_image_matching_tpu import constants as jc
from deep_image_matching_tpu.extractors.orb import ORBExtractor as JORB
from deep_image_matching_tpu.extractors.sift import SIFTExtractor as JSIFT
from deep_image_matching_tpu_torch import constants as tc
from deep_image_matching_tpu_torch.extractors.orb import ORBExtractor as TORB
from deep_image_matching_tpu_torch.extractors.sift import SIFTExtractor as TSIFT
from deep_image_matching_tpu_torch.io.h5 import get_features
from deep_image_matching_tpu_torch.utils.image import Image

IMAGE = (Path(__file__).resolve().parents[1] / "notebooks" / "demo_project" / "images"
         / "sacre_coeur_A.jpg")
EXTRACTORS = {"sift": (JSIFT, TSIFT, 128), "orb": (JORB, TORB, 32)}


@pytest.mark.parametrize("name", list(EXTRACTORS))
def test_host_extractor_matches_jax_at_reduced_quality(name):
    jcls, tcls, dim = EXTRACTORS[name]
    conf = {"extractor": {"n_features": 1000}}
    jf = jcls({**conf, "general": {"quality": jc.Quality.LOW}}).extract(IMAGE)
    tf = tcls({**conf, "general": {"quality": tc.Quality.LOW}}).extract(IMAGE)
    assert set(tf) == set(jf) == {"keypoints", "descriptors", "scores", "image_size"}
    for k in jf:
        np.testing.assert_array_equal(tf[k], jf[k])
    # half-resolution extraction, keypoints back in full-resolution pixels
    np.testing.assert_array_equal(tf["image_size"], [640, 480])
    assert tf["descriptors"].shape == (len(tf["keypoints"]), dim) and len(tf["keypoints"]) > 100
    assert tf["keypoints"][:, 0].max() > 320


@pytest.mark.parametrize("name", list(EXTRACTORS))
def test_extract_batch_writes_extract_and_mirrors_the_file_in_the_cache(tmp_path, name):
    _, tcls, _ = EXTRACTORS[name]
    conf = {"extractor": {"n_features": 500}, "general": {}}
    ext = tcls(conf)
    ext.feature_cache = {}
    feats = ext.extract(IMAGE)
    ext.extract_batch([Image(IMAGE)], tmp_path / "features.h5")
    got = get_features(tmp_path / "features.h5", IMAGE.name)
    assert set(got) == set(feats)
    np.testing.assert_array_equal(got["keypoints"], feats["keypoints"])
    np.testing.assert_array_equal(got["image_size"], feats["image_size"])
    # the file holds (D, N) float16 descriptors
    np.testing.assert_array_equal(
        got["descriptors"], feats["descriptors"].T.astype(np.float16).astype(np.float32))
    # the cache holds (N, D) rows with the file's float16-rounded values
    cache = ext.feature_cache[IMAGE.name]
    assert set(cache) == set(got)
    np.testing.assert_array_equal(cache["descriptors"], got["descriptors"].T)
    for k in ("keypoints", "scores", "image_size"):
        np.testing.assert_array_equal(cache[k], got[k])
