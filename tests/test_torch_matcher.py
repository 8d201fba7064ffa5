"""The port's batched matcher: out-of-memory bisection, nothing else
swallowed, and the padded store's descriptor layout."""

import numpy as np
import pytest
import torch

from deep_image_matching_tpu_torch.config import Config
from deep_image_matching_tpu_torch.io.h5 import list_pairs, save_features
from deep_image_matching_tpu_torch.matchers.matcher_base import (
    BatchedMatcher,
    _PaddedFeatureStore,
)


class _IdentityMatcher(BatchedMatcher):
    """Matches keypoint i to keypoint i; fails like a device that runs out
    of memory above ``fits`` pairs, or with another error when asked."""

    fits = 2
    error = None

    def _match_batch_arrays(self, batch0, batch1):
        B, K = batch0["mask"].shape
        self.batch_sizes.append(B)
        if self.error is not None:
            raise self.error
        if B > self.fits:
            raise torch.cuda.OutOfMemoryError("simulated")
        matches0 = torch.arange(K, dtype=torch.int32).expand(B, K)
        return matches0, batch0["mask"] & batch1["mask"]


def _setup(tmp_path, n_images=4):
    (tmp_path / "images").mkdir()
    cfg = Config(args={"dir": str(tmp_path), "pipeline": "superpoint+lightglue",
                       "strategy": "bruteforce", "skip_reconstruction": True})
    matcher = _IdentityMatcher({"general": {**cfg.general, "tpu": {
        **cfg.general["tpu"], "device": "cpu", "match_batch_size": 8}}, "matcher": {}})
    matcher.batch_sizes = []
    rng = np.random.default_rng(0)
    kpts = rng.uniform(0, 500, (64, 2)).astype(np.float32)
    names = [f"im{i}.jpg" for i in range(n_images)]
    matcher.feature_cache = {
        n: {"keypoints": kpts, "descriptors": rng.random((64, 8), dtype=np.float32),
            "scores": np.ones(64, np.float32), "image_size": np.array([500, 500])}
        for n in names
    }
    pairs = [(a, b) for i, a in enumerate(names) for b in names[i + 1:]]
    return matcher, pairs, tmp_path / "matches.h5"


def test_out_of_memory_bisects_until_the_batch_fits(tmp_path):
    matcher, pairs, mpath = _setup(tmp_path)
    results = matcher.match_all(pairs, tmp_path / "features.h5", mpath)
    assert set(results) == set(pairs)
    # 6 pairs at batch 8: OOM at 6, then 3 (OOM) -> 1 + 2, twice
    assert matcher.batch_sizes == [6, 3, 1, 2, 3, 1, 2]
    # identical keypoints: every match is an inlier
    assert all(v == 64 for v in results.values())
    assert sorted(list_pairs(mpath)) == sorted(pairs)


def test_other_errors_and_single_pair_oom_propagate(tmp_path):
    matcher, pairs, mpath = _setup(tmp_path)
    matcher.error = RuntimeError("device fault")
    with pytest.raises(RuntimeError, match="device fault"):
        matcher.match_all(pairs, tmp_path / "features.h5", mpath)
    matcher.error = None
    matcher.fits = 0
    with pytest.raises(torch.cuda.OutOfMemoryError):
        matcher.match_all(pairs, tmp_path / "features.h5", mpath)


@pytest.mark.parametrize("source", ["file", "cache"])
def test_store_takes_the_descriptor_layout_from_its_source(tmp_path, source):
    """An image with exactly D keypoints has a square descriptor matrix; the
    store must not guess its layout from the shape. features.h5 holds (D, N),
    the in-memory cache (N, D) rows."""
    rng = np.random.default_rng(1)
    D = 128
    path = tmp_path / "features.h5"
    feats = {}
    for name, n in (("square.jpg", D), ("other.jpg", 300)):
        kpts = rng.uniform(0, 500, (n, 2)).astype(np.float32)
        # integer-valued, as SIFT's: exact in the float16 file
        desc = rng.integers(0, 256, (n, D)).astype(np.float32)
        save_features(path, name, keypoints=kpts, descriptors=desc,
                      scores=np.ones(n, np.float32), image_size=np.array([500, 500]))
        feats[name] = {"keypoints": kpts, "descriptors": desc}
    names = sorted(feats)
    cache = feats if source == "cache" else None
    store = _PaddedFeatureStore(path, names, torch.device("cpu"), cache=cache)
    for name in names:
        i, n = store.index[name], len(feats[name]["keypoints"])
        np.testing.assert_array_equal(store.dev["descriptors"][i, :n].numpy(),
                                      feats[name]["descriptors"])
        assert not store.dev["descriptors"][i, n:].any()
