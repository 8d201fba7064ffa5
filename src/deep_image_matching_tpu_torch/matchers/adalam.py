"""AdaLAM matcher (port of ``deep_image_matching_tpu/matchers/adalam.py``).

The reference's ``adalam`` matcher (kornia's ``GeometryAwareDescriptorMatcher``
in adalam mode) with the JAX package's two modes:

- ``match_mode: adalam`` (the default, the exact algorithm): mutual nearest
  neighbours with their Lowe ratios (``ops/nn_match.py::nn_match_with_ratios``,
  no ratio gate: AdaLAM's own filter decides), then ``ops/adalam.py`` per
  pair with the seed mutuality and the image sizes; each batch's samples
  are drawn from a CPU ``torch.Generator`` seeded with ``seed`` and moved to
  the device (``_samples``; the JAX package draws from ``jax.random`` keys,
  so the two packages agree where the samples are carried across);
- ``match_mode: adalam_fast``: symmetric nearest neighbours with the ratio
  ``th``, then the dense motion-consistency vote, an approximation the user
  opts into.

Both filters are plain tensor arithmetic on the device, as the JAX
package's are XLA; geometric verification after them runs on kernel 4.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..ops.adalam import adalam_filter, motion_consistency_filter
from ..ops.nn_match import nn_match_batch, nn_match_with_ratios
from .matcher_base import BatchedMatcher


class AdalamMatcher(BatchedMatcher):
    default_conf = {
        "match_mode": "adalam",   # "adalam" (exact) | "adalam_fast" (vote)
        "th": 0.8,
        # the exact filter's knobs (kornia's AdalamConfig defaults)
        "area_ratio": 100.0,
        "search_expansion": 4.0,
        "ransac_iters": 128,
        "min_inliers": 6,
        "min_confidence": 200.0,
        "seed": 0,
        # adalam_fast's knobs
        "radius_frac": 0.1,
        "tolerance": 0.35,
        "min_votes": 4,
    }

    def __init__(self, config: dict):
        super().__init__(config)
        self.mode = str(self.conf.get("match_mode", "adalam"))
        if self.mode not in ("adalam", "adalam_fast"):
            raise ValueError(f"adalam match_mode {self.mode!r}; expected adalam or adalam_fast")

    def _match_batch_arrays(
        self, batch0: Dict[str, torch.Tensor], batch1: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.conf
        k0, k1 = batch0["keypoints"], batch1["keypoints"]
        if self.mode == "adalam_fast":
            matches0, valid = nn_match_batch(
                batch0["descriptors"], batch1["descriptors"], batch0["mask"], batch1["mask"],
                mode="smnn", ratio_th=float(c.get("th", 0.8)))
            keep = torch.stack([
                motion_consistency_filter(
                    k0[b], k1[b], matches0[b], valid[b],
                    radius_frac=float(c.get("radius_frac", 0.1)),
                    tolerance=float(c.get("tolerance", 0.35)),
                    min_votes=int(c.get("min_votes", 4)))
                for b in range(matches0.shape[0])])
            return matches0, keep
        matches0, valid, ratios, mutual = nn_match_with_ratios(
            batch0["descriptors"], batch1["descriptors"], batch0["mask"], batch1["mask"],
            mode="mnn")
        iters = int(c.get("ransac_iters", 128))
        samples = self._samples(matches0.shape[0], k0.shape[1], iters, k0.device)
        wh0, wh1 = batch0["image_size"].float(), batch1["image_size"].float()
        keep = torch.stack([
            adalam_filter(
                k0[b], k1[b], matches0[b], valid[b], ratios[b], wh0[b], wh1[b],
                samples=samples[b], mnn=mutual[b],
                area_ratio=float(c.get("area_ratio", 100.0)),
                search_expansion=float(c.get("search_expansion", 4.0)),
                ransac_iters=iters,
                min_inliers=int(c.get("min_inliers", 6)),
                min_confidence=float(c.get("min_confidence", 200.0)))
            for b in range(matches0.shape[0])])
        return matches0, keep

    def _samples(self, B: int, K: int, iters: int, device: torch.device) -> list:
        """Per pair of a batch of B at keypoint capacity K, the filter's
        RANSAC samples (S, iters, 2) in [0, M) (S seeds, M neighbours, both
        min(256, K)), drawn from a CPU generator seeded with the config's
        ``seed`` for every batch, so every device gets the same draws, and
        moved to ``device``."""
        gen = torch.Generator().manual_seed(int(self.conf.get("seed", 0)))
        S, M = min(256, K), min(256, K)
        return [torch.randint(0, M, (S, iters, 2), generator=gen).to(device)
                for _ in range(B)]
