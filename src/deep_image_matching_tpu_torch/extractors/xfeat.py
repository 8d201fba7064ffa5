"""XFeat extractor (port of ``deep_image_matching_tpu/extractors/xfeat.py``).

The reference's config surface (``max_num_keypoints``,
``detection_threshold``). Images go to the device as uint8 (the model's
input instance norm makes the scale irrelevant), bucketed by their shape
padded to multiples of 32 and extracted in batches of
``general.tpu.extract_batch_size`` on the configured device; the keypoint
capacity is ``max_num_keypoints`` rounded up to 128. With ``--tiling`` the
tiles take the host template. Weights: ``xfeat.pt`` in DIM_TPU_WEIGHTS_DIR
or ~/.cache/dim_tpu, else seeded random weights under the weights policy.
The JAX package's device handoff (features kept on the device for the
matcher) is not ported (ROADMAP.md, queue 1, item 8).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..constants import TileSelection
from ..io.writer import AsyncFeatureWriter
from ..models import xfeat as xfeat_model
from ..utils.device import resolve_device
from ..utils.image import Image, read_image
from .extractor_base import ExtractorBase, FeaturesDict

logger = logging.getLogger("dim_tpu_torch")

_MODEL: Optional[xfeat_model.XFeat] = None
_MODEL_RANDOM = False


def load_model() -> xfeat_model.XFeat:
    """``xfeat.pt`` if present, else seeded random weights (the weights
    policy decides); cached random weights re-consult the policy."""
    global _MODEL, _MODEL_RANDOM
    from ..utils.weights import missing_weights, reject_cached_random

    if _MODEL is not None:
        if _MODEL_RANDOM:
            reject_cached_random("XFeat", ["xfeat.pt"])
        return _MODEL
    wdir = os.environ.get("DIM_TPU_WEIGHTS_DIR")
    for base in ([Path(wdir)] if wdir else []) + [Path.home() / ".cache/dim_tpu"]:
        cand = base / "xfeat.pt"
        if cand.exists():
            _MODEL = xfeat_model.params_from_torch(torch.load(str(cand), map_location="cpu"))
            logger.info(f"Loaded XFeat weights from {cand}")
            return _MODEL
    missing_weights("XFeat", ["xfeat.pt"])
    _MODEL = xfeat_model.XFeat().reset_random(torch.Generator().manual_seed(3)).eval()
    _MODEL_RANDOM = True
    return _MODEL


class XFeatExtractor(ExtractorBase):
    default_conf = {
        "max_num_keypoints": 4096,
        "detection_threshold": 0.05,
    }
    grayscale = True
    as_float = True
    descriptor_size = 64

    def __init__(self, config: dict):
        super().__init__(config)
        tpu = self.config.get("general", {}).get("tpu", {})
        self.device = resolve_device(tpu.get("device", "auto"))
        self.model = load_model().to(self.device)
        self.top_k = int(self.conf.get("max_num_keypoints", 4096))
        self.detection_threshold = float(self.conf.get("detection_threshold", 0.05))
        self.batch_size = int(tpu.get("extract_batch_size", 8))

    def extract_batch(self, images: List[Image], feature_path) -> None:
        if self.tile_selection is not TileSelection.NONE:
            return super().extract_batch(images, feature_path)
        prepped = []
        for img in images:
            arr = read_image(img.path, grayscale=True)
            h, w = arr.shape
            prepped.append((self._quality_resize(arr), (w, h)))
        results = self._run([arr for arr, _ in prepped])
        with AsyncFeatureWriter(feature_path) as writer:
            for img, (arr, (w, h)), feats in zip(images, prepped, results):
                ah, aw = arr.shape
                kpts = feats["keypoints"] * np.array([w / aw, h / ah], np.float32)
                size = np.array([w, h], np.int64)
                writer.put(img.name, keypoints=kpts, descriptors=feats["descriptors"],
                           scores=feats["scores"], image_size=size)
                self._cache_put(img.name, keypoints=kpts, descriptors=feats["descriptors"],
                                scores=feats["scores"], image_size=size)

    def _extract(self, image: np.ndarray) -> FeaturesDict:
        return self._run([image])[0]

    def _run(self, arrays: list) -> list:
        """Grey images (h, w) (or (h, w, 3), averaged) as padded batches per
        shape bucket -> per-image trimmed features."""
        arrays = [a.mean(-1) if a.ndim == 3 else a for a in arrays]
        cap = -(-self.top_k // 128) * 128
        buckets: Dict[tuple, list] = {}
        for i, arr in enumerate(arrays):
            h, w = arr.shape
            buckets.setdefault((-(-h // 32) * 32, -(-w // 32) * 32), []).append(i)
        dtype = np.uint8 if all(a.dtype == np.uint8 for a in arrays) else np.float32
        results = [None] * len(arrays)
        for (ph, pw), idxs in buckets.items():
            for start in range(0, len(idxs), self.batch_size):
                chunk = idxs[start:start + self.batch_size]
                batch = np.zeros((len(chunk), ph, pw, 1), dtype)
                vhw = np.zeros((len(chunk), 2), np.int64)
                for j, i in enumerate(chunk):
                    h, w = arrays[i].shape
                    batch[j, :h, :w, 0] = arrays[i]
                    vhw[j] = (h, w)
                out = xfeat_model.extract(
                    self.model, torch.from_numpy(batch).to(self.device),
                    torch.from_numpy(vhw).to(self.device), top_k=cap,
                    detection_threshold=self.detection_threshold)
                out = {k: v.cpu().numpy() for k, v in out.items()}
                for j, i in enumerate(chunk):
                    m = out["mask"][j]
                    results[i] = {"keypoints": out["keypoints"][j][m],
                                  "scores": out["scores"][j][m],
                                  "descriptors": out["descriptors"][j][m]}
        return results
