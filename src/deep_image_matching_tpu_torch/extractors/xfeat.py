"""XFeat extractor (port of ``deep_image_matching_tpu/extractors/xfeat.py``).

The reference's config surface (``max_num_keypoints``,
``detection_threshold``). Images go to the device as uint8 (the model's
input instance norm makes the scale irrelevant), bucketed by their shape
padded to multiples of 32 and extracted in batches of
``general.tpu.extract_batch_size`` on the configured device; the keypoint
capacity is ``max_num_keypoints`` rounded up to 128. With ``--tiling`` the
tiles take the host template. Weights: ``xfeat.pt`` in DIM_TPU_WEIGHTS_DIR
or ~/.cache/dim_tpu, else seeded random weights under the weights policy.
Inside ``ImageMatcher`` an untiled run decodes and uploads the images on the
prefetch pool (``utils/prefetch.py``), pads and stacks them on the device
and keeps the outputs there for the matcher (the device handoff,
``ExtractorBase._arm_device_handoff``).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..constants import TileSelection
from ..io.writer import AsyncFeatureWriter
from ..models import xfeat as xfeat_model
from ..ops.assemble import padded_batches
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
        if self._device_handoff_allowed():
            return self._extract_handoff(images, feature_path)
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
        return super()._run([a.mean(-1) if a.ndim == 3 else a for a in arrays])

    def _device_batches(self, images):
        """Grey images on the host or the device as padded batches
        (multiples of 32) -> (indices, padded device outputs) per batch."""
        cap = -(-self.top_k // 128) * 128
        return padded_batches(
            images, 32, 1, self.batch_size,
            lambda batch, vhw: xfeat_model.extract(
                self.model, batch, vhw, top_k=cap,
                detection_threshold=self.detection_threshold),
            self.device)
