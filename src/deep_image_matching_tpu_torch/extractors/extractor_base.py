"""Extractor base: configuration, quality resize, feature cache.

Port of ``deep_image_matching_tpu/extractors/extractor_base.py`` for the
untiled batched path: the configuration, the quality resize, the in-memory
``feature_cache`` handed to the matcher (h5-roundtrip-exact values) and the
reflection loader. The per-image template used by the host extractors,
tiled extraction and the device-resident extract->match handoff are not
ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import inspect
import logging
from typing import Dict, List, Optional

import numpy as np

from ..constants import Quality, TileSelection, get_size_by_quality
from ..utils.image import Image, resize_image

logger = logging.getLogger("dim_tpu_torch")

FeaturesDict = Dict[str, np.ndarray]


class ExtractorBase:
    default_conf: Dict = {}
    descriptor_size: int = 0

    def __init__(self, config: dict):
        self.config = config
        extractor_conf = config.get("extractor", {})
        self.conf = {**self.default_conf, **extractor_conf}
        general = config.get("general", {})
        self.quality: Quality = general.get("quality", Quality.HIGH)
        self.tile_selection: TileSelection = general.get(
            "tile_selection", TileSelection.NONE
        )
        if self.tile_selection is not TileSelection.NONE:
            raise NotImplementedError(
                "Tiled extraction is not ported to the PyTorch package yet "
                "(ROADMAP.md, queue 1: tiling); run with --tiling none"
            )
        # in-memory extract->match handoff (set to {} by ImageMatcher):
        # features.h5 stays the durable artifact, the matcher in the same
        # process reads from here instead of decompressing it again
        self.feature_cache: Optional[Dict[str, FeaturesDict]] = None

    def _cache_put(
        self,
        name: str,
        keypoints: np.ndarray,
        descriptors: Optional[np.ndarray] = None,
        scores: Optional[np.ndarray] = None,
        image_size: Optional[np.ndarray] = None,
    ) -> None:
        """Mirror one image's features into ``feature_cache`` with exactly
        the values an h5 round trip gives (float16 descriptor and score
        storage, ``io/h5.py::save_features``)."""
        if self.feature_cache is None:
            return
        entry: FeaturesDict = {"keypoints": np.asarray(keypoints, np.float32)}
        if descriptors is not None:
            entry["descriptors"] = np.asarray(descriptors).astype(np.float16).astype(np.float32)
        if scores is not None:
            entry["scores"] = np.asarray(scores).astype(np.float16).astype(np.float32)
        if image_size is not None:
            entry["image_size"] = np.asarray(image_size).astype(np.int64)
        self.feature_cache[name] = entry

    def extract_batch(self, images: List[Image], feature_path) -> None:
        """Extract features for ``images`` into ``feature_path`` (and
        ``feature_cache``)."""
        raise NotImplementedError

    def _quality_resize(self, image: np.ndarray) -> np.ndarray:
        if self.quality is Quality.HIGH:
            return image
        h, w = image.shape[:2]
        new_w, new_h = get_size_by_quality(self.quality, (w, h))
        return resize_image(image, (max(new_w, 1), max(new_h, 1)))


def extractor_loader(root_module, name: str):
    """Find the ExtractorBase subclass defined in ``root_module.<name>``."""
    import importlib

    module = importlib.import_module(f"{root_module.__name__}.{name}")
    classes = [
        c for _, c in inspect.getmembers(module, inspect.isclass)
        if issubclass(c, ExtractorBase) and c is not ExtractorBase
        and c.__module__ == module.__name__
    ]
    if not classes:
        raise ImportError(f"No extractor class found in module '{name}'")
    return classes[0]
