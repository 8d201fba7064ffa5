"""Extractor base: configuration, quality resize, feature cache and the
per-image template.

Port of ``deep_image_matching_tpu/extractors/extractor_base.py`` for untiled
extraction: the configuration, the quality resize, the in-memory
``feature_cache`` handed to the matcher (h5-roundtrip-exact values), the
reflection loader, and the per-image template of the host extractors (SIFT,
ORB): load (``grayscale`` / ``as_float``) -> quality resize -> ``_extract``
-> trim -> keypoints back to full resolution -> features.h5. Tiled
extraction and the device-resident extract->match handoff are not ported
yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import inspect
import logging
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np

from ..constants import Quality, TileSelection, get_size_by_quality
from ..io.writer import AsyncFeatureWriter
from ..utils.image import Image, read_image, resize_image

logger = logging.getLogger("dim_tpu_torch")

FeaturesDict = Dict[str, np.ndarray]


class ExtractorBase:
    default_conf: Dict = {}
    grayscale: bool = True
    as_float: bool = True
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

    # ------------------------------------------------------------------ API
    def extract(self, img: Union[Image, Path, str]) -> FeaturesDict:
        """Features of one image at the configured quality, in
        full-resolution coordinates (not yet written to h5)."""
        if not isinstance(img, Image):
            img = Image(img)
        image = self._load(img)
        orig_hw = image.shape[:2]
        image = self._quality_resize(image)
        feats = self._trim(self._extract(image))
        feats = self._rescale_features(feats, image.shape[:2], orig_hw)
        feats["image_size"] = np.array([orig_hw[1], orig_hw[0]], dtype=np.int64)
        return feats

    def extract_batch(self, images: List[Image], feature_path) -> None:
        """Extract features for ``images`` into ``feature_path`` (and
        ``feature_cache``). Host extractors run image by image, with the
        file written by one background writer; device extractors override
        this with a padded batched program."""
        with AsyncFeatureWriter(feature_path) as writer:
            for img in images:
                feats = self.extract(img)
                writer.put(img.name, **self._h5_arrays(feats))
                self._cache_put(img.name, **self._h5_arrays(feats))

    @staticmethod
    def _h5_arrays(feats: FeaturesDict) -> FeaturesDict:
        return {k: feats[k] for k in ("keypoints", "descriptors", "scores", "image_size")
                if k in feats}

    # -------------------------------------------------------------- template
    def _extract(self, image: np.ndarray) -> FeaturesDict:
        """Subclass hook: image (H, W) or (H, W, 3) -> FeaturesDict with
        ``keypoints (N, 2)``, optional ``descriptors (N, D)`` and ``scores
        (N,)``. N may be a padded capacity if ``n_valid`` is also returned."""
        raise NotImplementedError

    def _load(self, img: Image) -> np.ndarray:
        image = read_image(img.path, grayscale=self.grayscale)
        if self.as_float:
            image = image.astype(np.float32) / 255.0
        return image

    def _quality_resize(self, image: np.ndarray) -> np.ndarray:
        if self.quality is Quality.HIGH:
            return image
        h, w = image.shape[:2]
        new_w, new_h = get_size_by_quality(self.quality, (w, h))
        return resize_image(image, (max(new_w, 1), max(new_h, 1)))

    @staticmethod
    def _trim(feats: FeaturesDict) -> FeaturesDict:
        """Trim capacity padding using ``n_valid`` if present."""
        n = feats.pop("n_valid", None)
        if n is None:
            return feats
        n = int(n)
        return {k: (v[:n] if k in ("keypoints", "descriptors", "scores") else v)
                for k, v in feats.items()}

    @staticmethod
    def _rescale_features(feats: FeaturesDict, cur_hw, orig_hw) -> FeaturesDict:
        if tuple(cur_hw) == tuple(orig_hw):
            return feats
        sx = orig_hw[1] / cur_hw[1]
        sy = orig_hw[0] / cur_hw[0]
        feats = dict(feats)
        feats["keypoints"] = feats["keypoints"] * np.array([sx, sy], np.float32)
        return feats


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
