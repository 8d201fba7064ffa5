"""Extractor base: configuration, quality resize, feature cache and the
per-image template.

Port of ``deep_image_matching_tpu/extractors/extractor_base.py``: the
configuration, the quality resize, the in-memory ``feature_cache`` handed to
the matcher (h5-roundtrip-exact values), the reflection loader, and the
per-image template of the host extractors (SIFT, ORB): load (``grayscale`` /
``as_float``) -> quality resize -> ``_extract`` (or, with ``--tiling``,
``_extract_by_tile``) -> trim -> keypoints back to full resolution ->
features.h5.

Tiled extraction has two routes. Extractors that override
``_extract_tiles_dev`` (SuperPoint) take the device route
(``_try_extract_batch_tiled_device``): each image uploads once as uint8, its
tiles are cut, extracted and merged on the extractor's device
(``ops/tile_merge.py``), and the merged features come back to the host for
features.h5 and ``feature_cache``. A failure there raises; it does not fall
back to the host route. The others (SIFT, ORB, ALIKED) take the host
template ``_extract_by_tile``. Both give every keypoint its ``tile_idx``.
The JAX package's device-resident extract->match handoff is not ported
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import inspect
import logging
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..constants import Quality, TileSelection, get_size_by_quality
from ..io.writer import AsyncFeatureWriter
from ..utils.image import Image, read_image, resize_image
from ..utils.tiling import Tiler

logger = logging.getLogger("dim_tpu_torch")

FeaturesDict = Dict[str, np.ndarray]


class ExtractorBase:
    default_conf: Dict = {}
    grayscale: bool = True
    as_float: bool = True
    descriptor_size: int = 0
    # device extractors whose model normalises uint8 itself set this, so the
    # host tiled template keeps the tiles uint8 as the untiled route does
    tile_uint8: bool = False

    def __init__(self, config: dict):
        self.config = config
        extractor_conf = config.get("extractor", {})
        self.conf = {**self.default_conf, **extractor_conf}
        general = config.get("general", {})
        self.quality: Quality = general.get("quality", Quality.HIGH)
        self.tile_selection: TileSelection = general.get(
            "tile_selection", TileSelection.NONE
        )
        self.tile_size = general.get("tile_size", (2400, 2000))
        self.tile_overlap = general.get("tile_overlap", 10)
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
        tile_idx: Optional[np.ndarray] = None,
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
        if tile_idx is not None:
            entry["tile_idx"] = np.asarray(tile_idx, np.float32)
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
        if self.tile_selection is TileSelection.NONE:
            feats = self._trim(self._extract(image))
        else:
            feats = self._extract_by_tile(image)
        feats = self._rescale_features(feats, image.shape[:2], orig_hw)
        feats["image_size"] = np.array([orig_hw[1], orig_hw[0]], dtype=np.int64)
        return feats

    def extract_batch(self, images: List[Image], feature_path) -> None:
        """Extract features for ``images`` into ``feature_path`` (and
        ``feature_cache``). Host extractors run image by image, with the
        file written by one background writer; device extractors override
        this with a padded batched program, and with ``--tiling`` take the
        device route where they have one."""
        if self.tile_selection is not TileSelection.NONE and \
                self._try_extract_batch_tiled_device(images, feature_path):
            return
        with AsyncFeatureWriter(feature_path) as writer:
            for img in images:
                feats = self.extract(img)
                writer.put(img.name, **self._h5_arrays(feats))
                self._cache_put(img.name, **self._h5_arrays(feats))

    @staticmethod
    def _h5_arrays(feats: FeaturesDict) -> FeaturesDict:
        return {k: feats[k] for k in ("keypoints", "descriptors", "scores", "tile_idx",
                                      "image_size") if k in feats}

    # -------------------------------------------------------------- template
    def _extract(self, image: np.ndarray) -> FeaturesDict:
        """Subclass hook: image (H, W) or (H, W, 3) -> FeaturesDict with
        ``keypoints (N, 2)``, optional ``descriptors (N, D)`` and ``scores
        (N,)``. N may be a padded capacity if ``n_valid`` is also returned."""
        raise NotImplementedError

    def _load(self, img: Image) -> np.ndarray:
        image = read_image(img.path, grayscale=self.grayscale)
        if self.as_float and not (self.tile_uint8
                                  and self.tile_selection is not TileSelection.NONE):
            image = image.astype(np.float32) / 255.0
        return image

    def _quality_resize(self, image: np.ndarray) -> np.ndarray:
        if self.quality is Quality.HIGH:
            return image
        h, w = image.shape[:2]
        new_w, new_h = get_size_by_quality(self.quality, (w, h))
        return resize_image(image, (max(new_w, 1), max(new_h, 1)))

    def _extract_many(self, images: List[np.ndarray]) -> List[FeaturesDict]:
        """Hook: a list of one image's tiles -> trimmed FeaturesDicts. The
        default loops ``_extract``; device extractors override it to run the
        tiles as one padded batch."""
        return [self._trim(self._extract(im)) for im in images]

    # ------------------------------------------------------- tiled template
    def _extract_tiles_dev(self, tiles: torch.Tensor) -> Optional[Dict[str, torch.Tensor]]:
        """Hook: a (T, th, tw[, C]) uint8 tile batch on the device -> padded
        device tensors ``keypoints (T, K, 2)`` tile-local, ``descriptors
        (T, K, D)``, ``scores (T, K)``, ``mask (T, K)``. Device extractors
        override it; the base has no device route."""
        return None

    def _supports_device_tiling(self) -> bool:
        return type(self)._extract_tiles_dev is not ExtractorBase._extract_tiles_dev

    def _try_extract_batch_tiled_device(self, images: List[Image], feature_path) -> bool:
        """The device route of tiled extraction: each (quality-resized,
        uint8) image uploads once, its tiles are cut, extracted and merged on
        the extractor's device, and the merged features (score-descending,
        ``tile_idx`` per keypoint) come back to the host for features.h5 and
        ``feature_cache``. Returns False where the extractor has no device
        route or no keypoint cap; a failure raises."""
        from ..ops.tile_merge import cut_tiles, merge_tile_features

        max_kpts = self._max_keypoints()
        if not self._supports_device_tiling() or not max_kpts:
            return False
        tiler = Tiler()
        with AsyncFeatureWriter(feature_path) as writer:
            for img in images:
                arr = read_image(img.path, grayscale=self.grayscale)
                h0, w0 = arr.shape[:2]
                arr = self._quality_resize(arr)
                ch, cw = arr.shape[:2]
                origins, padding, tile_hw = tiler.tile_origins((ch, cw), self.tile_size,
                                                               self.tile_overlap)
                top, _, left, _ = padding
                starts = np.stack([origins[:, 1] + top, origins[:, 0] + left], axis=1)
                tiles = cut_tiles(torch.from_numpy(arr).to(self.device), starts, tile_hw,
                                  padding)
                out = self._extract_tiles_dev(tiles)
                merged = merge_tile_features(
                    out["keypoints"], out["scores"], out["descriptors"], out["mask"],
                    torch.from_numpy(origins.astype(np.float32)), (cw, ch), max_kpts)
                merged = {k: v.cpu().numpy() for k, v in merged.items()}
                m = merged["mask"]
                feats = {
                    "keypoints": merged["keypoints"][m]
                    * np.array([w0 / cw, h0 / ch], np.float32),
                    "descriptors": merged["descriptors"][m],
                    "scores": merged["scores"][m],
                    "tile_idx": merged["tile_idx"][m],
                    "image_size": np.array([w0, h0], np.int64),
                }
                writer.put(img.name, **feats)
                self._cache_put(img.name, **feats)
        return True

    def _extract_by_tile(self, image: np.ndarray) -> FeaturesDict:
        """The host template: tile the image, extract per tile, offset to
        image coordinates, drop keypoints in the padding border, dedup on
        rounded coordinates and cap by score (reference
        ``extractor_base.py:279-390``); features keep image order."""
        tiles, origins, _ = Tiler().compute_tiles_array(image, self.tile_size,
                                                        self.tile_overlap)
        h, w = image.shape[:2]
        all_kpts, all_desc, all_scores, all_tile = [], [], [], []
        feats_per_tile = self._extract_many([tiles[idx] for idx in range(len(tiles))])
        for idx, feats in enumerate(feats_per_tile):
            kpts = feats["keypoints"] + origins[idx][None, :].astype(np.float32)
            keep = (kpts[:, 0] >= 0) & (kpts[:, 0] < w) & (kpts[:, 1] >= 0) & (kpts[:, 1] < h)
            all_kpts.append(kpts[keep])
            if "descriptors" in feats:
                all_desc.append(feats["descriptors"][keep])
            if "scores" in feats:
                all_scores.append(feats["scores"][keep])
            all_tile.append(np.full(int(keep.sum()), idx, dtype=np.float32))
        kpts = np.concatenate(all_kpts, axis=0) if all_kpts else np.zeros((0, 2), np.float32)
        out: FeaturesDict = {"keypoints": kpts, "tile_idx": np.concatenate(all_tile)}
        if all_desc:
            out["descriptors"] = np.concatenate(all_desc, axis=0)
        if all_scores:
            out["scores"] = np.concatenate(all_scores, axis=0)
        # dedup on rounded coordinates (the overlaps give duplicates)
        _, unique_idx = np.unique(np.round(kpts).astype(np.int64), axis=0, return_index=True)
        unique_idx = np.sort(unique_idx)
        for k in ("keypoints", "descriptors", "scores", "tile_idx"):
            if k in out:
                out[k] = out[k][unique_idx]
        # cap at the keypoint budget by score where the union exceeds it
        max_kpts = self._max_keypoints()
        if max_kpts and len(out["keypoints"]) > max_kpts and "scores" in out:
            top = np.sort(np.argsort(-out["scores"])[:max_kpts])
            for k in ("keypoints", "descriptors", "scores", "tile_idx"):
                if k in out:
                    out[k] = out[k][top]
        return out

    def _max_keypoints(self) -> Optional[int]:
        for key in ("max_keypoints", "max_num_keypoints", "n_features"):
            if key in self.conf:
                return int(self.conf[key])
        return None

    @staticmethod
    def _trim(feats: FeaturesDict) -> FeaturesDict:
        """Trim capacity padding using ``n_valid`` if present."""
        n = feats.pop("n_valid", None)
        if n is None:
            return feats
        n = int(n)
        return {k: (v[:n] if k in ("keypoints", "descriptors", "scores", "tile_idx") else v)
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
