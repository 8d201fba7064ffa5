"""Extractor base: configuration, quality resize, feature cache, the
extract -> match handoff on the device and the per-image template.

Port of ``deep_image_matching_tpu/extractors/extractor_base.py``: the
configuration, the quality resize, the in-memory ``feature_cache`` handed to
the matcher (h5-roundtrip-exact values), the reflection loader, and the
per-image template of the host extractors (SIFT, ORB): load (``grayscale`` /
``as_float``) -> quality resize -> ``_extract`` (or, with ``--tiling``,
``_extract_by_tile``) -> trim -> keypoints back to full resolution ->
features.h5.

The device handoff: where ``ImageMatcher`` has armed ``feature_cache``, the
batched extractors (SuperPoint, ALIKED, XFeat, ALIKE: ``_extract_handoff``,
the images decoded a few ahead by the prefetch pool and batched as they
arrive) and the tiled device route keep their padded outputs on the device
and hand them to the matcher
as a ``DeviceFeatureHandoff`` (``_arm_device_handoff``): keypoints rescaled
to full resolution on the device, descriptors and scores rounded through
f16 there (the values an h5 reload gives), small host mirrors of the
keypoints, counts and tile indices, and features.h5 written by a
background writer while matching runs (``flush()`` joins it). The handoff
is armed on every device, the CPU included, and a failure raises.

Tiled extraction has two routes. Extractors that override
``_extract_tiles_dev`` (SuperPoint) take the device route
(``_try_extract_batch_tiled_device``): each image uploads once as uint8
(``utils/prefetch.py``), its tiles are cut, extracted and merged on the
extractor's device (``ops/tile_merge.py``), and the merged features go to
the handoff (or, outside ``ImageMatcher``, back to the host for features.h5
and ``feature_cache``). A failure there raises; it does not fall back to the
host route. The others (SIFT, ORB, ALIKED) take the host template
``_extract_by_tile``. Both give every keypoint its ``tile_idx``.
"""

from __future__ import annotations

import contextlib
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


class DeviceFeatureHandoff:
    """Extraction results that stay on the device for the matcher.

    ``dev`` holds ``keypoints`` (n, K, 2) at full resolution, ``descriptors``
    (n, K, D) and ``scores`` (n, K) with the f16 storage round trip applied,
    ``mask`` (n, K) with the valid rows as a prefix and zeros (``tile_idx``
    -1) on the others, and ``tile_idx`` (n, K) where tiled; the host mirrors
    are what verification and gating read: keypoints, counts, image sizes,
    tile indices."""

    def __init__(self, names, counts, kpts, image_size, dev, tile_idx=None):
        self.names = list(names)
        self.index = {n: i for i, n in enumerate(self.names)}
        self.counts = counts          # (n,) int32, host
        self.kpts = kpts              # (n, K, 2) f32, host, full resolution
        self.image_size = image_size  # (n, 2) int64, host
        self.dev = dev                # device tensors, see above
        self.tile_idx = tile_idx      # (n, K) f32 host, -1 on padding (tiled only)

    def covers(self, names) -> bool:
        return all(n in self.index for n in names)


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
        # the device handoff of the last batch and its deferred writer
        self.device_handoff: Optional[DeviceFeatureHandoff] = None
        self._pending_writer: Optional[AsyncFeatureWriter] = None

    def flush(self) -> None:
        """Join the deferred features.h5 writer, re-raising its error; after
        this returns, features.h5 is complete on disk."""
        w, self._pending_writer = self._pending_writer, None
        if w is not None:
            w.close()

    def _device_handoff_allowed(self, tiled: bool = False) -> bool:
        """The handoff is armed inside ``ImageMatcher`` (``feature_cache``
        set) on an untiled run, or by the tiled device route (``tiled``)."""
        if self.feature_cache is None:
            return False
        return tiled or self.tile_selection is TileSelection.NONE

    def _arm_device_handoff(self, names, chunks, fac, image_size, feature_path) -> None:
        """Build the ``DeviceFeatureHandoff`` of a batch from per-chunk padded
        device outputs and queue its features.h5 write on a background writer.

        chunks: [(indices into ``names``, out)] with ``out`` as every extract
        function gives it: ``keypoints`` (B, K, 2) in model-input pixels,
        ``descriptors`` (B, K, D), ``scores`` (B, K), ``mask`` (B, K) and
        optionally ``tile_idx`` (B, K), the valid rows first and the others
        zero (``tile_idx`` -1), one K for all. fac: (n, 2) f32 (sx, sy) to
        full resolution; image_size: (n, 2) (w, h). Every value equals the
        host path's bit for bit: keypoints are rescaled by the same f32
        product, descriptors and scores round through f16 as features.h5
        stores them."""
        self.flush()
        order = np.concatenate([np.asarray(c, np.int64) for c, _ in chunks])
        keys = ["keypoints", "descriptors", "scores", "mask"]
        if all("tile_idx" in out for _, out in chunks):
            keys.append("tile_idx")
        dev0 = chunks[0][1]["mask"].device
        perm = torch.from_numpy(np.argsort(order)).to(dev0)
        cat = {k: torch.cat([out[k] for _, out in chunks])[perm] for k in keys}
        fac_t = torch.from_numpy(np.asarray(fac, np.float32)).to(dev0)
        desc_f16, scores_f16 = cat["descriptors"].half(), cat["scores"].half()
        mask = cat["mask"]
        kpts = cat["keypoints"] * fac_t[:, None, :]
        dev = {"keypoints": kpts, "descriptors": desc_f16.float(),
               "scores": scores_f16.float(), "mask": mask}
        tile_h = None
        if "tile_idx" in cat:
            dev["tile_idx"] = cat["tile_idx"]
            tile_h = dev["tile_idx"].cpu().numpy()
        ready = None
        if dev0.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev0))
        kpts_h = kpts.cpu().numpy()
        counts = mask.sum(dim=1).int().cpu().numpy()
        image_size = np.asarray(image_size, np.int64)
        self.device_handoff = DeviceFeatureHandoff(names, counts, kpts_h, image_size, dev,
                                                   tile_idx=tile_h)
        writer = AsyncFeatureWriter(feature_path)
        try:
            writer.put_device_batch(names, kpts_h, desc_f16, scores_f16, image_size, counts,
                                    tile_idx=tile_h, ready=ready)
        except BaseException:
            writer.close()
            raise
        self._pending_writer = writer

    def _extract_handoff(self, images: List[Image], feature_path) -> None:
        """An untiled batch under the device handoff: the prefetch pool
        decodes and uploads the images a few ahead of the model, the
        extractor's ``_device_batches`` runs them as padded batches as they
        arrive, and the outputs go to ``_arm_device_handoff``."""
        from ..utils.prefetch import prefetch_device_images

        sizes = []

        def fetched():
            for t, (ah, aw), (w, h) in prefetch_device_images(
                    images, self.grayscale, self._quality_resize, self.device):
                sizes.append((w / aw, h / ah, w, h))
                yield t

        chunks = list(self._device_batches(fetched()))
        sizes = np.asarray(sizes)
        self._arm_device_handoff([img.name for img in images], chunks,
                                 sizes[:, :2].astype(np.float32),
                                 sizes[:, 2:].astype(np.int64), feature_path)

    def _device_batches(self, images):
        """Hook of the batched extractors: images (host arrays, or uint8
        tensors on the device taken as they come) -> (indices, padded device
        outputs) per batch (``ops/assemble.padded_batches``)."""
        raise NotImplementedError

    def _run(self, images: list) -> list:
        """Images through ``_device_batches`` -> per-image trimmed features
        (``keypoints``, ``scores``, ``descriptors``) on the host, in pixels
        of the image given."""
        from ..ops.assemble import unpad

        results = [None] * len(images)
        for chunk, out in self._device_batches(images):
            for i, f in zip(chunk, unpad(out)):
                results[i] = f
        return results

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
        uint8) image is decoded and uploaded once by the prefetch pool (the
        next images decode while this one's tiles run), its tiles are cut,
        extracted and merged on the extractor's device, and the merged
        features (score-descending, ``tile_idx`` per keypoint) go to the
        device handoff, or, outside ``ImageMatcher``, back to the host for
        features.h5 and ``feature_cache``. Returns False where the extractor
        has no device route or no keypoint cap; a failure raises."""
        from ..ops.tile_merge import cut_tiles, merge_tile_features
        from ..utils.prefetch import prefetch_device_images

        max_kpts = self._max_keypoints()
        if not self._supports_device_tiling() or not max_kpts:
            return False
        tiler = Tiler()
        fetched = prefetch_device_images(images, self.grayscale, self._quality_resize,
                                         self.device)
        handoff = self._device_handoff_allowed(tiled=True)
        chunks, fac, sizes = [], [], []
        with contextlib.nullcontext() if handoff else AsyncFeatureWriter(feature_path) as writer:
            for i, (img, (dev_img, (ch, cw), (w0, h0))) in enumerate(zip(images, fetched)):
                origins, padding, tile_hw = tiler.tile_origins((ch, cw), self.tile_size,
                                                               self.tile_overlap)
                top, _, left, _ = padding
                starts = np.stack([origins[:, 1] + top, origins[:, 0] + left], axis=1)
                out = self._extract_tiles_dev(cut_tiles(dev_img, starts, tile_hw, padding))
                merged = merge_tile_features(
                    out["keypoints"], out["scores"], out["descriptors"], out["mask"],
                    torch.from_numpy(origins.astype(np.float32)), (cw, ch), max_kpts)
                if handoff:
                    chunks.append(([i], {k: v[None] for k, v in merged.items()}))
                    fac.append((w0 / cw, h0 / ch))
                    sizes.append((w0, h0))
                    continue
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
        if handoff:
            self._arm_device_handoff([img.name for img in images], chunks,
                                     np.asarray(fac, np.float32), sizes, feature_path)
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
