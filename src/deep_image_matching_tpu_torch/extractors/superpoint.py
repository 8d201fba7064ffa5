"""SuperPoint extractor (port of ``deep_image_matching_tpu/extractors/superpoint.py``).

Whole image batches are padded and extracted together on the configured
device (``models/superpoint.py``). Inside ``ImageMatcher`` the images are
decoded and uploaded by the prefetch pool (``utils/prefetch.py``), padded
and stacked on the device, and the outputs stay there for the matcher (the
device handoff, ``ExtractorBase._arm_device_handoff``), with features.h5
written in the background while matching runs; outside it, features.h5 is
written by a background thread while extraction continues. With
``--tiling`` each image uploads once and its tiles are cut, extracted
(``_extract_tiles_dev``, in chunks of ``tpu.extract_batch_size`` tiles) and
merged on the device (``ExtractorBase._try_extract_batch_tiled_device``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import TileSelection
from ..io.writer import AsyncFeatureWriter
from ..models.superpoint import SuperPointRunner, extract, load_default_model
from ..utils.device import resolve_device
from ..utils.image import Image, read_image
from .extractor_base import ExtractorBase, FeaturesDict


class SuperPointExtractor(ExtractorBase):
    default_conf = {
        "nms_radius": 4,
        "keypoint_threshold": 0.0005,
        "max_keypoints": 2048,
        "remove_borders": 4,
    }
    descriptor_size = 256
    # the model normalises uint8 on the device, so tiles stay uint8
    tile_uint8 = True

    def __init__(self, config: dict):
        super().__init__(config)
        tpu = self.config.get("general", {}).get("tpu", {})
        self._runner = SuperPointRunner(
            model=self._load_model(),
            max_keypoints=int(self.conf["max_keypoints"]),
            nms_radius=int(self.conf["nms_radius"]),
            keypoint_threshold=float(self.conf["keypoint_threshold"]),
            remove_borders=int(self.conf.get("remove_borders", 4)),
            batch_size=int(tpu.get("extract_batch_size", 8)),
            device=resolve_device(tpu.get("device", "auto")),
        )
        self.device = self._runner.device

    @staticmethod
    def _load_model():
        """The network's weights (``superpoint_v1.pth``); the open-license
        extractor overrides this with its own checkpoints."""
        return load_default_model()

    def extract_batch(self, images: List[Image], feature_path) -> None:
        if self.tile_selection is not TileSelection.NONE:
            return super().extract_batch(images, feature_path)
        if self._device_handoff_allowed():
            return self._extract_handoff(images, feature_path)
        prepped = []
        for img in images:
            # uint8 on the host; the device normalises
            arr = read_image(img.path, grayscale=True)
            h, w = arr.shape
            prepped.append((self._quality_resize(arr), (w, h)))
        results = self._runner.extract_arrays([(arr, 1.0, wh) for arr, wh in prepped])
        with AsyncFeatureWriter(feature_path) as writer:
            for img, (arr, (w, h)), feats in zip(images, prepped, results):
                ah, aw = arr.shape
                kpts = feats["keypoints"] * np.array([w / aw, h / ah], np.float32)
                size = np.array([w, h], np.int64)
                writer.put(img.name, keypoints=kpts, descriptors=feats["descriptors"],
                           scores=feats["scores"], image_size=size)
                self._cache_put(img.name, keypoints=kpts, descriptors=feats["descriptors"],
                                scores=feats["scores"], image_size=size)

    def _device_batches(self, images):
        return self._runner.iter_batches(images)

    def _extract(self, image: np.ndarray) -> FeaturesDict:
        """One image or tile (the host template's per-tile hook)."""
        return self._extract_many([image])[0]

    def _extract_many(self, images) -> list:
        """A list of tiles through the runner, which runs same-shape tiles as
        one padded batch."""
        prepped = []
        for im in images:
            if im.ndim == 3:
                im = im.mean(axis=-1).astype(im.dtype)
            h, w = im.shape
            prepped.append((im, 1.0, (w, h)))
        return [{"keypoints": f["keypoints"], "descriptors": f["descriptors"],
                 "scores": f["scores"]} for f in self._runner.extract_arrays(prepped)]

    def _extract_tiles_dev(self, tiles: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The device route's hook: a (T, th, tw) uint8 tile batch on the
        device (or (T, th, tw, C), averaged to grey) through the model in
        chunks of the runner's batch size, each tile padded to multiples of
        8 with its true extent as the valid size; outputs stay on the
        device for the merge."""
        r = self._runner
        if tiles.ndim == 4:
            tiles = (tiles.float() / 255.0).mean(dim=-1)
        x = tiles[..., None]
        T, th, tw = x.shape[:3]
        ph, pw = -(-th // 8) * 8, -(-tw // 8) * 8
        if (ph, pw) != (th, tw):
            x = F.pad(x, (0, 0, 0, pw - tw, 0, ph - th))
        outs = []
        for s in range(0, T, r.batch_size):
            chunk = x[s:s + r.batch_size]
            vhw = torch.tensor([[th, tw]], device=chunk.device).expand(chunk.shape[0], 2)
            outs.append(extract(r.model, chunk, vhw, r.max_keypoints, r.nms_radius,
                                r.keypoint_threshold, r.remove_borders, r.compute_dtype))
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
