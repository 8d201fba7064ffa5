"""SuperPoint extractor (port of ``deep_image_matching_tpu/extractors/superpoint.py``).

Whole image batches are padded and extracted together on the configured
device (``models/superpoint.py``); features.h5 is written by a background
thread while extraction continues.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..io.writer import AsyncFeatureWriter
from ..models.superpoint import SuperPointRunner, load_default_model
from ..utils.device import resolve_device
from ..utils.image import Image, read_image
from .extractor_base import ExtractorBase


class SuperPointExtractor(ExtractorBase):
    default_conf = {
        "nms_radius": 4,
        "keypoint_threshold": 0.0005,
        "max_keypoints": 2048,
        "remove_borders": 4,
    }
    descriptor_size = 256

    def __init__(self, config: dict):
        super().__init__(config)
        tpu = self.config.get("general", {}).get("tpu", {})
        self._runner = SuperPointRunner(
            model=load_default_model(),
            max_keypoints=int(self.conf["max_keypoints"]),
            nms_radius=int(self.conf["nms_radius"]),
            keypoint_threshold=float(self.conf["keypoint_threshold"]),
            remove_borders=int(self.conf.get("remove_borders", 4)),
            batch_size=int(tpu.get("extract_batch_size", 8)),
            device=resolve_device(tpu.get("device", "auto")),
        )

    def extract_batch(self, images: List[Image], feature_path) -> None:
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
