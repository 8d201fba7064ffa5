"""SIFT extractor (OpenCV, on the host).

Copied from ``deep_image_matching_tpu/extractors/sift.py``; parity with the
reference ``extractors/sift.py:7-91`` (cv2.SIFT_create with n_features /
nOctaveLayers / contrastThreshold / edgeThreshold / sigma). SIFT runs on the
host; matching and verification run on the device. Descriptors are
integer-valued (0-255) float32.
"""

from __future__ import annotations

import cv2
import numpy as np

from .extractor_base import ExtractorBase, FeaturesDict


class SIFTExtractor(ExtractorBase):
    default_conf = {
        "n_features": 4000,
        "nOctaveLayers": 3,
        "contrastThreshold": 0.0004,
        "edgeThreshold": 10,
        "sigma": 1.6,
    }
    grayscale = True
    as_float = False  # cv2 SIFT wants uint8
    descriptor_size = 128

    def __init__(self, config: dict):
        super().__init__(config)
        self._sift = cv2.SIFT_create(
            nfeatures=int(self.conf["n_features"]),
            nOctaveLayers=int(self.conf["nOctaveLayers"]),
            contrastThreshold=float(self.conf["contrastThreshold"]),
            edgeThreshold=float(self.conf["edgeThreshold"]),
            sigma=float(self.conf["sigma"]),
        )

    def _extract(self, image: np.ndarray) -> FeaturesDict:
        if image.dtype != np.uint8:
            image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
        kp, desc = self._sift.detectAndCompute(image, None)
        if not kp:
            return {
                "keypoints": np.zeros((0, 2), np.float32),
                "descriptors": np.zeros((0, self.descriptor_size), np.float32),
                "scores": np.zeros((0,), np.float32),
            }
        kpts = np.array([k.pt for k in kp], dtype=np.float32)
        scores = np.array([k.response for k in kp], dtype=np.float32)
        return {
            "keypoints": kpts,
            "descriptors": desc.astype(np.float32),
            "scores": scores,
        }
