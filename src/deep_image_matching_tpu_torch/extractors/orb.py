"""ORB extractor (OpenCV, host-side).

Copied from ``deep_image_matching_tpu/extractors/orb.py``; parity with the
reference ``extractors/orb.py:7-99``. The 32 descriptor bytes are stored as
float (0-255) for the h5 schema, as the reference does; matching uses L2
over that float representation, as the reference's kornia matcher does.
"""

from __future__ import annotations

import cv2
import numpy as np

from .extractor_base import ExtractorBase, FeaturesDict


class ORBExtractor(ExtractorBase):
    default_conf = {
        "n_features": 4000,
        "scaleFactor": 1.2,
        "nlevels": 8,
        "edgeThreshold": 31,
        "firstLevel": 0,
        "WTA_K": 2,
        "patchSize": 31,
        "fastThreshold": 20,
    }
    grayscale = True
    as_float = False
    descriptor_size = 32

    def __init__(self, config: dict):
        super().__init__(config)
        self._orb = cv2.ORB_create(
            nfeatures=int(self.conf["n_features"]),
            scaleFactor=float(self.conf["scaleFactor"]),
            nlevels=int(self.conf["nlevels"]),
            edgeThreshold=int(self.conf["edgeThreshold"]),
            firstLevel=int(self.conf["firstLevel"]),
            WTA_K=int(self.conf["WTA_K"]),
            patchSize=int(self.conf["patchSize"]),
            fastThreshold=int(self.conf["fastThreshold"]),
        )

    def _extract(self, image: np.ndarray) -> FeaturesDict:
        if image.dtype != np.uint8:
            image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
        kp, desc = self._orb.detectAndCompute(image, None)
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
