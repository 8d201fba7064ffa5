"""No-op extractor for the detector-free matchers (port of
``deep_image_matching_tpu/extractors/no_extractor.py``).

Writes each image's group with empty (0, 2) keypoints and its
``image_size``, through the per-image template's writer, so that a
detector-free matcher can append the keypoints it produces per pair. The
image is not decoded: its size comes from the file header.
"""

from __future__ import annotations

import numpy as np

from ..utils.image import Image
from .extractor_base import ExtractorBase, FeaturesDict


class NoExtractor(ExtractorBase):
    default_conf = {}
    grayscale = True
    as_float = False

    def extract(self, img) -> FeaturesDict:
        if not isinstance(img, Image):
            img = Image(img)
        w, h = img.size
        return {
            "keypoints": np.zeros((0, 2), np.float32),
            "image_size": np.array([w, h], dtype=np.int64),
        }

    def _extract(self, image: np.ndarray) -> FeaturesDict:
        return {"keypoints": np.zeros((0, 2), np.float32)}
