"""Pipeline-wide enums and scale constants.

Copied from the JAX package (``deep_image_matching_tpu/constants.py``):
TileSelection, GeometricVerification, Quality and the quality->resize-factor
map, so configs are interchangeable between the two packages.
"""

from __future__ import annotations

from enum import Enum
from typing import Tuple


class TileSelection(Enum):
    """How tile pairs are chosen when an image is split into tiles."""

    NONE = 0
    EXHAUSTIVE = 1
    GRID = 2
    PRESELECTION = 3
    PRESELECTION_AFFINE_TRANSFORM = 4


class GeometricVerification(Enum):
    """Fundamental-matrix estimation method used to verify raw matches.

    ``JAX_RANSAC`` (name kept for config compatibility) is the batched
    on-device 8-point RANSAC (see ``ops/ransac.py``) that verifies a whole
    pair batch in one pass.
    The OpenCV/USAC family runs on host for fidelity parity with the reference.
    """

    NONE = 0
    PYDEGENSAC = 1
    MAGSAC = 2
    RANSAC = 3
    LMEDS = 4
    RHO = 5
    USAC_DEFAULT = 6
    USAC_PARALLEL = 7
    USAC_FM_8PTS = 8
    USAC_FAST = 9
    USAC_ACCURATE = 10
    USAC_PROSAC = 11
    USAC_MAGSAC = 12
    JAX_RANSAC = 13


class Quality(Enum):
    """Image-resolution preset used for feature extraction/matching."""

    LOWEST = 0
    LOW = 1
    MEDIUM = 2
    HIGH = 3
    HIGHEST = 4


QUALITY_FACTORS = {
    Quality.HIGHEST: 2.0,
    Quality.HIGH: 1.0,
    Quality.MEDIUM: 0.5,
    Quality.LOW: 0.25,
    Quality.LOWEST: 0.125,
}


def quality_factor(quality: Quality) -> float:
    return QUALITY_FACTORS[quality]


def get_size_by_quality(quality: Quality, size: Tuple[int, int]) -> Tuple[int, int]:
    """Scale an (width, height) size by the quality factor (reference
    ``constants.py:76-88``)."""
    f = QUALITY_FACTORS[quality]
    return (int(size[0] * f), int(size[1] * f))


# Keypoint capacity is padded up to a multiple of this (the JAX package's
# value, so padded shapes agree between the two packages). All device-side
# feature arrays are fixed-capacity + validity mask.
KPT_PAD_MULTIPLE = 128

IMAGE_EXTENSIONS = (
    ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".bmp", ".webp",
    ".JPG", ".JPEG", ".PNG", ".TIF", ".TIFF", ".BMP", ".WEBP",
)
