"""Open-license SuperPoint extractor (port of
``deep_image_matching_tpu/extractors/superpoint_open.py``).

The SuperPoint network of ``models/superpoint.py`` with the open weights'
own configuration (``nms_radius`` 5, ``keypoint_threshold`` 0.005,
``remove_borders`` 4, ``max_keypoints`` 4096) and its own checkpoints:
``superpoint_open.pth`` or ``superpoint_v6_from_tf.pth`` (the standard
``conv*.weight`` / ``conv*.bias`` names) in DIM_TPU_WEIGHTS_DIR or
~/.cache/dim_tpu, else seeded random weights under the weights policy.
Extraction, tiling and the batch runner are SuperPoint's.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

import torch

from ..models.superpoint import SuperPoint
from .superpoint import SuperPointExtractor

logger = logging.getLogger("dim_tpu_torch")

CHECKPOINTS = ("superpoint_open.pth", "superpoint_v6_from_tf.pth")
_MODEL: Optional[SuperPoint] = None
_MODEL_RANDOM = False


def load_open_model() -> SuperPoint:
    """The first open checkpoint found, or seeded random weights (the
    weights policy decides); cached random weights re-consult the policy."""
    global _MODEL, _MODEL_RANDOM
    from ..utils.weights import missing_weights, reject_cached_random

    if _MODEL is not None:
        if _MODEL_RANDOM:
            reject_cached_random("SuperPoint-open", CHECKPOINTS)
        return _MODEL
    wdir = os.environ.get("DIM_TPU_WEIGHTS_DIR")
    for base in ([Path(wdir)] if wdir else []) + [Path.home() / ".cache/dim_tpu"]:
        for name in CHECKPOINTS:
            cand = base / name
            if cand.exists():
                model = SuperPoint()
                model.load_state_dict(torch.load(str(cand), map_location="cpu"))
                logger.info(f"Loaded open SuperPoint weights from {cand}")
                _MODEL = model.eval()
                return _MODEL
    missing_weights("SuperPoint-open", CHECKPOINTS)
    _MODEL = SuperPoint().reset_random(torch.Generator().manual_seed(6)).eval()
    _MODEL_RANDOM = True
    return _MODEL


class SuperPointOpenExtractor(SuperPointExtractor):
    default_conf = {
        "nms_radius": 5,
        "keypoint_threshold": 0.005,
        "max_keypoints": 4096,
        "remove_borders": 4,
    }

    @staticmethod
    def _load_model():
        return load_open_model()
