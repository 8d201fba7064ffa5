"""RDD sparse extractor (port of ``deep_image_matching_tpu/extractors/rdd_sparse.py``).

The reference's config surface (``max_num_keypoints``,
``detection_threshold``); the preset pairs it with LightGlue's
``rdd_sparse`` weight set. Each image (RGB in [0, 1]) is padded to
multiples of 32 and run through ``models/rdd.py`` on the configured device,
in full f32, with a keypoint capacity of ``min(max_num_keypoints, 8192)``
rounded up to 128; the base class's per-image template writes features.h5.
Weights: ``RDD-v2.pth``, ``RDD-v1.pth`` or ``rdd.pth`` (a state dict, or a
dict holding one under ``state_dict``) in DIM_TPU_WEIGHTS_DIR or
~/.cache/dim_tpu, else random weights from a seeded generator under the
weights policy.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np
import torch

from ..models import rdd as rdd_model
from ..utils.device import resolve_device, to_device
from .extractor_base import ExtractorBase, FeaturesDict

logger = logging.getLogger("dim_tpu_torch")

CHECKPOINTS = ("RDD-v2.pth", "RDD-v1.pth", "rdd.pth")
_PARAMS: Optional[Dict] = None
_PARAMS_RANDOM = False


def load_params() -> Dict:
    """RDD's parameters on the CPU, loaded once per process; cached random
    weights re-consult the policy."""
    global _PARAMS, _PARAMS_RANDOM
    from ..utils.weights import find_checkpoint, missing_weights, reject_cached_random

    if _PARAMS is not None:
        if _PARAMS_RANDOM:
            reject_cached_random("RDD", CHECKPOINTS)
        return _PARAMS
    cand = find_checkpoint(CHECKPOINTS)
    if cand is not None:
        ckpt = torch.load(str(cand), map_location="cpu")
        _PARAMS = rdd_model.params_from_torch(ckpt.get("state_dict", ckpt))
        logger.info(f"Loaded RDD weights from {cand}")
        return _PARAMS
    missing_weights("RDD", CHECKPOINTS)
    _PARAMS = rdd_model.init_params(torch.Generator().manual_seed(37))
    _PARAMS_RANDOM = True
    return _PARAMS


class RDDSparseExtractor(ExtractorBase):
    default_conf = {
        "max_num_keypoints": 4000,
        "detection_threshold": 0.01,
    }
    grayscale = False
    as_float = True
    descriptor_size = 256

    def __init__(self, config: dict):
        super().__init__(config)
        tpu = self.config.get("general", {}).get("tpu", {})
        self.device = resolve_device(tpu.get("device", "auto"))
        self.params = to_device(load_params(), self.device)
        self.max_keypoints = int(self.conf.get("max_num_keypoints", 4000))
        self.detection_threshold = float(self.conf.get("detection_threshold", 0.01))

    def _extract(self, image: np.ndarray) -> FeaturesDict:
        if image.ndim == 2:
            image = np.repeat(image[..., None], 3, axis=-1)
        h, w = image.shape[:2]
        ph, pw = -(-h // 32) * 32, -(-w // 32) * 32
        batch = np.zeros((1, ph, pw, 3), np.float32)
        batch[0, :h, :w] = image
        cap = ((min(self.max_keypoints, 8192) + 127) // 128) * 128
        out = rdd_model.extract(
            self.params, torch.from_numpy(batch).to(self.device),
            torch.tensor([[h, w]], device=self.device), max_keypoints=cap,
            detection_threshold=self.detection_threshold)
        out = {k: v[0].cpu().numpy() for k, v in out.items()}
        m = out["mask"]
        return {"keypoints": out["keypoints"][m], "scores": out["scores"][m],
                "descriptors": out["descriptors"][m]}
