"""LiftFeat extractor (port of ``deep_image_matching_tpu/extractors/liftfeat.py``).

The reference's config surface (``max_keypoints``, ``detect_threshold``).
Each grey image (RGB averaged) is padded to multiples of 32 and run through
``models/liftfeat.py`` on the configured device with a capacity of
``max_keypoints`` (at most 8192) rounded up to 128; keypoints, scores and
64-d descriptors are trimmed to the valid rows. The convolutions and
products run in full f32 (``utils/device.full_f32``), not cuDNN's default
TF32. Weights: ``LiftFeat.pth`` or
``liftfeat.pth`` in DIM_TPU_WEIGHTS_DIR or ~/.cache/dim_tpu (the state dict
under ``state_dict`` or at the top), else the JAX package's seeded random
weights under the weights policy.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..models import liftfeat as lf_model
from ..utils.device import full_f32, resolve_device, to_device
from .extractor_base import ExtractorBase, FeaturesDict

logger = logging.getLogger("dim_tpu_torch")

CHECKPOINTS = ("LiftFeat.pth", "liftfeat.pth")
_PARAMS: Optional[Dict] = None
_PARAMS_RANDOM = False


def load_params() -> Dict:
    """LiftFeat's parameters on the CPU, loaded once per process; cached
    random weights re-consult the policy."""
    global _PARAMS, _PARAMS_RANDOM
    from ..convert import liftfeat_params_from_jax
    from ..utils.weights import missing_weights, reject_cached_random

    if _PARAMS is not None:
        if _PARAMS_RANDOM:
            reject_cached_random("LiftFeat", CHECKPOINTS)
        return _PARAMS
    wdir = os.environ.get("DIM_TPU_WEIGHTS_DIR")
    for base in ([Path(wdir)] if wdir else []) + [Path.home() / ".cache/dim_tpu"]:
        for name in CHECKPOINTS:
            cand = base / name
            if cand.exists():
                ckpt = torch.load(str(cand), map_location="cpu")
                _PARAMS = lf_model.params_from_torch(ckpt.get("state_dict", ckpt))
                logger.info(f"Loaded LiftFeat weights from {cand}")
                return _PARAMS
    missing_weights("LiftFeat", CHECKPOINTS)
    _PARAMS = lf_model.params_from_torch(liftfeat_params_from_jax(lf_model.init_tree()))
    _PARAMS_RANDOM = True
    return _PARAMS


class LiftFeatExtractor(ExtractorBase):
    default_conf = {
        "max_keypoints": 4096,
        "detect_threshold": 0.05,
    }
    grayscale = True
    as_float = True
    descriptor_size = lf_model.DESC_DIM

    def __init__(self, config: dict):
        super().__init__(config)
        tpu = self.config.get("general", {}).get("tpu", {})
        self.device = resolve_device(tpu.get("device", "auto"))
        self.params = to_device(load_params(), self.device)
        self.max_keypoints = int(
            self.conf.get("max_keypoints", self.conf.get("max_num_keypoints", 4096)))
        self.threshold = float(self.conf.get("detect_threshold", 0.05))

    def _extract(self, image: np.ndarray) -> FeaturesDict:
        if image.ndim == 3:
            image = image.mean(-1)
        h, w = image.shape
        ph, pw = -(-h // 32) * 32, -(-w // 32) * 32
        batch = np.zeros((1, ph, pw, 1), np.float32)
        batch[0, :h, :w, 0] = image
        with full_f32():
            out = lf_model.extract(
                self.params, torch.from_numpy(batch).to(self.device),
                torch.tensor([[h, w]], device=self.device),
                top_k=-(-min(self.max_keypoints, 8192) // 128) * 128,
                detection_threshold=self.threshold)
        out = {k: v[0].cpu().numpy() for k, v in out.items()}
        m = out["mask"]
        return {"keypoints": out["keypoints"][m], "scores": out["scores"][m],
                "descriptors": out["descriptors"][m]}
