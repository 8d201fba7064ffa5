"""RIPE extractor (port of ``deep_image_matching_tpu/extractors/ripe.py``).

The reference's config surface (``max_keypoints``, ``detect_threshold``).
Each image (RGB in [0, 1]) is padded to multiples of 8 and run through
``models/ripe.py`` on the configured device with a capacity of
``max_keypoints`` rounded up to 128; its keypoints, scores and 960-d
hypercolumn descriptors (fewer where the checkpoint has the 1x1 reduction)
are trimmed to the valid rows. The convolutions run in full f32
(``utils/device.full_f32``: under cuDNN's default TF32 a fifth of the
card's local maxima at 1024 px differed from the CPU's). Weights:
``ripe_weights.pth`` in DIM_TPU_WEIGHTS_DIR, ~/.cache/dim_tpu or the
temporary directory (where the upstream factory downloads it), else the JAX
package's seeded random weights under the weights policy.
"""

from __future__ import annotations

import logging
import os
import tempfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..models import ripe as ripe_model
from ..utils.device import full_f32, resolve_device, to_device
from .extractor_base import ExtractorBase, FeaturesDict

logger = logging.getLogger("dim_tpu_torch")

CHECKPOINTS = ("ripe_weights.pth",)
_PARAMS: Optional[Dict] = None
_PARAMS_RANDOM = False


def load_params() -> Dict:
    """RIPE's parameters on the CPU, loaded once per process; cached random
    weights re-consult the policy."""
    global _PARAMS, _PARAMS_RANDOM
    from ..convert import ripe_params_from_jax
    from ..utils.weights import missing_weights, reject_cached_random

    if _PARAMS is not None:
        if _PARAMS_RANDOM:
            reject_cached_random("RIPE", CHECKPOINTS)
        return _PARAMS
    wdir = os.environ.get("DIM_TPU_WEIGHTS_DIR")
    for base in ([Path(wdir)] if wdir else []) + [Path.home() / ".cache/dim_tpu",
                                                  Path(tempfile.gettempdir())]:
        cand = base / CHECKPOINTS[0]
        if cand.exists():
            _PARAMS = ripe_model.params_from_torch(torch.load(str(cand), map_location="cpu"))
            logger.info(f"Loaded RIPE weights from {cand}")
            return _PARAMS
    missing_weights("RIPE", CHECKPOINTS)
    _PARAMS = ripe_model.params_from_torch(ripe_params_from_jax(ripe_model.init_tree()))
    _PARAMS_RANDOM = True
    return _PARAMS


class RIPEExtractor(ExtractorBase):
    default_conf = {
        "max_keypoints": 4096,
        "detect_threshold": 0.5,
    }
    grayscale = False
    as_float = True
    descriptor_size = ripe_model.HYPERCOLUMN_DIM  # reduced if the checkpoint has the 1x1

    def __init__(self, config: dict):
        super().__init__(config)
        tpu = self.config.get("general", {}).get("tpu", {})
        self.device = resolve_device(tpu.get("device", "auto"))
        self.params = to_device(load_params(), self.device)
        self.max_keypoints = int(
            self.conf.get("max_keypoints", self.conf.get("max_num_keypoints", 4096)))
        self.threshold = float(self.conf.get("detect_threshold", 0.5))

    def _extract(self, image: np.ndarray) -> FeaturesDict:
        if image.ndim == 2:
            image = np.repeat(image[..., None], 3, axis=-1)
        h, w = image.shape[:2]
        ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
        batch = np.zeros((1, ph, pw, 3), np.float32)
        batch[0, :h, :w] = image
        with full_f32():
            out = ripe_model.extract(
                self.params, torch.from_numpy(batch).to(self.device),
                torch.tensor([[h, w]], device=self.device),
                max_keypoints=-(-self.max_keypoints // 128) * 128, threshold=self.threshold)
        out = {k: v[0].cpu().numpy() for k, v in out.items()}
        m = out["mask"]
        return {"keypoints": out["keypoints"][m], "scores": out["scores"][m],
                "descriptors": out["descriptors"][m]}
