"""DISK extractor (port of ``deep_image_matching_tpu/extractors/disk.py``).

The reference's config surface (``max_keypoints``, ``nms_window_size``,
``detection_threshold``, ``pad_if_not_divisible``). Each image (RGB in
[0, 1]) is padded to multiples of 16 and run through ``models/disk.py`` on
the configured device; its keypoints, logit scores and descriptors are
trimmed to the valid rows. The convolutions run in full f32
(``utils/device.full_f32``: under cuDNN's default TF32 the card shared 0.9903
of the CPU's keypoints and 0.9839 of its raw matches at 1024 px). Weights: the first of ``disk_depth.pth``,
``disk.pth``, ``epipolar-save.pth`` in DIM_TPU_WEIGHTS_DIR or
~/.cache/dim_tpu (the state dict under ``extractor`` or ``state_dict``, or
at the top), else seeded random weights under the weights policy.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..models import disk as disk_model
from ..utils.device import full_f32, resolve_device
from .extractor_base import ExtractorBase, FeaturesDict

logger = logging.getLogger("dim_tpu_torch")

CHECKPOINTS = ("disk_depth.pth", "disk.pth", "epipolar-save.pth")
_MODEL: Optional[disk_model.DISK] = None
_MODEL_RANDOM = False


def load_model() -> disk_model.DISK:
    """The checkpoint's model, or seeded random weights (the weights policy
    decides); cached random weights re-consult the policy."""
    global _MODEL, _MODEL_RANDOM
    from ..utils.weights import missing_weights, reject_cached_random

    if _MODEL is not None:
        if _MODEL_RANDOM:
            reject_cached_random("DISK", CHECKPOINTS)
        return _MODEL
    wdir = os.environ.get("DIM_TPU_WEIGHTS_DIR")
    for base in ([Path(wdir)] if wdir else []) + [Path.home() / ".cache/dim_tpu"]:
        for name in CHECKPOINTS:
            cand = base / name
            if cand.exists():
                ckpt = torch.load(str(cand), map_location="cpu")
                sd = ckpt.get("extractor", ckpt.get("state_dict", ckpt))
                _MODEL = disk_model.params_from_torch(sd)
                logger.info(f"Loaded DISK weights from {cand}")
                return _MODEL
    missing_weights("DISK", CHECKPOINTS)
    _MODEL = disk_model.DISK().reset_random(torch.Generator().manual_seed(19)).eval()
    _MODEL_RANDOM = True
    return _MODEL


class DISKExtractor(ExtractorBase):
    default_conf = {
        "max_keypoints": 4096,
        "nms_window_size": 5,
        "detection_threshold": 0.0,
        "pad_if_not_divisible": True,
    }
    grayscale = False
    as_float = True
    descriptor_size = 128

    def __init__(self, config: dict):
        super().__init__(config)
        tpu = self.config.get("general", {}).get("tpu", {})
        self.device = resolve_device(tpu.get("device", "auto"))
        self.model = load_model().to(self.device)
        self.max_keypoints = int(self.conf.get("max_keypoints", 4096))
        self.nms_window_size = int(self.conf.get("nms_window_size", 5))
        self.detection_threshold = float(self.conf.get("detection_threshold", 0.0))

    def _extract(self, image: np.ndarray) -> FeaturesDict:
        if image.ndim == 2:
            image = np.repeat(image[..., None], 3, axis=-1)
        if image.dtype == np.uint8:
            image = image.astype(np.float32) / 255.0
        h, w = image.shape[:2]
        ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
        batch = np.zeros((1, ph, pw, 3), np.float32)
        batch[0, :h, :w] = image
        with full_f32():
            out = disk_model.extract(
                self.model, torch.from_numpy(batch).to(self.device),
                torch.tensor([[h, w]], device=self.device),
                max_keypoints=-(-self.max_keypoints // 128) * 128,
                nms_window_size=self.nms_window_size,
                detection_threshold=self.detection_threshold,
            )
        out = {k: v[0].cpu().numpy() for k, v in out.items()}
        m = out["mask"]
        return {"keypoints": out["keypoints"][m], "scores": out["scores"][m],
                "descriptors": out["descriptors"][m]}
