"""DeDoDe extractor (port of ``deep_image_matching_tpu/extractors/dedode.py``).

The reference's config surface (``n_features``, ``resolution``, and
``descriptor``: ``B`` or ``G``). Each image (RGB in [0, 1]) is resized to
``resolution`` x ``resolution`` (a multiple of 56 for G: its DINOv2 tokens
are 1/14 and its pyramid 1/8), the detector keeps ``n_features`` rounded up
to 128 keypoints, all valid, and the descriptor reads them; keypoints go
back to the image's pixels. The convolutions run in full f32
(``utils/device.full_f32``: under cuDNN's default TF32 the card's top-k at
784 px no longer matched the CPU's). Descriptor G's DINOv2 runs in bf16, or
in f32 where ``general.tpu.dtype`` is ``float32`` (on CUDA its attention is
kernel 1's bf16 or f32 form).

Weights: ``dedode_detector_L.pth`` (or ``_v2``), ``dedode_descriptor_B.pth``,
``dedode_descriptor_G.pth`` with ``dinov2_vitl14_pretrain.pth`` in
DIM_TPU_WEIGHTS_DIR or ~/.cache/dim_tpu; a missing one gives the JAX
package's seeded random weights under the weights policy (G's DINOv2 at
depth 2, also when only its checkpoint is missing).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..models import dedode as dd
from ..models import dinov2
from ..utils.device import check_matcher_dtype, full_f32, resolve_device, to_device
from ..utils.image import resize_image
from .extractor_base import ExtractorBase, FeaturesDict

logger = logging.getLogger("dim_tpu_torch")

CHECKPOINTS = {
    "detector": ("dedode_detector_L.pth", "dedode_detector_L_v2.pth"),
    "descriptor": ("dedode_descriptor_B.pth",),
    "descriptor_g": ("dedode_descriptor_G.pth",),
}
_INIT = {"detector": dd.init_detector, "descriptor": dd.init_descriptor,
         "descriptor_g": dd.init_descriptor_g}
_PARAMS: Dict[str, Dict] = {}
_RANDOM: set = set()


def _seeded_dinov2() -> Dict:
    from ..convert import dinov2_params_from_jax

    return dinov2_params_from_jax(dinov2.init_tree(depth=2))


def load_params(kind: str) -> Dict:
    """``kind``'s parameters on the CPU ("detector", "descriptor" or
    "descriptor_g"), loaded once per process; cached random weights
    re-consult the policy."""
    from ..convert import dedode_params_from_jax, dinov2_params_from_torch
    from ..utils.weights import missing_weights, reject_cached_random

    names = CHECKPOINTS[kind]
    if kind in _PARAMS:
        if kind in _RANDOM:
            reject_cached_random(f"DeDoDe {kind}", names)
        return _PARAMS[kind]
    wdir = os.environ.get("DIM_TPU_WEIGHTS_DIR")
    for base in ([Path(wdir)] if wdir else []) + [Path.home() / ".cache/dim_tpu"]:
        for name in names:
            cand = base / name
            if not cand.exists():
                continue
            sd = torch.load(str(cand), map_location="cpu")
            dino = None
            if kind == "descriptor_g":
                dcand = base / "dinov2_vitl14_pretrain.pth"
                if dcand.exists():
                    dino = dinov2_params_from_torch(torch.load(str(dcand), map_location="cpu"))
                else:
                    logger.warning("dedode_descriptor_G.pth found but "
                                   "dinov2_vitl14_pretrain.pth is missing - its DINOv2 "
                                   "is random (depth 2)")
                    dino = _seeded_dinov2()
            _PARAMS[kind] = dd.params_from_torch(sd, dino)
            logger.info(f"Loaded DeDoDe {kind} weights from {cand}")
            return _PARAMS[kind]
    missing_weights(f"DeDoDe {kind}", names)
    tree = _INIT[kind]()
    dino = _seeded_dinov2() if kind == "descriptor_g" else None
    _PARAMS[kind] = dd.params_from_torch(dedode_params_from_jax(tree), dino)
    _RANDOM.add(kind)
    return _PARAMS[kind]


class DeDoDeExtractor(ExtractorBase):
    default_conf = {
        "n_features": 4000,
        "upright": False,
        "resolution": 784,
    }
    grayscale = False
    as_float = True
    descriptor_size = 256

    def __init__(self, config: dict):
        super().__init__(config)
        tpu = self.config.get("general", {}).get("tpu", {})
        self.device = resolve_device(tpu.get("device", "auto"))
        self.descriptor_variant = str(self.conf.get("descriptor", "B")).upper()
        self.n_features = int(self.conf.get("n_features", 4000))
        self.resolution = int(self.conf.get("resolution", 784))
        if self.descriptor_variant == "G" and self.resolution % 56 != 0:
            raise ValueError("descriptor-G needs resolution divisible by 56")
        self.det_params = to_device(load_params("detector"), self.device)
        kind = "descriptor_g" if self.descriptor_variant == "G" else "descriptor"
        desc = to_device(load_params(kind), self.device)
        self.dino_dtype = torch.bfloat16
        if kind == "descriptor_g":
            if str(tpu.get("dtype", "bfloat16")) == "float32":
                self.dino_dtype = torch.float32
            check_matcher_dtype(self.device, self.dino_dtype)
            # DINOv2's blocks cast once, not per image
            desc = {**desc, "dinov2": dinov2.prepare(desc["dinov2"], self.dino_dtype)}
        self.desc_params = desc

    def _extract(self, image: np.ndarray) -> FeaturesDict:
        if image.ndim == 2:
            image = np.repeat(image[..., None], 3, axis=-1)
        h, w = image.shape[:2]
        res = self.resolution
        work = resize_image(image.astype(np.float32), (res, res))
        batch = torch.from_numpy(np.ascontiguousarray(work[None])).to(self.device)
        cap = -(-self.n_features // 128) * 128
        with full_f32():
            kpts, conf, valid = dd.detect(self.det_params, batch, num_keypoints=cap)
            if self.descriptor_variant == "G":
                descs = dd.describe_g(self.desc_params, batch, kpts, dino_dtype=self.dino_dtype)
            else:
                descs = dd.describe(self.desc_params, batch, kpts)
        kpts, conf, valid, descs = (t[0].cpu().numpy() for t in (kpts, conf, valid, descs))
        kpts = kpts[valid] * np.array([w / res, h / res], np.float32)
        return {"keypoints": kpts, "scores": conf[valid], "descriptors": descs[valid]}
