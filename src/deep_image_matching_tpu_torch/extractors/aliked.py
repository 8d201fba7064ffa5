"""ALIKED extractor (port of ``deep_image_matching_tpu/extractors/aliked.py``).

The reference's config surface: ``model_name``, ``max_num_keypoints``,
``detection_threshold``, ``nms_radius``, plus ``compute_dtype`` (bf16 on the
GPU, f32 on the CPU by default) and ``pixel_budget``; the batch size is
``general.tpu.extract_batch_size``. ALIKED has no random initialisation: a
checkpoint ``<model_name>.pth`` in the upstream state-dict layout must be in
``DIM_TPU_WEIGHTS_DIR`` or ``~/.cache/dim_tpu``. Images are bucketed by
their shape padded to multiples of 32 and extracted in batches of at most
``pixel_budget`` pixels on the configured device; a batch that runs out of
device memory is halved and retried, every other error propagates. With
``--tiling`` the tiles go through the host template
(``ExtractorBase._extract_by_tile``) as uint8, one padded batch per shape
bucket (``_extract_many``); as in the JAX package, ALIKED has no device
route. Inside ``ImageMatcher`` an untiled run decodes and uploads the images
on the prefetch pool (``utils/prefetch.py``), pads and stacks them on the
device and keeps the outputs there for the matcher (the device handoff,
``ExtractorBase._arm_device_handoff``).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from ..constants import TileSelection
from ..io.writer import AsyncFeatureWriter
from ..models import aliked as aliked_model
from ..ops.assemble import padded_batches
from ..utils.device import resolve_device
from ..utils.image import Image, read_image
from .extractor_base import ExtractorBase, FeaturesDict

logger = logging.getLogger("dim_tpu_torch")

_PARAM_CACHE: Dict[Path, dict] = {}


def checkpoint_path(model_name: str) -> Path:
    """The first ``<model_name>.pth`` in DIM_TPU_WEIGHTS_DIR, then
    ~/.cache/dim_tpu; FileNotFoundError if there is none."""
    wdir = os.environ.get("DIM_TPU_WEIGHTS_DIR")
    for base in ([Path(wdir)] if wdir else []) + [Path.home() / ".cache/dim_tpu"]:
        cand = base / f"{model_name}.pth"
        if cand.exists():
            return cand
    raise FileNotFoundError(f"No ALIKED checkpoint '{model_name}.pth' found "
                            "(set DIM_TPU_WEIGHTS_DIR)")


def load_params(model_name: str) -> dict:
    """The folded parameters of ``<model_name>.pth`` (on the CPU), loaded
    once per checkpoint file."""
    path = checkpoint_path(model_name)
    if path not in _PARAM_CACHE:
        sd = torch.load(str(path), map_location="cpu")
        _PARAM_CACHE[path] = aliked_model.params_from_torch(sd, model_name)
        logger.info(f"Loaded ALIKED weights from {path}")
    return _PARAM_CACHE[path]


class ALIKEDExtractor(ExtractorBase):
    default_conf = {
        "model_name": "aliked-n16rot",
        "max_num_keypoints": 4000,
        "detection_threshold": 0.2,
        "nms_radius": 3,
    }
    grayscale = False
    as_float = True
    descriptor_size = 128
    # ALIKED's aggregation upsamples every block to the input resolution, so
    # memory grows with batch x pixels: batches hold at most this many
    pixel_budget = 4_200_000
    # the model normalises uint8 on the device, so tiles stay uint8
    tile_uint8 = True

    def __init__(self, config: dict):
        super().__init__(config)
        tpu = self.config.get("general", {}).get("tpu", {})
        self.device = resolve_device(tpu.get("device", "auto"))
        self.model_name = str(self.conf["model_name"])
        self.params = aliked_model.tree_map(lambda t: t.to(self.device),
                                            load_params(self.model_name))
        self.max_keypoints = int(self.conf.get("max_num_keypoints", 4000))
        self.detection_threshold = float(self.conf.get("detection_threshold", 0.2))
        self.nms_radius = int(self.conf.get("nms_radius", 3))
        self.batch_size = int(tpu.get("extract_batch_size", 4))
        self.pixel_budget = int(self.conf.get("pixel_budget", type(self).pixel_budget))
        default = "bfloat16" if self.device.type == "cuda" else "float32"
        self.compute_dtype = getattr(torch, str(self.conf.get("compute_dtype", default)))

    def extract_batch(self, images: List[Image], feature_path) -> None:
        if self.tile_selection is not TileSelection.NONE:
            return super().extract_batch(images, feature_path)
        if self._device_handoff_allowed():
            return self._extract_handoff(images, feature_path)
        prepped = []
        for img in images:
            # uint8 on the host; the device normalises
            arr = read_image(img.path, grayscale=False)
            h, w = arr.shape[:2]
            prepped.append((self._quality_resize(arr), (w, h)))
        results = self._run([arr for arr, _ in prepped])
        with AsyncFeatureWriter(feature_path) as writer:
            for img, (arr, (w, h)), feats in zip(images, prepped, results):
                ah, aw = arr.shape[:2]
                kpts = feats["keypoints"] * np.array([w / aw, h / ah], np.float32)
                size = np.array([w, h], np.int64)
                writer.put(img.name, keypoints=kpts, descriptors=feats["descriptors"],
                           scores=feats["scores"], image_size=size)
                self._cache_put(img.name, keypoints=kpts, descriptors=feats["descriptors"],
                                scores=feats["scores"], image_size=size)

    def _extract(self, image: np.ndarray) -> FeaturesDict:
        return self._run([image])[0]

    def _extract_many(self, images) -> list:
        """One image's tiles as padded batches per shape bucket through
        ``_run`` (with its out-of-memory halving)."""
        return self._run(images)

    def _device_batches(self, images):
        """Images (h, w, 3) (or grey, repeated), uint8 or float in [0, 1], on
        the host or the device, as padded batches (multiples of 32, at most ``pixel_budget`` pixels a batch, halved on running out
        of device memory) -> (indices, padded device outputs) per batch."""
        return padded_batches(
            images, 32, 3, self.batch_size,
            lambda batch, vhw: aliked_model.extract(
                self.params, batch, vhw, max_keypoints=self.max_keypoints,
                detection_threshold=self.detection_threshold, nms_radius=self.nms_radius,
                model_name=self.model_name, compute_dtype=self.compute_dtype),
            self.device, pixel_budget=self.pixel_budget)
