"""ALIKE extractor (port of ``deep_image_matching_tpu/extractors/alike.py``).

The reference's config surface: ``model`` (alike-t, alike-s, alike-n,
alike-l), ``top_k``, ``scores_th``, ``n_limit`` (the keypoint capacity is
``min(n_limit, 8192)`` rounded up to 128) and ``subpixel`` (DKD always
refines); the batch size is ``general.tpu.extract_batch_size``. ALIKE has
no random initialisation: ``<model>.pth`` in the upstream state-dict layout
must be in DIM_TPU_WEIGHTS_DIR or ~/.cache/dim_tpu, else construction
raises ``FileNotFoundError``.

Images are read as uint8 RGB, resized to the quality (as uint8, as the
port's SuperPoint and ALIKED are; the JAX package resizes ALIKE's f32
image), bucketed by their shape padded to multiples of 32 and extracted in
batches on the configured device, the network in full f32. Inside
``ImageMatcher`` an untiled run decodes and uploads the images on the
prefetch pool (``utils/prefetch.py``), pads and stacks them on the device
and keeps the outputs there for the matcher (the device handoff,
``ExtractorBase._arm_device_handoff``). With ``--tiling`` the tiles take the
host template.
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
from ..models import alike as alike_model
from ..ops.assemble import padded_batches
from ..utils.device import resolve_device, to_device
from ..utils.image import Image, read_image
from .extractor_base import ExtractorBase, FeaturesDict

logger = logging.getLogger("dim_tpu_torch")

_PARAM_CACHE: Dict[Path, dict] = {}


def load_params(model_name: str) -> dict:
    """The folded parameters of the first ``<model_name>.pth`` in
    DIM_TPU_WEIGHTS_DIR, then ~/.cache/dim_tpu (on the CPU, loaded once per
    file); FileNotFoundError if there is none."""
    wdir = os.environ.get("DIM_TPU_WEIGHTS_DIR")
    for base in ([Path(wdir)] if wdir else []) + [Path.home() / ".cache/dim_tpu"]:
        cand = base / f"{model_name}.pth"
        if cand.exists():
            if cand not in _PARAM_CACHE:
                _PARAM_CACHE[cand] = alike_model.params_from_torch(
                    torch.load(str(cand), map_location="cpu"), model_name)
                logger.info(f"Loaded ALIKE weights from {cand}")
            return _PARAM_CACHE[cand]
    raise FileNotFoundError(f"No ALIKE checkpoint '{model_name}.pth' found "
                            "(set DIM_TPU_WEIGHTS_DIR)")


class AlikeExtractor(ExtractorBase):
    default_conf = {
        "model": "alike-n",
        "top_k": 15000,
        "scores_th": 0.2,
        "n_limit": 15000,
        "subpixel": True,
    }
    grayscale = False
    as_float = True
    descriptor_size = 128

    def __init__(self, config: dict):
        super().__init__(config)
        tpu = self.config.get("general", {}).get("tpu", {})
        self.device = resolve_device(tpu.get("device", "auto"))
        self.model_name = str(self.conf["model"])
        self.params = to_device(load_params(self.model_name), self.device)
        self.descriptor_size = alike_model.CONFIGS[self.model_name]["dim"]
        self.max_keypoints = int(self.conf.get("n_limit", 15000))
        self.scores_th = float(self.conf.get("scores_th", 0.2))
        self.batch_size = int(tpu.get("extract_batch_size", 4))

    def extract_batch(self, images: List[Image], feature_path) -> None:
        if self.tile_selection is not TileSelection.NONE:
            return super().extract_batch(images, feature_path)
        if self._device_handoff_allowed():
            return self._extract_handoff(images, feature_path)
        prepped = []
        for img in images:
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
        """One image or tile (the host template's hook)."""
        return self._run([image])[0]

    def _device_batches(self, images):
        """Images (h, w, 3) (or grey, repeated), uint8 or float in [0, 1], on
        the host or the device, as padded batches (multiples of 32) ->
        (indices, padded device outputs) per batch."""
        cap = ((min(self.max_keypoints, 8192) + 127) // 128) * 128
        return padded_batches(
            images, 32, 3, self.batch_size,
            lambda batch, vhw: alike_model.extract(self.params, batch, vhw, max_keypoints=cap,
                                                   scores_th=self.scores_th, nms_radius=2),
            self.device)
