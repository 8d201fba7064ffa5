"""KeyNet+AffNet+HardNet extractor (port of
``deep_image_matching_tpu/extractors/keynetaffnethardnet.py``).

The reference's config surface (``n_features``, ``upright``) plus the JAX
package's ``detector`` ("auto", "keynet" or "doh"). Each stage takes its
weights from DIM_TPU_WEIGHTS_DIR or ~/.cache/dim_tpu as the JAX package
does, with its weight policy per stage:

- HardNet (``hardnet.pth``, ``HardNet++.pth``,
  ``checkpoint_liberty_with_aug.pth``; the state dict under ``state_dict``
  or at the top): seeded random weights under the weights policy;
- KeyNet (``keynet.pth``, ``keynet_pytorch.pth``, ``keynet_pytorch.ckpt``):
  without them ``detector: auto`` takes the weight-free
  determinant-of-Hessian detector, logged as a classical fallback;
- AffNet (``affnet.pth``, ``AffNet.pth``) and OriNet (``orinet.pth``,
  ``OriNet.pth``): without them the identity shape and the gradient-moment
  orientation, logged the same way.

Each image (grey in [0, 1], unpadded) runs through
``models/hardnet.py::keynet_hardnet_extract`` on the configured device with
a capacity of ``n_features`` (at most 8192) rounded up to 128, its
convolutions in full f32 (``utils/device.full_f32``: under cuDNN's default
TF32 the learned stages' keypoints on the demo images were 0.9835 of the
CPU's, their raw matches 0.8495).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np
import torch

from ..models import affnet as an
from ..models import hardnet as hn
from ..models import keynet as kn
from ..utils.device import full_f32, resolve_device
from .extractor_base import ExtractorBase, FeaturesDict

logger = logging.getLogger("dim_tpu_torch")

HARDNET_CHECKPOINTS = ("hardnet.pth", "HardNet++.pth", "checkpoint_liberty_with_aug.pth")
KEYNET_CHECKPOINTS = ("keynet.pth", "keynet_pytorch.pth", "keynet_pytorch.ckpt")
FRAME_CHECKPOINTS = {"affnet": ("affnet.pth", "AffNet.pth"), "orinet": ("orinet.pth", "OriNet.pth")}

_HARDNET = None
_HARDNET_RANDOM = False
_UNSET = object()
_KEYNET = _UNSET
_FRAMES = _UNSET


def _bases():
    wdir = os.environ.get("DIM_TPU_WEIGHTS_DIR")
    return ([Path(wdir)] if wdir else []) + [Path.home() / ".cache/dim_tpu"]


def _state_dict(path: Path) -> dict:
    ckpt = torch.load(str(path), map_location="cpu")
    return ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt


def load_hardnet() -> hn.HardNet:
    global _HARDNET, _HARDNET_RANDOM
    from ..utils.weights import missing_weights, reject_cached_random

    if _HARDNET is not None:
        if _HARDNET_RANDOM:
            reject_cached_random("HardNet", HARDNET_CHECKPOINTS)
        return _HARDNET
    for base in _bases():
        for name in HARDNET_CHECKPOINTS:
            cand = base / name
            if cand.exists():
                _HARDNET = hn.hardnet_params_from_torch(_state_dict(cand))
                logger.info(f"Loaded HardNet weights from {cand}")
                return _HARDNET
    missing_weights("HardNet", HARDNET_CHECKPOINTS)
    _HARDNET = hn.HardNet().reset_random(torch.Generator().manual_seed(23)).eval()
    _HARDNET_RANDOM = True
    return _HARDNET


def load_keynet():
    """The learned KeyNet response, or None (the weight-free
    determinant-of-Hessian detector takes over)."""
    global _KEYNET
    if _KEYNET is not _UNSET:
        return _KEYNET
    from ..utils.weights import classical_fallback

    for base in _bases():
        for name in KEYNET_CHECKPOINTS:
            cand = base / name
            if cand.exists():
                try:
                    _KEYNET = kn.keynet_params_from_torch(_state_dict(cand))
                    logger.info(f"Loaded KeyNet weights from {cand}")
                    return _KEYNET
                except KeyError as e:
                    logger.warning(f"KeyNet checkpoint {cand} not convertible: {e}")
    classical_fallback("KeyNet", "determinant-of-Hessian detection")
    _KEYNET = None
    return _KEYNET


def load_affnet_orinet():
    """(AffNet, OriNet), each None without weights (the identity shape, the
    gradient-moment orientation)."""
    global _FRAMES
    if _FRAMES is not _UNSET:
        return _FRAMES
    from ..utils.weights import classical_fallback

    convert = {"affnet": an.affnet_params_from_torch, "orinet": an.orinet_params_from_torch}
    found = {"affnet": None, "orinet": None}
    for base in _bases():
        for net, names in FRAME_CHECKPOINTS.items():
            if found[net] is not None:
                continue
            for name in names:
                cand = base / name
                if not cand.exists():
                    continue
                try:
                    found[net] = convert[net](_state_dict(cand))
                    logger.info(f"Loaded {net} weights from {cand}")
                    break
                except KeyError as e:
                    logger.warning(f"{net} checkpoint {cand} not convertible: {e}")
    if found["affnet"] is None:
        classical_fallback("AffNet", "identity affine shape")
    if found["orinet"] is None:
        classical_fallback("OriNet", "gradient-moment orientation")
    _FRAMES = (found["affnet"], found["orinet"])
    return _FRAMES


class KeyNetAffNetHardNetExtractor(ExtractorBase):
    default_conf = {
        "n_features": 4000,
        "upright": False,
    }
    grayscale = True
    as_float = True
    descriptor_size = 128

    def __init__(self, config: dict):
        super().__init__(config)
        tpu = self.config.get("general", {}).get("tpu", {})
        self.device = resolve_device(tpu.get("device", "auto"))
        self.hardnet = load_hardnet().to(self.device)
        self.n_features = int(self.conf.get("n_features", 4000))
        self.upright = bool(self.conf.get("upright", False))
        # detector: "keynet" (learned, needs weights), "doh" (weight-free),
        # or "auto": keynet where its weights are found
        requested = str(self.conf.get("detector", "auto"))
        self.keynet = load_keynet() if requested != "doh" else None
        if requested == "keynet" and self.keynet is None:
            logger.warning("detector=keynet requested but no weights; using doh")
        self.detector = "keynet" if self.keynet is not None else "doh"
        if self.keynet is not None:
            self.keynet = self.keynet.to(self.device)
        affnet, orinet = load_affnet_orinet()
        self.affnet = None if affnet is None else affnet.to(self.device)
        self.orinet = None if orinet is None else orinet.to(self.device)

    def _extract(self, image: np.ndarray) -> FeaturesDict:
        if image.ndim == 3:
            image = image.mean(-1)
        h, w = image.shape
        with full_f32():
            out = hn.keynet_hardnet_extract(
                self.hardnet, torch.from_numpy(image[None].astype(np.float32)).to(self.device),
                torch.tensor([[h, w]], device=self.device),
                max_keypoints=-(-min(self.n_features, 8192) // 128) * 128,
                upright=self.upright, detector=self.detector, keynet=self.keynet,
                affnet=self.affnet, orinet=self.orinet,
            )
        out = {k: v[0].cpu().numpy() for k, v in out.items()}
        m = out["mask"]
        return {"keypoints": out["keypoints"][m], "scores": out["scores"][m],
                "descriptors": out["descriptors"][m]}
