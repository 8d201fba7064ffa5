"""SuperPoint detector/descriptor (PyTorch port of
``deep_image_matching_tpu/models/superpoint.py``).

``SuperPoint`` is an ``nn.Module`` with the original torch state-dict keys
(``conv1a.weight`` ... ``convDb.bias``), so published checkpoints load
unchanged. ``dense_forward`` and ``extract`` keep the JAX package's NHWC
layouts at their boundary: images (B, H, W, 1), descriptor maps
(B, H/8, W/8, 256), fixed-capacity (B, K, ...) keypoint outputs with a
validity mask. Convolutions are ``torch.nn.functional.conv2d``: the JAX
package leaves them to XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.detect import sample_descriptors_sp, select_topk, simple_nms

logger = logging.getLogger("dim_tpu_torch")

_CONV_LAYERS = [
    # name, in, out, kernel
    ("conv1a", 1, 64, 3),
    ("conv1b", 64, 64, 3),
    ("conv2a", 64, 64, 3),
    ("conv2b", 64, 64, 3),
    ("conv3a", 64, 128, 3),
    ("conv3b", 128, 128, 3),
    ("conv4a", 128, 128, 3),
    ("conv4b", 128, 128, 3),
    ("convPa", 128, 256, 3),
    ("convPb", 256, 65, 1),
    ("convDa", 128, 256, 3),
    ("convDb", 256, 256, 1),
]


class SuperPoint(nn.Module):
    """The SuperPoint network's parameters under their torch names."""

    def __init__(self):
        super().__init__()
        for name, cin, cout, k in _CONV_LAYERS:
            setattr(self, name, nn.Conv2d(cin, cout, k, padding=(k - 1) // 2))

    @torch.no_grad()
    def reset_random(self, generator: torch.Generator) -> "SuperPoint":
        """He-normal weights and zero biases drawn from ``generator``."""
        for name, cin, _, k in _CONV_LAYERS:
            conv = getattr(self, name)
            std = (2.0 / (cin * k * k)) ** 0.5
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=generator) * std)
            conv.bias.zero_()
        return self


@torch.no_grad()
def dense_forward(
    model: SuperPoint, images: torch.Tensor, compute_dtype: torch.dtype = torch.float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """images: (B, H, W, 1) uint8 or float in [0, 1], H and W multiples of 8.

    Returns (scores (B, H, W) f32, desc_map (B, H/8, W/8, 256) f32, not yet
    normalised). A bf16 ``compute_dtype`` runs the conv stack in bf16; the
    detection softmax stays f32."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    x = images.permute(0, 3, 1, 2).to(compute_dtype)

    def conv(x, name, relu=True):
        m = getattr(model, name)
        y = F.conv2d(x, m.weight.to(compute_dtype), m.bias.to(compute_dtype),
                     padding=m.padding)
        return F.relu(y) if relu else y

    x = conv(conv(x, "conv1a"), "conv1b")
    x = F.max_pool2d(x, 2, 2)
    x = conv(conv(x, "conv2a"), "conv2b")
    x = F.max_pool2d(x, 2, 2)
    x = conv(conv(x, "conv3a"), "conv3b")
    x = F.max_pool2d(x, 2, 2)
    x = conv(conv(x, "conv4a"), "conv4b")

    heat = conv(conv(x, "convPa"), "convPb", relu=False).float()
    heat = torch.softmax(heat, dim=1)[:, :-1]            # (B, 64, Hc, Wc)
    B, _, Hc, Wc = heat.shape
    scores = heat.permute(0, 2, 3, 1).reshape(B, Hc, Wc, 8, 8)
    scores = scores.permute(0, 1, 3, 2, 4).reshape(B, Hc * 8, Wc * 8)

    desc = conv(conv(x, "convDa"), "convDb", relu=False)
    return scores, desc.permute(0, 2, 3, 1).float()


@torch.no_grad()
def extract(
    model: SuperPoint,
    images: torch.Tensor,        # (B, H, W, 1)
    valid_hw: torch.Tensor,      # (B, 2) unpadded (h, w) per image
    max_keypoints: int = 2048,
    nms_radius: int = 4,
    keypoint_threshold: float = 0.0005,
    remove_borders: int = 4,
    compute_dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """Backbone + NMS + top-k + descriptor sampling. Returns
    ``keypoints (B,K,2)`` (x, y), ``scores (B,K)``, ``descriptors (B,K,256)``
    L2-normalised and zero on invalid rows, ``mask (B,K)``."""
    scores, desc_map = dense_forward(model, images, compute_dtype)
    desc_map = desc_map / torch.linalg.norm(desc_map, dim=-1, keepdim=True).clamp(min=1e-12)
    scores = simple_nms(scores, nms_radius)
    kpts, kscores, valid = select_topk(
        scores, max_keypoints, threshold=keypoint_threshold,
        border=remove_borders, valid_hw=(valid_hw[:, 0], valid_hw[:, 1]),
    )
    descs = sample_descriptors_sp(kpts, desc_map) * valid[..., None]
    return {"keypoints": kpts, "scores": kscores, "descriptors": descs, "mask": valid}


class SuperPointRunner:
    """Host-side batched extraction over images: buckets images by padded
    shape, runs ``extract`` per bucket batch on ``device``, returns
    per-image trimmed features (numpy)."""

    def __init__(
        self,
        model: Optional[SuperPoint] = None,
        max_keypoints: int = 2048,
        nms_radius: int = 4,
        keypoint_threshold: float = 0.0005,
        remove_borders: int = 4,
        resize_max: Optional[int] = None,
        batch_size: int = 8,
        device: torch.device = torch.device("cpu"),
    ):
        self.device = torch.device(device)
        self.model = (model if model is not None else load_default_model()).to(self.device)
        self.max_keypoints = max_keypoints
        self.nms_radius = nms_radius
        self.keypoint_threshold = keypoint_threshold
        self.remove_borders = remove_borders
        self.resize_max = resize_max
        self.batch_size = batch_size
        # bf16 convolutions on the GPU, f32 on the CPU (the JAX package's
        # accelerator/CPU split)
        self.compute_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32

    def extract_images(self, paths) -> list:
        import cv2

        from ..utils.image import read_image

        prepped = []
        for p in paths:
            img = read_image(p, grayscale=True)
            h, w = img.shape
            scale = 1.0
            if self.resize_max and max(h, w) > self.resize_max:
                scale = self.resize_max / max(h, w)
                img = cv2.resize(img, (round(w * scale), round(h * scale)),
                                 interpolation=cv2.INTER_AREA)
            prepped.append((img, scale, (w, h)))
        return self.extract_arrays(prepped)

    def extract_arrays(self, prepped) -> list:
        """prepped: list of (image (h, w) uint8 or float in [0, 1], scale,
        orig (w, h)); keypoints come back divided by ``scale``."""
        pad_to = 64  # shape-bucket granularity (multiple of 8)
        buckets: Dict[Tuple[int, int], list] = {}
        for i, (img, _, _) in enumerate(prepped):
            h, w = img.shape
            key = (-(-h // pad_to) * pad_to, -(-w // pad_to) * pad_to)
            buckets.setdefault(key, []).append(i)
        batch_dtype = (
            np.uint8 if all(p[0].dtype == np.uint8 for p in prepped) else np.float32
        )
        results = [None] * len(prepped)
        for (ph, pw), idxs in buckets.items():
            for start in range(0, len(idxs), self.batch_size):
                chunk = idxs[start:start + self.batch_size]
                batch = np.zeros((len(chunk), ph, pw, 1), batch_dtype)
                vhw = np.zeros((len(chunk), 2), np.int64)
                for j, i in enumerate(chunk):
                    im = prepped[i][0]
                    if batch_dtype == np.float32 and im.dtype == np.uint8:
                        im = im.astype(np.float32) / 255.0
                    h, w = im.shape
                    batch[j, :h, :w, 0] = im
                    vhw[j] = (h, w)
                out = extract(
                    self.model, torch.from_numpy(batch).to(self.device),
                    torch.from_numpy(vhw).to(self.device), self.max_keypoints,
                    self.nms_radius, self.keypoint_threshold,
                    self.remove_borders, self.compute_dtype,
                )
                # descriptors are stored float16 in features.h5 anyway
                out["descriptors"] = out["descriptors"].half()
                out = {k: v.cpu().numpy() for k, v in out.items()}
                for j, i in enumerate(chunk):
                    m = out["mask"][j]
                    results[i] = {
                        "keypoints": out["keypoints"][j][m] / prepped[i][1],
                        "scores": out["scores"][j][m],
                        "descriptors": out["descriptors"][j][m],
                        "image_size": np.asarray(prepped[i][2], np.int64),
                    }
        return results


_DEFAULT_MODEL: Optional[SuperPoint] = None
_DEFAULT_MODEL_RANDOM = False


def load_default_model() -> SuperPoint:
    """Pretrained weights if a checkpoint exists (DIM_TPU_WEIGHTS_DIR or
    ~/.cache/dim_tpu, ``superpoint_v1.pth``), else He-normal random weights
    from a seeded generator, subject to the weights policy
    (``utils/weights.py``). Cached random weights re-consult the policy, so
    a strict() probe never receives them."""
    global _DEFAULT_MODEL, _DEFAULT_MODEL_RANDOM
    from ..utils.weights import missing_weights, reject_cached_random

    if _DEFAULT_MODEL is not None:
        if _DEFAULT_MODEL_RANDOM:
            reject_cached_random("SuperPoint", ["superpoint_v1.pth"])
        return _DEFAULT_MODEL
    wdir = os.environ.get("DIM_TPU_WEIGHTS_DIR")
    candidates = ([Path(wdir) / "superpoint_v1.pth"] if wdir else []) + [
        Path.home() / ".cache/dim_tpu/superpoint_v1.pth"
    ]
    model = SuperPoint()
    for cand in candidates:
        if cand.exists():
            model.load_state_dict(torch.load(str(cand), map_location="cpu"))
            logger.info(f"Loaded SuperPoint weights from {cand}")
            _DEFAULT_MODEL = model.eval()
            return _DEFAULT_MODEL
    missing_weights("SuperPoint", ["superpoint_v1.pth"])
    _DEFAULT_MODEL = model.reset_random(torch.Generator().manual_seed(0)).eval()
    _DEFAULT_MODEL_RANDOM = True
    return _DEFAULT_MODEL
