"""DeDoDe detector-L and descriptors B and G (PyTorch port of
``deep_image_matching_tpu/models/dedode.py``).

DeDoDe (Edstedt et al.): the VGG19-bn encoder and per-scale ConvRefiner
decoders of ``models/vgg_refiner.py``. The detector softmaxes its logits
over the whole image, reweights them by local density (a separable 51-tap
gaussian, ``_coverage_reweight``) and keeps the top-k, all rows valid,
ties at the lower index first. Its logits are upsampled bilinearly between
scales, as the JAX package does (the reference upsamples them bicubically;
the JAX package's docstring records the divergence). The descriptors read
their 256-d map at the keypoints with ``grid_sample``'s
``align_corners=False`` convention and L2-normalise. Descriptor G adds
DINOv2 ViT-L tokens at 1/14 (``models/dinov2.py::forward_features``, whose
attention is kernel 1 on CUDA) as a fifth, coarsest scale.

Parameters are trees of tensors: ``{"encoder": VGG19 stages, "refiners":
{scale: ConvRefiner}}`` and, for G, ``"dinov2"``. ``params_from_torch``
reads the released checkpoints (``dedode_detector_L.pth``,
``dedode_descriptor_B.pth``, ``dedode_descriptor_G.pth``), folding each
BatchNorm once; ``init_*`` give the JAX package's seeded random trees in its
layouts (numpy), which ``convert.dedode_params_from_jax`` carries over.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.deform import bilinear_sample_zeropad
from . import dinov2 as dino
from .vgg_refiner import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    decode_multiscale,
    init_refiner_tree,
    init_tree as init_vgg19_tree,
    vgg19_features,
)

_DETECTOR_REFINERS = {  # scale: (cin, hidden, cout = context + prototypes)
    "8": (512, 512, 256 + 1), "4": (256 + 256, 256, 128 + 1),
    "2": (128 + 128, 128, 64 + 1), "1": (64 + 64, 64, 1 + 1),
}
_DESCRIPTOR_REFINERS = {
    "8": (512, 512, 256 + 256), "4": (256 + 256, 256, 128 + 256),
    "2": (128 + 128, 64, 32 + 256), "1": (64 + 32, 32, 1 + 256),
}
# descriptor G: DINOv2 tokens join at /14
_DESCRIPTOR_G_REFINERS = {
    "14": (1024, 768, 512 + 256), "8": (512 + 512, 512, 256 + 256),
    "4": (256 + 256, 256, 128 + 256), "2": (128 + 128, 64, 32 + 256),
    "1": (64 + 32, 32, 1 + 256),
}
DESC_DIM = 256


def _init(table: Dict, n_hidden: int) -> Dict:
    return {"encoder": init_vgg19_tree(),
            "refiners": {s: init_refiner_tree(ci, h, co, n_hidden)
                         for s, (ci, h, co) in table.items()}}


def init_detector() -> Dict:
    return _init(_DETECTOR_REFINERS, 8)


def init_descriptor() -> Dict:
    return _init(_DESCRIPTOR_REFINERS, 5)


def init_descriptor_g(dinov2_depth: int = 2) -> Dict:
    """Descriptor G's seeded tree, DINOv2 ViT-L at ``dinov2_depth`` blocks."""
    return {**_init(_DESCRIPTOR_G_REFINERS, 5), "dinov2": dino.init_tree(depth=dinov2_depth)}


def params_from_torch(state_dict, dinov2: Optional[Dict] = None) -> Dict:
    """A detector, descriptor-B or descriptor-G checkpoint -> the port's tree.
    G (``encoder.vgg.layers.*``) takes its DINOv2 as a port tree
    (``convert.dinov2_params_from_torch`` / ``dinov2_params_from_jax``)."""
    from ..convert import _f32_state, refiner_params_from_torch, vgg19_params_from_torch

    sd = _f32_state(state_dict)
    g = any(k.startswith("encoder.vgg.layers.") for k in sd)
    scales = ("14", "8", "4", "2", "1") if g else ("8", "4", "2", "1")
    params = {
        "encoder": vgg19_params_from_torch(sd, "encoder.vgg.layers" if g else "encoder.layers"),
        "refiners": {s: refiner_params_from_torch(sd, f"decoder.layers.{s}") for s in scales},
    }
    if g:
        if dinov2 is None:
            raise ValueError("descriptor G needs its DINOv2 parameters")
        params["dinov2"] = dinov2
    return params


def _normalize(images: torch.Tensor) -> torch.Tensor:
    mean = torch.as_tensor(IMAGENET_MEAN, device=images.device)
    std = torch.as_tensor(IMAGENET_STD, device=images.device)
    return (images - mean) / std


def detector_logits(params: Dict, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> keypoint logits (B, H, W)."""
    feats = vgg19_features(params["encoder"], _normalize(images))
    return decode_multiscale(feats, params["refiners"], num_prototypes=1)[..., 0]


def _coverage_reweight(scoremap: torch.Tensor) -> torch.Tensor:
    """Local-density reweighting: (B, H, W) scores times the density (a
    separable 51-tap gaussian over the scaled scores, zero padded) to the
    power -1/2."""
    w = torch.exp(-torch.linspace(-2, 2, 51, dtype=torch.float64) ** 2).to(scoremap)
    x = ((scoremap + 1e-6) * 10000.0)[:, None]
    x = F.conv2d(x, w.reshape(1, 1, 1, 51), padding=(0, 25))
    dens = F.conv2d(x, w.reshape(1, 1, 51, 1), padding=(25, 0))[:, 0]
    return scoremap * (dens + 1e-8) ** -0.5


@torch.no_grad()
def detect(params: Dict, images: torch.Tensor, num_keypoints: int = 4096):
    """(B, H, W, 3) in [0, 1] -> keypoints (B, K, 2) in pixels, their
    probabilities (B, K) and validity (B, K), every row valid."""
    B, H, W, _ = images.shape
    logits = detector_logits(params, images)
    p = torch.softmax(logits.reshape(B, H * W), dim=-1)
    score = _coverage_reweight(p.reshape(B, H, W))
    _, idx = torch.sort(score.reshape(B, H * W), dim=1, descending=True, stable=True)
    idx = idx[:, :num_keypoints]
    kpts = torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)
    conf = torch.gather(p, 1, idx)
    return kpts, conf, torch.ones_like(conf, dtype=torch.bool)


def _sample_normalized(grid: torch.Tensor, kpts: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, Hg, Wg, C) maps read at (B, K, 2) pixel keypoints of an (H, W)
    image (``grid_sample``, ``align_corners=False``, zero padding), then
    L2-normalised."""
    _, Hg, Wg, _ = grid.shape
    out = []
    for g, k in zip(grid, kpts):
        gx = (2.0 * k[:, 0] / (W - 1) - 1.0 + 1.0) * Wg / 2.0 - 0.5
        gy = (2.0 * k[:, 1] / (H - 1) - 1.0 + 1.0) * Hg / 2.0 - 0.5
        d = bilinear_sample_zeropad(g, torch.stack([gx, gy], dim=-1))
        out.append(d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp(min=1e-12))
    return torch.stack(out)


@torch.no_grad()
def describe(params: Dict, images: torch.Tensor, kpts: torch.Tensor) -> torch.Tensor:
    """Descriptor B: (B, H, W, 3) in [0, 1], (B, K, 2) pixel keypoints ->
    (B, K, 256) unit descriptors."""
    feats = vgg19_features(params["encoder"], _normalize(images))
    grid = decode_multiscale(feats, params["refiners"], num_prototypes=DESC_DIM)
    return _sample_normalized(grid, kpts, *images.shape[1:3])


@torch.no_grad()
def describe_g(params: Dict, images: torch.Tensor, kpts: torch.Tensor,
               dino_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Descriptor G: the VGG pyramid and DINOv2's 1/14 tokens decoded coarse
    to fine; H and W multiples of 14 and 8."""
    x = _normalize(images)
    feats = vgg19_features(params["encoder"], x)
    B, H, W, _ = images.shape
    tokens = dino.forward_features(params["dinov2"], x, compute_dtype=dino_dtype)
    f14 = tokens.reshape(B, H // 14, W // 14, -1)
    grid = decode_multiscale(feats + [f14], params["refiners"], num_prototypes=DESC_DIM,
                             scales=("14", "8", "4", "2", "1"))
    return _sample_normalized(grid, kpts, H, W)
