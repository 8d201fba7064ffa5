"""RIPE detector/descriptor (PyTorch port of
``deep_image_matching_tpu/models/ripe.py``).

RIPE (Künzel et al.): an instance-normalised RGB input, DeDoDe's VGG19-bn
encoder and ConvRefiner decoder (``models/vgg_refiner.py``) in detection
mode (one prototype, 8 hidden blocks) giving a full-resolution heatmap;
3x3 local-maximum NMS, the threshold and the top-k (``ops/detect.py::
select_topk``, ties at the lower index), scores divided by the image's
largest heat; hypercolumn descriptors: the four encoder maps (64 + 128 +
256 + 512 = 960 channels) read at each keypoint with ``align_corners=True``
over the output size, concatenated, optionally reduced by a 1x1 projection,
L2-normalised.

Parameters are a tree of tensors, ``{"encoder", "refiners"}`` and, where
the checkpoint has it, ``"dim_reduction": {"w": (out, in), "b"}``;
``params_from_torch`` reads ``ripe_weights.pth``, folding each BatchNorm
once; ``init_tree`` gives the JAX package's seeded random tree in its
layouts (numpy), which ``convert.ripe_params_from_jax`` carries over.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.deform import bilinear_sample_zeropad
from ..ops.detect import max_pool_same, select_topk
from .vgg_refiner import (
    decode_multiscale,
    init_refiner_tree,
    init_tree as init_vgg19_tree,
    vgg19_features,
)

_REFINERS = {
    "8": (512, 512, 256 + 1), "4": (256 + 256, 256, 128 + 1),
    "2": (128 + 128, 128, 64 + 1), "1": (64 + 64, 64, 1 + 1),
}
HYPERCOLUMN_DIM = 64 + 128 + 256 + 512


def init_tree() -> Dict:
    return {"encoder": init_vgg19_tree(),
            "refiners": {s: init_refiner_tree(ci, h, co, 8)
                         for s, (ci, h, co) in _REFINERS.items()}}


def params_from_torch(state_dict) -> Dict:
    from ..convert import _f32_state, refiner_params_from_torch, vgg19_params_from_torch

    sd = _f32_state(state_dict)
    params = {
        "encoder": vgg19_params_from_torch(sd, "net.encoder.layers"),
        "refiners": {s: refiner_params_from_torch(sd, f"net.decoder.layers.{s}")
                     for s in ("8", "4", "2", "1")},
    }
    if "conv_dim_reduction_coarse_desc.weight" in sd:
        w = sd["conv_dim_reduction_coarse_desc.weight"][:, :, 0]
        params["dim_reduction"] = {
            "w": w, "b": sd.get("conv_dim_reduction_coarse_desc.bias", torch.zeros(w.shape[0]))}
    return params


def _instance_norm(images: torch.Tensor) -> torch.Tensor:
    mu = images.mean(dim=(1, 2), keepdim=True)
    var = (images - mu).square().mean(dim=(1, 2), keepdim=True)
    return (images - mu) * torch.rsqrt(var + 1e-5)


@torch.no_grad()
def extract(params: Dict, images: torch.Tensor, valid_hw: torch.Tensor,
            max_keypoints: int = 4096, threshold: float = 0.5) -> Dict[str, torch.Tensor]:
    """images (B, H, W, 3) in [0, 1], H and W multiples of 8; valid_hw (B, 2)
    the unpadded sizes -> ``keypoints (B, K, 2)``, ``scores (B, K)``,
    ``descriptors (B, K, D)`` and ``mask (B, K)``, valid rows first."""
    feats = vgg19_features(params["encoder"], _instance_norm(images))
    heat = decode_multiscale(feats, params["refiners"], num_prototypes=1)[..., 0]
    nms = torch.where(heat == max_pool_same(heat, 1), heat, heat.new_tensor(0.0))
    kpts, scores, valid = select_topk(nms, max_keypoints, threshold=threshold, border=0,
                                      valid_hw=(valid_hw[:, 0], valid_hw[:, 1]))
    scores = scores / heat.amax(dim=(1, 2)).clamp(min=1e-12)[:, None]
    H, W = images.shape[1:3]
    descs = []
    for b in range(images.shape[0]):
        cols = []
        for fmap in feats:
            Hc, Wc = fmap.shape[1:3]
            gx = kpts[b, :, 0] / (W - 1) * (Wc - 1)
            gy = kpts[b, :, 1] / (H - 1) * (Hc - 1)
            cols.append(bilinear_sample_zeropad(fmap[b], torch.stack([gx, gy], dim=-1)))
        d = torch.cat(cols, dim=-1)
        if "dim_reduction" in params:
            d = d @ params["dim_reduction"]["w"].T + params["dim_reduction"]["b"]
        descs.append(d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp(min=1e-12))
    descs = torch.stack(descs) * valid[..., None]
    return {"keypoints": kpts, "scores": scores, "descriptors": descs, "mask": valid}
