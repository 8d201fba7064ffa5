"""XFeat detector/descriptor (PyTorch port of
``deep_image_matching_tpu/models/xfeat.py``).

The backbone of XFeat (Potje et al., CVPR'24): an instance-normalised grey
input, BasicLayers (conv + affine-free BatchNorm + ReLU, the BatchNorms
folded into the convolutions at load time, as the JAX package folds them)
with a skip branch, pyramid fusion at 1/8 (bilinear, half-pixel), 64-d dense
features, a 65-channel keypoint-logit head on the 8x8 space-to-depth input
and a reliability heatmap. Detection: the per-cell softmax unfolded to full
resolution, 5x5 local-maximum NMS, the threshold, top-k (ties at the lower
index, as ``jax.lax.top_k``), scores times the heatmap sampled at the
keypoints, re-sorted; descriptors sampled from the 1/8 map with
``grid_sample``'s ``align_corners=False`` convention, written out as the JAX
package computes it (``_sample_map_halfpix``).

``XFeat`` is an ``nn.Module`` of folded convolutions under
``{block}.{i}.weight`` / ``.bias``; ``params_from_torch`` reads an
``XFeatModel`` checkpoint (``net.`` prefix or not) and folds its
BatchNorms.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform import bilinear_sample_zeropad
from ..ops.detect import max_pool_same
from ..utils.device import full_f32

# (kind, in, out, kernel, stride, padding) per layer: "bl" a BasicLayer
# (conv + folded BN + ReLU), "conv" a plain convolution
BLOCKS = {
    "skip1": [("conv", 1, 24, 1, 1, 0)],
    "block1": [("bl", 1, 4, 3, 1, 1), ("bl", 4, 8, 3, 2, 1),
               ("bl", 8, 8, 3, 1, 1), ("bl", 8, 24, 3, 2, 1)],
    "block2": [("bl", 24, 24, 3, 1, 1), ("bl", 24, 24, 3, 1, 1)],
    "block3": [("bl", 24, 64, 3, 2, 1), ("bl", 64, 64, 3, 1, 1), ("bl", 64, 64, 1, 1, 0)],
    "block4": [("bl", 64, 64, 3, 2, 1), ("bl", 64, 64, 3, 1, 1), ("bl", 64, 64, 3, 1, 1)],
    "block5": [("bl", 64, 128, 3, 2, 1), ("bl", 128, 128, 3, 1, 1),
               ("bl", 128, 128, 3, 1, 1), ("bl", 128, 64, 1, 1, 0)],
    "block_fusion": [("bl", 64, 64, 3, 1, 1), ("bl", 64, 64, 3, 1, 1),
                     ("conv", 64, 64, 1, 1, 0)],
    "heatmap_head": [("bl", 64, 64, 1, 1, 0), ("bl", 64, 64, 1, 1, 0),
                     ("conv", 64, 1, 1, 1, 0)],
    "keypoint_head": [("bl", 64, 64, 1, 1, 0), ("bl", 64, 64, 1, 1, 0),
                      ("bl", 64, 64, 1, 1, 0), ("conv", 64, 65, 1, 1, 0)],
}


class XFeat(nn.Module):
    def __init__(self):
        super().__init__()
        for block, layers in BLOCKS.items():
            self.add_module(block, nn.ModuleList(
                [nn.Conv2d(ci, co, k, stride=s, padding=p) for _, ci, co, k, s, p in layers]))

    @torch.no_grad()
    def reset_random(self, generator: torch.Generator) -> "XFeat":
        """He-normal convolutions and zero biases, drawn from ``generator``."""
        for block in BLOCKS:
            for conv in getattr(self, block):
                w = conv.weight
                std = (2.0 / (w.shape[1] * w.shape[2] * w.shape[3])) ** 0.5
                w.copy_(torch.randn(w.shape, generator=generator) * std)
                conv.bias.zero_()
        return self


def params_from_torch(state_dict) -> XFeat:
    """An ``XFeatModel`` state dict (``net.block1.0.layer.0.*`` or
    ``block1.0.layer.0.*``) -> ``XFeat``, each BasicLayer's affine-free
    BatchNorm folded into its convolution in f32 as the JAX package folds it."""
    sd = {(k[4:] if k.startswith("net.") else k): np.asarray(v) for k, v in state_dict.items()}
    model = XFeat()
    for block, layers in BLOCKS.items():
        for i, (kind, *_rest) in enumerate(layers):
            src = 1 if block == "skip1" else i  # Sequential(AvgPool2d, Conv2d)
            if kind == "bl":
                w = sd[f"{block}.{src}.layer.0.weight"]
                b = sd.get(f"{block}.{src}.layer.0.bias")
                mean = sd[f"{block}.{src}.layer.1.running_mean"]
                s = 1.0 / np.sqrt(sd[f"{block}.{src}.layer.1.running_var"] + 1e-5)
                w = w * s[:, None, None, None]
                b = (b - mean) * s if b is not None else -mean * s
            else:
                w = sd[f"{block}.{src}.weight"]
                b = sd.get(f"{block}.{src}.bias")
                if b is None:
                    b = np.zeros(w.shape[0], np.float32)
            conv = getattr(model, block)[i]
            with torch.no_grad():
                conv.weight.copy_(torch.from_numpy(np.asarray(w, np.float32)))
                conv.bias.copy_(torch.from_numpy(np.asarray(b, np.float32)))
    return model.eval()


def _run_block(model: XFeat, x: torch.Tensor, block: str) -> torch.Tensor:
    for conv, (kind, *_rest) in zip(getattr(model, block), BLOCKS[block]):
        x = conv(x)
        if kind == "bl":
            x = F.relu(x)
    return x


def space_to_depth(x: torch.Tensor, ws: int = 8) -> torch.Tensor:
    """(B, 1, H, W) -> (B, ws*ws, H/ws, W/ws), channel = (row offset, column
    offset) row-major (torch ``unfold``'s order)."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // ws, ws, W // ws, ws).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, C * ws * ws, H // ws, W // ws)


@torch.no_grad()
def dense_forward(model: XFeat, images: torch.Tensor):
    """images (B, H, W, 1) uint8 or float, H and W multiples of 32 ->
    (feats (B, H/8, W/8, 64) not normalised, kpt_logits (B, H/8, W/8, 65),
    heatmap (B, H/8, W/8, 1))."""
    x = images.permute(0, 3, 1, 2).float()
    # InstanceNorm2d(1) without affine: the 0-255 or [0, 1] scale drops out
    mu = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mu).square().mean(dim=(2, 3), keepdim=True)
    x = (x - mu) * torch.rsqrt(var + 1e-5)
    x1 = _run_block(model, x, "block1")
    skip = _run_block(model, F.avg_pool2d(x, 4), "skip1")
    x2 = _run_block(model, x1 + skip, "block2")
    x3 = _run_block(model, x2, "block3")
    x4 = _run_block(model, x3, "block4")
    x5 = _run_block(model, x4, "block5")
    size = x3.shape[2:]
    x4u = F.interpolate(x4, size=size, mode="bilinear", align_corners=False)
    x5u = F.interpolate(x5, size=size, mode="bilinear", align_corners=False)
    feats = _run_block(model, x3 + x4u + x5u, "block_fusion")
    heatmap = torch.sigmoid(_run_block(model, feats, "heatmap_head"))
    kpt_logits = _run_block(model, space_to_depth(x), "keypoint_head")
    return (feats.permute(0, 2, 3, 1), kpt_logits.permute(0, 2, 3, 1),
            heatmap.permute(0, 2, 3, 1))


def get_kpts_heatmap(kpt_logits: torch.Tensor, temp: float = 1.0) -> torch.Tensor:
    """(B, Hc, Wc, 65) logits -> per-cell softmax without the dustbin ->
    (B, 8 Hc, 8 Wc) heatmap."""
    scores = torch.softmax(kpt_logits * temp, dim=-1)[..., :64]
    B, Hc, Wc, _ = scores.shape
    heat = scores.reshape(B, Hc, Wc, 8, 8).permute(0, 1, 3, 2, 4)
    return heat.reshape(B, Hc * 8, Wc * 8)


def sample_map_halfpix(fmap: torch.Tensor, coords: torch.Tensor, H: int, W: int):
    """Bilinear sample of a (Hc, Wc, C) map at full-resolution (K, 2) (x, y)
    pixels, ``grid_sample``'s ``align_corners=False`` convention with zero
    padding: x / (W - 1) to [-1, 1], then to map pixels as ((g + 1) Wc - 1) / 2,
    in the JAX package's order of operations."""
    Hc, Wc, _ = fmap.shape
    gx = 2.0 * coords[:, 0] / (W - 1) - 1.0
    gy = 2.0 * coords[:, 1] / (H - 1) - 1.0
    mx = ((gx + 1.0) * Wc - 1.0) / 2.0
    my = ((gy + 1.0) * Hc - 1.0) / 2.0
    return bilinear_sample_zeropad(fmap, torch.stack([mx, my], dim=-1))


@torch.no_grad()
def extract(
    model: XFeat,
    images: torch.Tensor,     # (B, H, W, 1), H and W multiples of 32
    valid_hw: torch.Tensor,   # (B, 2)
    top_k: int = 4096,
    detection_threshold: float = 0.05,
) -> Dict[str, torch.Tensor]:
    """Returns ``keypoints (B, K, 2)``, ``scores (B, K)``, ``descriptors
    (B, K, 64)`` L2-normalised and ``mask (B, K)``, valid rows first in
    descending score order; invalid rows are zero."""
    B, H, W, _ = images.shape
    # full f32: under cuDNN's default TF32 the card shared 0.9990 of the
    # CPU's keypoints at 1024 px
    with full_f32():
        feats, kpt_logits, heatmap = dense_forward(model, images)
    feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True).clamp(min=1e-12)
    k1h = get_kpts_heatmap(kpt_logits)
    dev = k1h.device
    ys = torch.arange(H, device=dev)[None, :, None]
    xs = torch.arange(W, device=dev)[None, None, :]
    vhw = valid_hw.to(dev)
    in_img = (ys < vhw[:, 0, None, None]) & (xs < vhw[:, 1, None, None])
    pos = (k1h == max_pool_same(k1h, 2)) & (k1h > detection_threshold) & in_img
    flat = torch.where(pos, k1h, k1h.new_tensor(-1.0)).reshape(B, H * W)
    vals, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    out = {"keypoints": [], "scores": [], "descriptors": [], "mask": []}
    for b in range(B):
        valid = vals[b] > 0
        kpts = torch.stack([(idx[b] % W).float(), (idx[b] // W).float()], dim=-1)
        hm = sample_map_halfpix(heatmap[b], kpts, H, W)[:, 0]
        scores = torch.where(valid, vals[b] * hm, hm.new_tensor(-1.0))
        order = torch.sort(-scores, stable=True).indices
        kpts, scores, valid = kpts[order], scores[order].clamp(min=0.0), valid[order]
        d = sample_map_halfpix(feats[b], kpts, H, W)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp(min=1e-12)
        out["keypoints"].append(torch.where(valid[:, None], kpts, kpts.new_tensor(0.0)))
        out["scores"].append(torch.where(valid, scores, scores.new_tensor(0.0)))
        out["descriptors"].append(d * valid[:, None])
        out["mask"].append(valid)
    return {k: torch.stack(v) for k, v in out.items()}
