"""LiftFeat detector/descriptor (PyTorch port of
``deep_image_matching_tpu/models/liftfeat.py``).

LiftFeat (Liu et al.): an instance-normalised grey input, a SuperPoint-style
backbone (24/24/64/64/128 channels, max-pools to 1/32), top-down fusion to a
1/8 map, a 65-channel keypoint head, a 64-d descriptor head, and a
depth-normal head (three upsample-and-fuse steps back to full resolution,
3-channel unit normals). The FeatureBooster refines every 1/8 cell: a
residual descriptor MLP plus an MLP over the cell's 8x8 normals (192
values, channel-major), then three attention-free-transformer (AFT) layers
whose key softmax runs over all cells of the image. Detection: the per-cell
softmax unfolded to full resolution, 5x5 local-maximum NMS, the threshold,
top-k (ties at the lower index); a row is valid where its score is > 0;
refined descriptors are read at the keypoints with ``grid_sample``'s
``align_corners=False`` convention and L2-normalised. It reuses XFeat's
``space_to_depth``, ``get_kpts_heatmap`` and ``sample_map_halfpix``.

Parameters are a tree of tensors (convolutions ``{"w": OIHW, "b"}``, every
BatchNorm folded; dense layers ``{"w": (out, in), "b"}``) in the JAX
package's structure; ``params_from_torch`` reads ``LiftFeat.pth`` (``model.``
prefix or not); ``init_tree`` gives the JAX package's seeded random tree in
its layouts (numpy), which ``convert.liftfeat_params_from_jax`` carries over.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.detect import max_pool_same
from .vgg_refiner import conv_nhwc
from .xfeat import get_kpts_heatmap, sample_map_halfpix, space_to_depth

C1, C2, C3, C4, C5 = 24, 24, 64, 64, 128
DESC_DIM = 64
N_AFT_LAYERS = 3
_BACKBONE = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
             "conv4a", "conv4b", "conv5a", "conv5b")


def init_tree() -> Dict:
    """The JAX package's random init recipe (``init_params``), in its
    layouts, as numpy: the same draws from ``default_rng(0)``."""
    rng = np.random.default_rng(0)

    def conv(k, ci, co):
        w = rng.normal(0, np.sqrt(2.0 / (ci * k * k)), (k, k, ci, co)).astype(np.float32)
        return {"w": w, "b": np.zeros((co,), np.float32)}

    def lin(ci, co):
        return {"w": rng.normal(0, 1 / np.sqrt(ci), (ci, co)).astype(np.float32),
                "b": np.zeros((co,), np.float32)}

    kh_dims = [(C3, 32), (32, 32), (32, 64), (64, 64), (64, 128)]
    return {
        "backbone": {
            "conv1a": conv(3, 1, C1), "conv1b": conv(3, C1, C1),
            "conv2a": conv(3, C1, C2), "conv2b": conv(3, C2, C2),
            "conv3a": conv(3, C2, C3), "conv3b": conv(3, C3, C3),
            "conv4a": conv(3, C3, C4), "conv4b": conv(3, C4, C4),
            "conv5a": conv(3, C4, C5), "conv5b": conv(3, C5, C5),
        },
        "upsample5": conv(3, C5, C5 // 2),
        "upsample4": conv(3, C4, C4 // 2),
        "fusion45": conv(3, C5 // 2 + C4, C4),
        "fusion34": conv(3, C4 // 2 + C3, C3),
        "keypoint_head": {"layers": [conv(3, ci, co) for ci, co in kh_dims],
                          "out": conv(3, 128, 65)},
        "descriptor_head": [conv(3, C3, 32), conv(3, 32, 32), conv(3, 32, 64),
                            conv(3, 64, DESC_DIM)],
        "depth_head": {
            "upa": conv(3, C3, 32), "upb": conv(3, 32, 16), "upc": conv(3, 16, 8),
            "da": conv(3, 32 + 64, 32), "db": conv(3, 16 + 32, 16), "dc": conv(3, 8 + 16, 3),
        },
        "booster": {
            "denc": [lin(64, 64), lin(64, 64), lin(64, 64)],
            "nenc": [lin(192, 128), lin(128, 64), lin(64, 64), lin(64, 64)],
            "aft": [{"q": lin(64, 64), "k": lin(64, 64), "v": lin(64, 64),
                     "proj": lin(64, 64), "ffn1": lin(64, 128), "ffn2": lin(128, 64)}
                    for _ in range(N_AFT_LAYERS)],
        },
    }


def params_from_torch(state_dict) -> Dict:
    """A LiftFeat checkpoint -> the port's tree, BatchNorms folded in f32 as
    the JAX package folds them."""
    sd = {(k[6:] if k.startswith("model.") else k): torch.as_tensor(np.asarray(v)).float()
          for k, v in state_dict.items()}

    def conv(key):
        w = sd[f"{key}.weight"]
        return {"w": w, "b": sd.get(f"{key}.bias", torch.zeros(w.shape[0]))}

    def base_layer(prefix):  # conv without bias + affine-free BatchNorm
        s = 1.0 / torch.sqrt(sd[f"{prefix}.layer.1.running_var"] + 1e-5)
        return {"w": sd[f"{prefix}.layer.0.weight"] * s[:, None, None, None],
                "b": -sd[f"{prefix}.layer.1.running_mean"] * s}

    def conv_bn(conv_key, bn_key):
        p = conv(conv_key)
        s = sd[f"{bn_key}.weight"] / torch.sqrt(sd[f"{bn_key}.running_var"] + 1e-5)
        return {"w": p["w"] * s[:, None, None, None],
                "b": (p["b"] - sd[f"{bn_key}.running_mean"]) * s + sd[f"{bn_key}.bias"]}

    def lin(key):
        w = sd[f"{key}.weight"]
        return {"w": w, "b": sd.get(f"{key}.bias", torch.zeros(w.shape[0]))}

    pre = "feature_boost.attn_proj.layers"
    return {
        "backbone": {name: conv(name) for name in _BACKBONE},
        "upsample5": conv_bn("upsample5.conv", "upsample5.bn"),
        "upsample4": conv_bn("upsample4.conv", "upsample4.bn"),
        "fusion45": conv("conv_fusion45"),
        "fusion34": conv("conv_fusion34"),
        "keypoint_head": {
            "layers": [base_layer(f"keypoint_head.layer{i}") for i in range(1, 6)],
            "out": conv_bn("keypoint_head.conv", "keypoint_head.bn"),
        },
        "descriptor_head": [base_layer(f"descriptor_head.layer.{i}") for i in range(4)],
        "depth_head": {
            "upa": conv_bn("depth_head.upsampleDa.conv", "depth_head.upsampleDa.bn"),
            "upb": conv_bn("depth_head.upsampleDb.conv", "depth_head.upsampleDb.bn"),
            "upc": conv_bn("depth_head.upsampleDc.conv", "depth_head.upsampleDc.bn"),
            "da": conv_bn("depth_head.convDepa", "depth_head.bnDepa"),
            "db": conv_bn("depth_head.convDepb", "depth_head.bnDepb"),
            "dc": conv_bn("depth_head.convDepc", "depth_head.bnDepc"),
        },
        "booster": {
            "denc": [lin(f"feature_boost.denc.encoder.{i}") for i in (0, 2, 4)],
            "nenc": [lin(f"feature_boost.nenc.encoder.{i}") for i in range(4)],
            "aft": [{"q": lin(f"{pre}.{i}.attn.query"), "k": lin(f"{pre}.{i}.attn.key"),
                     "v": lin(f"{pre}.{i}.attn.value"), "proj": lin(f"{pre}.{i}.attn.proj"),
                     "ffn1": lin(f"{pre}.{i}.ffn.mlp.0"), "ffn2": lin(f"{pre}.{i}.ffn.mlp.2")}
                    for i in range(N_AFT_LAYERS)],
        },
    }


def _conv(x: torch.Tensor, p: Dict) -> torch.Tensor:
    return conv_nhwc(x, p["w"], p["b"], padding=(p["w"].shape[-1] - 1) // 2)


def _pool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _up2(x: torch.Tensor) -> torch.Tensor:
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def _upsample_layer(x: torch.Tensor, p: Dict) -> torch.Tensor:
    return F.leaky_relu(_conv(_up2(x), p), 0.1)


def _lin(x: torch.Tensor, p: Dict) -> torch.Tensor:
    return x @ p["w"].T + p["b"]


@torch.no_grad()
def dense_forward(params: Dict, images: torch.Tensor):
    """(B, H, W, 1), H and W multiples of 32 -> (desc_map (B, H/8, W/8, 64),
    kpt_logits (B, H/8, W/8, 65), normals (B, H, W, 3))."""
    bb = params["backbone"]
    x = images.float()
    mu = x.mean(dim=(1, 2), keepdim=True)
    var = (x - mu).square().mean(dim=(1, 2), keepdim=True)
    x = (x - mu) * torch.rsqrt(var + 1e-5)

    def stage(x, a, b):
        return _pool2(F.relu(_conv(F.relu(_conv(x, bb[a])), bb[b])))

    x1 = stage(x, "conv1a", "conv1b")
    x2 = stage(x1, "conv2a", "conv2b")
    x3 = stage(x2, "conv3a", "conv3b")
    x4 = stage(x3, "conv4a", "conv4b")
    x5 = stage(x4, "conv5a", "conv5b")
    u5 = _upsample_layer(x5, params["upsample5"])
    f4 = _conv(torch.cat([x4, u5], dim=-1), params["fusion45"])
    u4 = _upsample_layer(f4, params["upsample4"])
    f3 = _conv(torch.cat([x3, u4], dim=-1), params["fusion34"])

    kh = params["keypoint_head"]
    k = f3
    for p in kh["layers"]:
        k = F.relu(_conv(k, p))
    kpt_logits = _conv(k, kh["out"])

    dh = params["descriptor_head"]
    d = F.relu(_conv(f3, dh[0]))
    for p in dh[1:]:
        d = _conv(d, p)

    dp = params["depth_head"]
    h1 = torch.cat([_up2(f3), _upsample_layer(f3, dp["upa"])], dim=-1)
    h1 = F.leaky_relu(_conv(h1, dp["da"]), 0.1)
    h2 = torch.cat([_up2(h1), _upsample_layer(h1, dp["upb"])], dim=-1)
    h2 = F.leaky_relu(_conv(h2, dp["db"]), 0.1)
    h3 = torch.cat([_up2(h2), _upsample_layer(h2, dp["upc"])], dim=-1)
    normals = F.leaky_relu(_conv(h3, dp["dc"]), 0.1)
    normals = normals / torch.linalg.norm(normals, dim=-1, keepdim=True).clamp(min=1e-12)
    return d, kpt_logits, normals


def feature_boost(params: Dict, descs: torch.Tensor, normals192: torch.Tensor) -> torch.Tensor:
    """descs (N, 64), normals192 (N, 192) -> refined (N, 64): the residual
    descriptor MLP plus the normal MLP (linears only), then the AFT layers,
    whose key softmax runs over the N tokens per channel."""
    bp = params["booster"]
    h = F.relu(_lin(descs, bp["denc"][0]))
    h = F.relu(_lin(h, bp["denc"][1]))
    descs = descs + _lin(h, bp["denc"][2])
    n = normals192
    for p in bp["nenc"]:
        n = _lin(n, p)
    x = descs + n
    for lp in bp["aft"]:
        q, k, v = _lin(x, lp["q"]), _lin(x, lp["k"]), _lin(x, lp["v"])
        kv = (torch.softmax(k, dim=0) * v).sum(dim=0, keepdim=True)
        x = x + _lin(q * kv, lp["proj"])
        x = x + _lin(F.relu(_lin(x, lp["ffn1"])), lp["ffn2"])
    return x


@torch.no_grad()
def extract(params: Dict, images: torch.Tensor, valid_hw: torch.Tensor, top_k: int = 4096,
            detection_threshold: float = 0.05) -> Dict[str, torch.Tensor]:
    """images (B, H, W, 1), H and W multiples of 32; valid_hw (B, 2) ->
    ``keypoints (B, K, 2)``, ``scores (B, K)``, ``descriptors (B, K, 64)``
    and ``mask (B, K)``, valid rows first; invalid rows are zero."""
    B, H, W, _ = images.shape
    desc_map, kpt_logits, normals = dense_forward(params, images)
    n192 = space_to_depth(normals.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    Hc, Wc = desc_map.shape[1:3]
    heat = get_kpts_heatmap(kpt_logits)
    dev = heat.device
    ys = torch.arange(H, device=dev)[None, :, None]
    xs = torch.arange(W, device=dev)[None, None, :]
    vhw = valid_hw.to(dev)
    in_img = (ys < vhw[:, 0, None, None]) & (xs < vhw[:, 1, None, None])
    pos = (heat == max_pool_same(heat, 2)) & (heat > detection_threshold) & in_img
    flat = torch.where(pos, heat, heat.new_tensor(-1.0)).reshape(B, H * W)
    vals, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    out = {"keypoints": [], "scores": [], "descriptors": [], "mask": []}
    for b in range(B):
        refined = feature_boost(params, desc_map[b].reshape(Hc * Wc, DESC_DIM),
                                n192[b].reshape(Hc * Wc, -1)).reshape(Hc, Wc, DESC_DIM)
        valid = vals[b] > 0
        kpts = torch.stack([(idx[b] % W).float(), (idx[b] // W).float()], dim=-1)
        d = sample_map_halfpix(refined, kpts, H, W)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp(min=1e-12)
        out["keypoints"].append(torch.where(valid[:, None], kpts, kpts.new_tensor(0.0)))
        out["scores"].append(vals[b].clamp(min=0.0))
        out["descriptors"].append(d * valid[:, None])
        out["mask"].append(valid)
    return {k: torch.stack(v) for k, v in out.items()}
