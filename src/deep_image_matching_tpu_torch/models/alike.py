"""ALIKE (PyTorch port of ``deep_image_matching_tpu/models/alike.py``).

The upstream ALNet (``thirdparty/alike/alnet.py``): a ReLU / max-pool
backbone of a ConvBlock and three ResBlocks, the multi-scale aggregation
with align-corners upsampling, and a 1x1 head giving ``dim`` descriptor
channels and one score channel (``alike-l`` puts a 1x1 + ReLU layer before
it: ``single_head: False``); detection is the shared DKD with sub-pixel
refinement (``models/aliked.dkd_detect``), descriptors are sampled
bilinearly (``ops/detect.bilinear_sample``) and L2-normalised.

Parameters are the folded form the JAX package holds (BatchNorms folded in
numpy f32 at load, ``params_from_torch``), convolution weights (out, in,
kh, kw); images (B, H, W, 3) NHWC at the public functions, as in the JAX
package. The network runs in full f32 (``utils/device.full_f32``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.deform import upsample_bilinear_align
from ..ops.detect import bilinear_sample
from ..utils.device import full_f32
from .aliked import dkd_detect

Params = Dict

CONFIGS = {
    "alike-t": {"c1": 8, "c2": 16, "c3": 32, "c4": 64, "dim": 64, "single_head": True},
    "alike-s": {"c1": 8, "c2": 16, "c3": 48, "c4": 96, "dim": 96, "single_head": True},
    "alike-n": {"c1": 16, "c2": 32, "c3": 64, "c4": 128, "dim": 128, "single_head": True},
    "alike-l": {"c1": 32, "c2": 64, "c3": 128, "c4": 128, "dim": 128, "single_head": False},
}

_BN_EPS = 1e-5


def params_from_torch(state_dict, model_name: str = "alike-n") -> Params:
    """An upstream ALIKE state dict in the port's folded form; the folds run
    in numpy f32, the JAX package's arithmetic."""
    sd = {k: np.asarray(v, np.float32) for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    def folded(conv, bn):
        s = sd[f"{bn}.weight"] / np.sqrt(sd[f"{bn}.running_var"] + _BN_EPS)
        mean, beta = sd[f"{bn}.running_mean"], sd[f"{bn}.bias"]
        b = (sd[f"{conv}.bias"] - mean) * s + beta if f"{conv}.bias" in sd else -mean * s + beta
        return {"w": t(sd[f"{conv}.weight"] * s[:, None, None, None]), "b": t(b)}

    def plain(conv, bias=True):
        out = {"w": t(sd[f"{conv}.weight"])}
        if bias and f"{conv}.bias" in sd:
            out["b"] = t(sd[f"{conv}.bias"])
        return out

    params: Params = {"block1": {"conv1": folded("block1.conv1", "block1.bn1"),
                                 "conv2": folded("block1.conv2", "block1.bn2")}}
    for b in (2, 3, 4):
        params[f"block{b}"] = {"conv1": folded(f"block{b}.conv1", f"block{b}.bn1"),
                               "conv2": folded(f"block{b}.conv2", f"block{b}.bn2"),
                               "down": plain(f"block{b}.downsample")}
    params["agg"] = {f"conv{i}": plain(f"conv{i}", bias=False) for i in range(1, 5)}
    if "convhead1.weight" in sd:
        params["head1"] = plain("convhead1", bias=False)
    params["head2"] = plain("convhead2", bias=False)
    return params


def _conv(x: torch.Tensor, p) -> torch.Tensor:
    w = p["w"]
    return F.conv2d(x, w, p.get("b"), padding=(w.shape[-1] - 1) // 2)


def _res(x: torch.Tensor, p) -> torch.Tensor:
    out = _conv(F.relu(_conv(x, p["conv1"])), p["conv2"])
    return F.relu(out + _conv(x, p["down"]))


@torch.no_grad()
def dense_forward(params: Params, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """images (B, H, W, 3) in [0, 1] (or uint8), H and W multiples of 32 ->
    (descriptor map (B, H, W, dim) L2-normalised, score map (B, H, W))."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    x = images.permute(0, 3, 1, 2)
    x1 = F.relu(_conv(F.relu(_conv(x, params["block1"]["conv1"])), params["block1"]["conv2"]))
    x2 = _res(F.max_pool2d(x1, 2), params["block2"])
    x3 = _res(F.max_pool2d(x2, 4), params["block3"])
    x4 = _res(F.max_pool2d(x3, 4), params["block4"])
    agg = params["agg"]
    xa = [F.relu(_conv(t, agg[f"conv{i}"])).permute(0, 2, 3, 1)
          for i, t in enumerate((x1, x2, x3, x4), 1)]
    x1234 = torch.cat([xa[0]] + [upsample_bilinear_align(t, f)
                                 for t, f in zip(xa[1:], (2, 8, 32))], dim=-1)
    x1234 = x1234.permute(0, 3, 1, 2)
    if "head1" in params:
        x1234 = F.relu(_conv(x1234, params["head1"]))
    x = _conv(x1234, params["head2"]).permute(0, 2, 3, 1)
    desc_map, score_map = x[..., :-1], torch.sigmoid(x[..., -1])
    desc_map = desc_map / torch.linalg.norm(desc_map, dim=-1, keepdim=True).clamp(min=1e-12)
    return desc_map, score_map


@torch.no_grad()
def extract(params: Params, images: torch.Tensor, valid_hw: torch.Tensor,
            max_keypoints: int = 4000, scores_th: float = 0.2, nms_radius: int = 2
            ) -> Dict[str, torch.Tensor]:
    """Batched ALIKE extraction of images (B, H, W, 3), H and W multiples of
    32, with the unpadded (h, w) per image. Keypoints are in pixels of the
    padded input; ``descriptors`` are zero on invalid rows."""
    with full_f32():
        desc_map, score_map = dense_forward(params, images)
    kpts, scores, _, valid = dkd_detect(score_map, valid_hw, max_keypoints, scores_th,
                                        nms_radius)
    d = bilinear_sample(desc_map, kpts)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp(min=1e-12)
    return {"keypoints": kpts, "scores": scores, "descriptors": d * valid[..., None],
            "mask": valid}
