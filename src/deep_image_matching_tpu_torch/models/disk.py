"""DISK detector/descriptor (PyTorch port of
``deep_image_matching_tpu/models/disk.py``).

The thin U-Net of DISK (kornia's ``DISK``): an encoder of five stages
(channels 16/32/64/64/64; stage 0 a plain 5x5 convolution, stages 1-4 a 2x2
average pool then a pre-activation block ``InstanceNorm(affine=False) ->
PReLU -> Conv5x5``) and a decoder of four (64/64/64/129: bilinear x2
up-sampling with ``align_corners=False``, the skip concatenated after the
up-sampled map, then the same block). The last block gives 128 descriptor
channels and one keypoint-logit channel at full resolution. Detection is
window-5 local-maximum NMS on the logits, a threshold on the raw logit and a
top-n with ties at the lower index (as ``jax.lax.top_k``); descriptors are
read at the integer keypoints and L2-normalised.

``DISK`` is an ``nn.Module`` with ``down.{i}`` / ``up.{i}`` blocks, each a
``conv`` and, where gated, a ``prelu`` over the block's input channels.
``params_from_torch`` reads a checkpoint by position as the JAX converter
does (conv weights in checkpoint order, each block's gate the 1-d
weight of the conv's input width between it and the conv before), so both
gate layouts of encoder stage 0 load; a residue or a wrong channel plan
raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.detect import bilinear_sample, max_pool_same

DOWN = [16, 32, 64, 64, 64]
UP = [64, 64, 64, 129]  # the last: 128 descriptor channels + 1 keypoint logit
DESC_DIM = 128
_EPS = 1e-5  # InstanceNorm2d's default


def _skip_channels() -> List[int]:
    return DOWN[-2::-1]  # [64, 64, 32, 16]


class _Block(nn.Module):
    """``[InstanceNorm -> PReLU ->] Conv5x5``; ``prelu`` is None on a bare
    first block."""

    def __init__(self, cin: int, cout: int, gated: bool):
        super().__init__()
        # the gate first, so a state dict lists it between the convolutions
        # it separates (the position-based converters read it there)
        self.prelu = nn.PReLU(cin) if gated else None
        self.conv = nn.Conv2d(cin, cout, 5, padding=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.prelu is not None:
            mu = x.mean(dim=(2, 3), keepdim=True)
            var = (x - mu).square().mean(dim=(2, 3), keepdim=True)
            x = (x - mu) * torch.rsqrt(var + _EPS)
            x = torch.where(x >= 0, x, x * self.prelu.weight[None, :, None, None])
        return self.conv(x)


class DISK(nn.Module):
    def __init__(self, first_gate: bool = False):
        super().__init__()
        cin, down = 3, []
        for i, co in enumerate(DOWN):
            down.append(_Block(cin, co, gated=i > 0 or first_gate))
            cin = co
        up = []
        for skip, co in zip(_skip_channels(), UP):
            up.append(_Block(cin + skip, co, gated=True))
            cin = co
        self.down = nn.ModuleList(down)
        self.up = nn.ModuleList(up)

    @torch.no_grad()
    def reset_random(self, generator: torch.Generator) -> "DISK":
        """He-normal convolutions, zero biases and 0.25 gates, drawn from
        ``generator``."""
        for blk in list(self.down) + list(self.up):
            w = blk.conv.weight
            std = (2.0 / (w.shape[1] * 25)) ** 0.5
            w.copy_(torch.randn(w.shape, generator=generator) * std)
            blk.conv.bias.zero_()
            if blk.prelu is not None:
                blk.prelu.weight.fill_(0.25)
        return self


def params_from_torch(state_dict) -> DISK:
    """A kornia / original-repository DISK checkpoint -> ``DISK`` (the JAX
    package's converter: one uniform wrapper prefix is stripped, the 9 conv
    weights taken in checkpoint order, each with the 1-d gate of its input
    width found between it and the previous conv; every tensor must be
    consumed and the channel plan must match)."""
    sd = {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
          for k, v in state_dict.items()}
    prefixes = {k.split(".", 1)[0] for k in sd if "." in k}
    if len(prefixes) == 1 and all("." in k for k in sd):
        pre = next(iter(prefixes))
        if not any(sd[k].ndim == 4 for k in sd if k == f"{pre}.weight"):
            stripped = {k.split(".", 1)[1]: v for k, v in sd.items()}
            if len(stripped) == len(sd):
                sd = stripped
    ordered = list(sd)
    conv_keys = [k for k in ordered if k.endswith(".weight") and sd[k].ndim == 4]
    n_need = len(DOWN) + len(UP)
    if len(conv_keys) != n_need:
        raise ValueError(f"DISK checkpoint has {len(conv_keys)} conv layers, expected exactly "
                         f"{n_need} (conv keys: {conv_keys})")
    onedim = [k for k in ordered if k.endswith(".weight") and sd[k].ndim == 1]
    consumed = set()

    def gate_between(lo: int, hi: int, cin: int) -> Optional[np.ndarray]:
        for k in onedim:
            pos = ordered.index(k)
            if lo < pos < hi and sd[k].shape == (cin,) and k not in consumed:
                consumed.add(k)
                return sd[k]
        return None

    blocks = []
    prev_pos = -1
    for k in conv_keys:
        base = k[: -len(".weight")]
        w = sd[k]
        pos = ordered.index(k)
        consumed.add(k)
        if f"{base}.bias" in sd:
            consumed.add(f"{base}.bias")
        blocks.append((w, sd.get(f"{base}.bias", np.zeros(w.shape[0])),
                       gate_between(prev_pos, pos, w.shape[1])))
        prev_pos = pos
    got = [b[0].shape[0] for b in blocks]
    if got != DOWN + UP:
        raise ValueError(f"DISK channel plan mismatch: down={got[:5]} up={got[5:]}")
    residue = [k for k in ordered if k not in consumed and sd[k].size > 0]
    if residue:
        raise ValueError("DISK checkpoint has tensors this converter does not consume — "
                         f"refusing a partial load. Residue: {sorted(residue)}")
    model = DISK(first_gate=blocks[0][2] is not None)
    for blk, (w, b, gate) in zip(list(model.down) + list(model.up), blocks):
        if (gate is None) != (blk.prelu is None):
            raise ValueError("DISK checkpoint: a decoder or deep encoder block lacks its gate")
        with torch.no_grad():
            blk.conv.weight.copy_(torch.from_numpy(np.asarray(w, np.float32)))
            blk.conv.bias.copy_(torch.from_numpy(np.asarray(b, np.float32)))
            if gate is not None:
                blk.prelu.weight.copy_(torch.from_numpy(np.asarray(gate, np.float32)))
    return model.eval()


@torch.no_grad()
def dense_forward(model: DISK, images: torch.Tensor):
    """(B, H, W, 3), H and W multiples of 16 -> (desc (B, H, W, 128),
    heat (B, H, W))."""
    x = images.permute(0, 3, 1, 2).float()
    skips = []
    for i, blk in enumerate(model.down):
        if i > 0:
            x = F.avg_pool2d(x, 2)
        x = blk(x)
        skips.append(x)
    for i, blk in enumerate(model.up):
        skip = skips[len(DOWN) - 2 - i]
        x = F.interpolate(x, size=skip.shape[2:], mode="bilinear", align_corners=False)
        x = blk(torch.cat([x, skip], dim=1))  # the up-sampled map first
    x = x.permute(0, 2, 3, 1)
    return x[..., :DESC_DIM], x[..., DESC_DIM]


@torch.no_grad()
def extract(
    model: DISK,
    images: torch.Tensor,      # (B, H, W, 3) float
    valid_hw: torch.Tensor,    # (B, 2) unpadded (h, w)
    max_keypoints: int = 4096,
    nms_window_size: int = 5,
    detection_threshold: float = 0.0,
) -> Dict[str, torch.Tensor]:
    """Returns ``keypoints (B, K, 2)`` (x, y), ``scores (B, K)`` (the raw
    logits), ``descriptors (B, K, 128)`` L2-normalised, ``mask (B, K)``;
    invalid rows are zero."""
    desc_map, heat = dense_forward(model, images)
    ninf = heat.new_tensor(-float("inf"))
    nms = torch.where(heat == max_pool_same(heat, nms_window_size // 2), heat, ninf)
    nms = torch.where(nms > detection_threshold, nms, ninf)
    B, H, W = heat.shape
    ys = torch.arange(H, device=heat.device)[None, :, None]
    xs = torch.arange(W, device=heat.device)[None, None, :]
    vhw = valid_hw.to(heat.device)
    in_img = (ys < vhw[:, 0, None, None]) & (xs < vhw[:, 1, None, None])
    masked = torch.where(in_img, nms, ninf).reshape(B, H * W)
    # a stable descending sort: ties keep the lower index first (jax.lax.top_k)
    vals, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :max_keypoints], idx[:, :max_keypoints]
    valid = torch.isfinite(vals)
    kpts = torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)
    kpts = torch.where(valid[..., None], kpts, kpts.new_tensor(0.0))
    scores = torch.where(valid, vals, vals.new_tensor(0.0))
    d = bilinear_sample(desc_map, kpts)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp(min=1e-12)
    return {"keypoints": kpts, "scores": scores, "descriptors": d * valid[..., None],
            "mask": valid}
