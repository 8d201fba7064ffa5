"""KeyNet learned keypoint response (PyTorch port of
``deep_image_matching_tpu/models/keynet.py``).

kornia's ``KeyNet``: a handcrafted 10-channel derivative block (normalised
Sobel gradients with replicate padding: dx, dy, dx^2, dy^2, dx dy, dxy,
dxy^2, dxx, dyy, dxx dyy) and three learned 5x5 conv + BN + ReLU blocks
(BatchNorm folded at load time) over an internal 3-level pyramid (a 5x5
binomial blur with reflect padding, then a bilinear shrink by 1.2); each
level's features go back to full resolution, are concatenated and reduced to
one score map by a last 5x5 convolution and a ReLU.
``keynet_multiscale_detect`` evaluates the response over 4 image scales
(1.3 apart), takes NMS + top-k per level, maps the coordinates back and
keeps one top-k over all levels.

Resizes follow ``jax.image.resize(..., "bilinear")``: half-pixel sampling
with the triangle kernel, widened by the shrink factor where the JAX
package antialiases (``models/retrieval.py::resize_linear``), so both
packages sample the same pixels with the same weights.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .retrieval import resize_linear

NUM_FILTERS = 8
NUM_LEVELS = 3
KERNEL_SIZE = 5
FACTOR_SCALING = 1.2

_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32) / 8.0
_PYR_KERNEL = (np.outer(np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32),
                        np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32)) / 256.0)


class KeyNet(nn.Module):
    """The learned part: ``blocks.{0,1,2}`` (10 -> 8 -> 8 -> 8) and
    ``last`` (24 -> 1), BatchNorms folded."""

    def __init__(self):
        super().__init__()
        self.blocks = nn.ModuleList([
            nn.Conv2d(10, NUM_FILTERS, 5, padding=2),
            nn.Conv2d(NUM_FILTERS, NUM_FILTERS, 5, padding=2),
            nn.Conv2d(NUM_FILTERS, NUM_FILTERS, 5, padding=2)])
        self.last = nn.Conv2d(NUM_FILTERS * NUM_LEVELS, 1, 5, padding=2)

    @torch.no_grad()
    def reset_random(self, generator: torch.Generator) -> "KeyNet":
        for conv in list(self.blocks) + [self.last]:
            std = (2.0 / (conv.weight.shape[1] * 25)) ** 0.5
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=generator) * std)
            conv.bias.zero_()
        return self


def keynet_params_from_torch(state_dict) -> KeyNet:
    """A KeyNet checkpoint (kornia's or the official naming) -> ``KeyNet``:
    the 5x5 convolutions found by shape in sorted key order, each with the
    BatchNorm at its Sequential index + 1 folded in where present (the JAX
    package's converter)."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    conv_keys = [k for k, v in sd.items()
                 if k.endswith(".weight") and v.ndim == 4 and v.shape[2:] == (5, 5)]

    def pick(shape):
        for k in sorted(conv_keys):
            if sd[k].shape == shape:
                conv_keys.remove(k)
                return k
        raise KeyError(f"no conv of shape {shape} in checkpoint")

    def fold(conv_key, conv: nn.Conv2d):
        w = sd[conv_key].astype(np.float32)
        base = conv_key[: -len(".weight")]
        b = sd.get(f"{base}.bias", np.zeros(w.shape[0], np.float32))
        parts = base.split(".")
        if parts[-1].isdigit():
            bn = ".".join(parts[:-1] + [str(int(parts[-1]) + 1)])
            if f"{bn}.running_mean" in sd:
                mean = sd[f"{bn}.running_mean"]
                gamma = sd.get(f"{bn}.weight", np.ones_like(mean))
                beta = sd.get(f"{bn}.bias", np.zeros_like(mean))
                s = gamma / np.sqrt(sd[f"{bn}.running_var"] + 1e-5)
                w = w * s[:, None, None, None]
                b = (b - mean) * s + beta
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(np.asarray(w, np.float32)))
            conv.bias.copy_(torch.from_numpy(np.asarray(b, np.float32)))

    model = KeyNet()
    fold(pick((NUM_FILTERS, 10, 5, 5)), model.blocks[0])
    for i in (1, 2):
        fold(pick((NUM_FILTERS, NUM_FILTERS, 5, 5)), model.blocks[i])
    fold(pick((1, NUM_FILTERS * NUM_LEVELS, 5, 5)), model.last)
    return model.eval()


def _depthwise(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """The same 2-D kernel over each channel of (B, C, H, W), no padding."""
    C = x.shape[1]
    w = torch.from_numpy(np.ascontiguousarray(k)).to(x)[None, None].expand(C, 1, *k.shape)
    return F.conv2d(x, w, groups=C)


def spatial_gradient(x: torch.Tensor):
    """(B, C, H, W) -> (dx, dy): normalised Sobel, replicate padding."""
    xp = F.pad(x, (1, 1, 1, 1), mode="replicate")
    return _depthwise(xp, _SOBEL_X), _depthwise(xp, _SOBEL_X.T)


def handcrafted_block(x: torch.Tensor) -> torch.Tensor:
    """(B, 1, H, W) -> (B, 10, H, W) in kornia's channel order."""
    dx, dy = spatial_gradient(x)
    dxx, dxy = spatial_gradient(dx)
    _, dyy = spatial_gradient(dy)
    return torch.cat([dx, dy, dx ** 2, dy ** 2, dx * dy, dxy, dxy ** 2, dxx, dyy, dxx * dyy], 1)


def _pyrdown(x: torch.Tensor, factor: float) -> torch.Tensor:
    """kornia's ``custom_pyrdown``: the 5x5 binomial blur (reflect padding),
    then a bilinear shrink by ``factor`` without antialiasing."""
    H, W = x.shape[2:]
    blurred = _depthwise(F.pad(x, (2, 2, 2, 2), mode="reflect"), _PYR_KERNEL)
    return resize_linear(blurred, int(float(H) / factor), int(float(W) / factor), False)


@torch.no_grad()
def keynet_response(model: KeyNet, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W) grey in [0, 1] -> (B, H, W) keypoint score map."""
    x = images[:, None].float()
    H, W = x.shape[2:]
    feats = []
    cur = x
    for lvl in range(NUM_LEVELS):
        if lvl > 0:
            cur = _pyrdown(cur, FACTOR_SCALING)
        f = handcrafted_block(cur)
        for conv in model.blocks:
            f = F.relu(conv(f))
        if lvl > 0:
            f = resize_linear(f, H, W, False)
        feats.append(f)
    return F.relu(model.last(torch.cat(feats, 1)))[:, 0]


@torch.no_grad()
def keynet_multiscale_detect(
    model: KeyNet,
    images: torch.Tensor,     # (B, H, W) grey in [0, 1]
    valid_hw: torch.Tensor,   # (B, 2)
    max_keypoints: int,
    n_levels: int = 4,
    scale_factor: float = 1.3,
    init_sigma: float = 1.6,
    nms_radius: int = 3,
    border: int = 16,
):
    """Multi-scale detection with the learned response: per level the image
    shrunk by ``scale_factor ** lvl`` (to at least 16 px), the response, NMS
    and a top-k at the level's resolution inside the border, coordinates
    scaled back by the level's true per-axis ratios; one top-k over all
    levels. Returns (kpts (B, K, 2), scores, sigmas, valid), invalid rows 0
    (sigma ``init_sigma``)."""
    from ..ops.detect import simple_nms

    B, H, W = images.shape
    dev = images.device
    vhw = valid_hw.to(dev).float()
    all_vals, all_xy, all_sig = [], [], []
    x = images[:, None].float()
    for lvl in range(n_levels):
        s = float(scale_factor) ** lvl
        h, w = max(int(H / s), 16), max(int(W / s), 16)
        sy, sx = H / h, W / w
        xi = x if lvl == 0 else resize_linear(x, h, w, True)
        nms = simple_nms(keynet_response(model, xi[:, 0]), nms_radius)
        ys = torch.arange(h, device=dev)[None, :, None]
        xs = torch.arange(w, device=dev)[None, None, :]
        bh = vhw[:, 0, None, None] / sy
        bw = vhw[:, 1, None, None] / sx
        bb = max(1, int(border / max(sy, sx)))
        ok = (ys >= bb) & (ys < bh - bb) & (xs >= bb) & (xs < bw - bb)
        nms = torch.where(ok, nms, nms.new_tensor(-1.0))
        k_here = min(max_keypoints, h * w)
        vals, idx = torch.sort(nms.reshape(B, h * w), dim=1, descending=True, stable=True)
        vals, idx = vals[:, :k_here], idx[:, :k_here]
        yy = (idx // w).float() * sy
        xx = (idx % w).float() * sx
        pad = max_keypoints - k_here
        if pad:
            vals = F.pad(vals, (0, pad), value=-1.0)
            xx, yy = F.pad(xx, (0, pad)), F.pad(yy, (0, pad))
        all_vals.append(vals)
        all_xy.append(torch.stack([xx, yy], -1))
        all_sig.append(torch.full_like(vals, init_sigma * s))
    vals = torch.cat(all_vals, 1)
    xy = torch.cat(all_xy, 1)
    sig = torch.cat(all_sig, 1)
    top, idx = torch.sort(vals, dim=1, descending=True, stable=True)
    top, idx = top[:, :max_keypoints], idx[:, :max_keypoints]
    valid = top > 0
    kpts = torch.gather(xy, 1, idx[..., None].expand(-1, -1, 2))
    return (torch.where(valid[..., None], kpts, kpts.new_tensor(0.0)),
            torch.where(valid, top, top.new_tensor(0.0)),
            torch.where(valid, torch.gather(sig, 1, idx), sig.new_tensor(init_sigma)),
            valid)
