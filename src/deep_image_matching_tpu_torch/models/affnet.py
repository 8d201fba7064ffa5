"""AffNet (affine shape) and OriNet (orientation) on 32x32 patches (PyTorch
port of ``deep_image_matching_tpu/models/affnet.py``).

The AffNetFast / OriNetFast nets of the AffNet release (Mishkin et al.,
ECCV'18): a per-patch mean / unbiased-std input norm, six 3x3 conv +
affine-free BN + ReLU layers (two with stride 2; the BNs folded at load
time), an 8x8 head convolution (OriNet: 2 outputs, padding 1; AffNet: 3,
padding 0), tanh and a global average. AffNet's three residuals form a 2x2
affine rectified to the det-1 lower-triangular ellipse; OriNet's two
components are read as an angle (atan2).

``PatchNet`` holds the folded convolutions under ``layers.{i}``;
``affnet_params_from_torch`` / ``orinet_params_from_torch`` read the
released ``features.N.*`` checkpoints.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# (cin, cout, kernel, stride, pad): the shared trunk, then each net's head
TRUNK = [(1, 16, 3, 1, 1), (16, 16, 3, 1, 1), (16, 32, 3, 2, 1), (32, 32, 3, 1, 1),
         (32, 64, 3, 2, 1), (64, 64, 3, 1, 1)]
ORINET_HEAD = (64, 2, 8, 1, 1)
AFFNET_HEAD = (64, 3, 8, 1, 0)


class PatchNet(nn.Module):
    """The trunk and one head, each a folded convolution."""

    def __init__(self, head):
        super().__init__()
        self.specs = TRUNK + [head]
        self.layers = nn.ModuleList(
            [nn.Conv2d(ci, co, k, stride=s, padding=p) for ci, co, k, s, p in self.specs])

    @torch.no_grad()
    def reset_random(self, generator: torch.Generator) -> "PatchNet":
        for conv in self.layers:
            w = conv.weight
            std = (2.0 / (w.shape[1] * w.shape[2] * w.shape[3])) ** 0.5
            w.copy_(torch.randn(w.shape, generator=generator) * std)
            conv.bias.zero_()
        return self


def fold_features(model: nn.Module, sd: dict, conv_idx) -> nn.Module:
    """Load ``features.{i}`` convolutions (bias optional), each with the
    affine-free BatchNorm at ``features.{i + 1}`` folded in (in f32 numpy, as
    the JAX package folds), into ``model.layers`` in order; a last index
    without a BatchNorm loads as it is."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    for conv, i in zip(model.layers, conv_idx):
        w = sd[f"features.{i}.weight"]
        b = sd.get(f"features.{i}.bias", np.zeros(w.shape[0]))
        if f"features.{i + 1}.running_mean" in sd:
            mean = sd[f"features.{i + 1}.running_mean"]
            s = 1.0 / np.sqrt(sd[f"features.{i + 1}.running_var"] + 1e-5)
            w = w * s[:, None, None, None]
            b = (b - mean) * s
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(np.asarray(w, np.float32)))
            conv.bias.copy_(torch.from_numpy(np.asarray(b, np.float32)))
    return model.eval()


def orinet_params_from_torch(state_dict) -> PatchNet:
    return fold_features(PatchNet(ORINET_HEAD), state_dict, (0, 3, 6, 9, 12, 15, 19))


def affnet_params_from_torch(state_dict) -> PatchNet:
    return fold_features(PatchNet(AFFNET_HEAD), state_dict, (0, 3, 6, 9, 12, 15, 19))


def _features(model: PatchNet, patches: torch.Tensor) -> torch.Tensor:
    """(K, 32, 32) -> (K, head outputs): input norm (unbiased std), trunk,
    tanh head, global average."""
    x = patches[:, None].float()
    flat = x.reshape(x.shape[0], -1)
    mu = flat.mean(1)
    sd = torch.sqrt(((flat - mu[:, None]) ** 2).sum(1) / (flat.shape[1] - 1))
    x = (x - mu[:, None, None, None]) / (sd[:, None, None, None] + 1e-7)
    n = len(model.layers)
    for i, conv in enumerate(model.layers):
        x = conv(x)
        if i < n - 1:
            x = F.relu(x)
    return torch.tanh(x).mean(dim=(2, 3))


@torch.no_grad()
def orinet_angles(model: PatchNet, patches: torch.Tensor) -> torch.Tensor:
    """(K, 32, 32) -> (K,) angles in radians."""
    xy = _features(model, patches)
    return torch.atan2(xy[:, 0] + 1e-8, xy[:, 1] + 1e-8)


def rectify_upright(A: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """(K, 2, 2) affines -> the det-1 lower-triangular form of the same
    ellipse A A^T (up to scale)."""
    a, b, c, d = A[:, 0, 0], A[:, 0, 1], A[:, 1, 0], A[:, 1, 1]
    det = torch.sqrt((a * d - b * c).abs() + eps)
    b2a2 = torch.sqrt(a * a + b * b) + eps
    r00 = b2a2 / det
    r10 = (d * b + c * a) / (b2a2 * det)
    r11 = det / b2a2
    zero = torch.zeros_like(r00)
    return torch.stack([torch.stack([r00, zero], -1), torch.stack([r10, r11], -1)], -2)


@torch.no_grad()
def affnet_shapes(model: PatchNet, patches: torch.Tensor) -> torch.Tensor:
    """(K, 32, 32) -> (K, 2, 2) det-1 upright affine shapes."""
    xy = _features(model, patches)
    one, zero = torch.ones_like(xy[:, 0]), torch.zeros_like(xy[:, 0])
    A = torch.stack([torch.stack([one + xy[:, 0], zero], -1),
                     torch.stack([xy[:, 1], one + xy[:, 2]], -1)], -2)
    return rectify_upright(A)
