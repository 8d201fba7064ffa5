"""Global image descriptors for retrieval-based pair selection (port of
``deep_image_matching_tpu/models/retrieval.py``).

Modules on NCHW images, on the device they are moved to:

- ``VGG16NetVLAD``: VGG16 through conv5_3 (no ReLU after the last
  convolution; torchvision's ``features.{i}`` indices) and the ``NetVLAD``
  layer (soft assignment with an optional bias, residual sums,
  intra-normalisation, global L2, optional PCA whitening). NetVLAD and
  OpenIBL.
- ``ResNetGeM``: a ResNet with BatchNorm folded into its convolutions, then
  GeM pooling and an optional projection. CosPlace (ResNet-18, basic blocks)
  and DIR (ResNet-101, bottleneck blocks).
- ``tiny_descriptor``: the weight-free thumbnail descriptor. Its shrinking
  resizes apply the triangle weights of ``jax.image.resize(..., "linear")``,
  which antialiases (``resize_weights``).

The convolutions stay ``F.conv2d`` and the products ``torch.matmul``: the
JAX package has no Pallas kernel here. Checkpoints in the upstream torch
layouts are read by ``openibl_state_from_torch`` and
``resnet_state_from_torch``; the BatchNorm folds run in numpy f32, the JAX
package's arithmetic, so both packages hold the same bits.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# VGG16 through conv5_3 (NetVLAD's cropped backbone)
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
VGG16_WIDTHS = tuple(c for c in VGG16_CFG if c != "M")
# (blocks, output width, first block's stride) per stage
R18_STAGES = ((2, 64, 1), (2, 128, 2), (2, 256, 2), (2, 512, 2))
R101_STAGES = ((3, 256, 1), (4, 512, 2), (23, 1024, 2), (3, 2048, 2))

_BN_EPS = 1e-5


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def vgg16_conv_indices() -> list:
    """torchvision ``features.{i}`` index of each VGG16 convolution."""
    out, idx = [], 0
    for c in VGG16_CFG:
        if c == "M":
            idx += 1
        else:
            out.append(idx)
            idx += 2  # conv + relu
    return out


class NetVLAD(nn.Module):
    """Soft-assigned residual aggregation (Arandjelovic et al.) in the
    OpenIBL layout: ``conv`` (K, D, 1, 1) soft assignment, ``centroids``
    (K, D); ``pca`` (K * D -> out) whitening where given."""

    def __init__(self, dim: int, clusters: int = 64, assign_bias: bool = False,
                 pca_dim: Optional[int] = None):
        super().__init__()
        self.conv = nn.Conv2d(dim, clusters, 1, bias=assign_bias)
        self.centroids = nn.Parameter(torch.zeros(clusters, dim))
        self.pca = nn.Linear(clusters * dim, pca_dim) if pca_dim else None

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, D, H, W) -> (B, K * D) or (B, pca_dim), L2-normalised; the
        flattened (K, D) keeps the JAX package's cluster-major order."""
        B, D = feats.shape[:2]
        K = self.centroids.shape[0]
        x = _l2n(feats.flatten(2).transpose(1, 2))  # (B, N, D)
        logits = torch.matmul(x, self.conv.weight.view(K, D).t())
        if self.conv.bias is not None:
            logits = logits + self.conv.bias
        soft = torch.softmax(logits, dim=-1)  # (B, N, K)
        agg = torch.matmul(soft.transpose(1, 2), x)  # (B, K, D)
        vlad = agg - soft.sum(dim=1)[..., None] * self.centroids[None]
        v = _l2n(_l2n(vlad).reshape(B, K * D))
        if self.pca is not None:
            v = _l2n(self.pca(v))
        return v


class VGG16NetVLAD(nn.Module):
    """(B, 3, H, W) RGB in [0, 1] -> NetVLAD descriptor of VGG16's conv5_3
    (pre-ReLU; max pools floor odd sizes, as VALID pooling does)."""

    def __init__(self, widths: Sequence[int] = VGG16_WIDTHS, clusters: int = 64,
                 assign_bias: bool = False, pca_dim: Optional[int] = None):
        super().__init__()
        layers, cin, ci = [], 3, 0
        for c in VGG16_CFG:
            if c == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            layers += [nn.Conv2d(cin, widths[ci], 3, padding=1), nn.ReLU()]
            cin, ci = widths[ci], ci + 1
        self.features = nn.Sequential(*layers[:-1])  # no ReLU after conv5_3
        self.net_vlad = NetVLAD(cin, clusters, assign_bias, pca_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.net_vlad(self.features(images))

    @classmethod
    def from_state_dict(cls, sd: Dict[str, torch.Tensor]) -> "VGG16NetVLAD":
        """The module whose shapes the state dict gives, loaded strictly."""
        widths = [sd[f"features.{i}.weight"].shape[0] for i in vgg16_conv_indices()]
        pca = sd.get("net_vlad.pca.weight")
        model = cls(widths, sd["net_vlad.centroids"].shape[0],
                    "net_vlad.conv.bias" in sd, None if pca is None else pca.shape[0])
        model.load_state_dict(sd)
        return model.eval()


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, (k - 1) // 2)


class _Block(nn.Module):
    """A residual block with folded BatchNorm: basic (3x3, 3x3; stride on
    the first) or bottleneck (1x1, 3x3 with the stride, 1x1)."""

    def __init__(self, cin: int, cout: int, stride: int, bottleneck: bool):
        super().__init__()
        self.bottleneck = bottleneck
        if bottleneck:
            mid = cout // 4
            self.conv1, self.conv2 = _conv(cin, mid, 1), _conv(mid, mid, 3, stride)
            self.conv3 = _conv(mid, cout, 1)
        else:
            self.conv1, self.conv2 = _conv(cin, cout, 3, stride), _conv(cout, cout, 3)
        self.downsample = _conv(cin, cout, 1, stride) if stride != 1 or cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bottleneck:
            out = self.conv3(F.relu(self.conv2(F.relu(self.conv1(x)))))
        else:
            out = self.conv2(F.relu(self.conv1(x)))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class ResNetGeM(nn.Module):
    """(B, 3, H, W) ImageNet-normalised -> L2-normalised GeM descriptor of a
    folded-BN ResNet (stem 7x7 / 2, max pool 3x3 / 2), through ``proj`` and
    L2 again where given."""

    def __init__(self, stages: Sequence[Tuple[int, int, int]] = R18_STAGES,
                 bottleneck: bool = False, stem: int = 64, proj_dim: Optional[int] = None,
                 gem_p: float = 3.0):
        super().__init__()
        self.stem = _conv(3, stem, 7, 2)
        cin = stem
        self.layers = nn.ModuleList()
        for n_blocks, cout, stride in stages:
            blocks = []
            for bi in range(n_blocks):
                blocks.append(_Block(cin, cout, stride if bi == 0 else 1, bottleneck))
                cin = cout
            self.layers.append(nn.Sequential(*blocks))
        self.proj = nn.Linear(cin, proj_dim) if proj_dim else None
        self.register_buffer("gem_p", torch.tensor(float(gem_p)))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(F.relu(self.stem(images)), 3, 2, 1)
        for layer in self.layers:
            x = layer(x)
        v = gem_pool(x, float(self.gem_p))
        return v if self.proj is None else _l2n(self.proj(v))

    @classmethod
    def from_state_dict(cls, sd: Dict[str, torch.Tensor],
                        strides: Sequence[int], bottleneck: bool) -> "ResNetGeM":
        last = "conv3" if bottleneck else "conv2"
        stages = [(1 + max(int(k.split(".")[2]) for k in sd if k.startswith(f"layers.{si}.")),
                   sd[f"layers.{si}.0.{last}.weight"].shape[0], stride)
                  for si, stride in enumerate(strides)]
        proj = sd.get("proj.weight")
        model = cls(stages, bottleneck, sd["stem.weight"].shape[0],
                    None if proj is None else proj.shape[0], float(sd["gem_p"]))
        model.load_state_dict(sd)
        return model.eval()


def gem_pool(feats: torch.Tensor, p: float = 3.0) -> torch.Tensor:
    """Generalised-mean pooling (B, C, H, W) -> (B, C), L2-normalised."""
    v = (feats.clamp(min=1e-6) ** p).mean(dim=(2, 3)) ** (1.0 / p)
    return _l2n(v)


def resize_weights(in_size: int, out_size: int, antialias: bool = True) -> np.ndarray:
    """(in, out) f32 weights of ``jax.image.resize(..., "linear")`` along one
    axis: samples at (i + 0.5) in / out - 0.5, a triangle kernel (widened by
    the shrink factor where ``antialias``, as by default in JAX), normalised
    per output sample."""
    scale = out_size / in_size
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = np.maximum(inv_scale, np.float32(1.0)) if antialias else np.float32(1.0)
    sample = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale \
        - np.float32(0.0) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def resize_linear(images: torch.Tensor, h: int, w: int, antialias: bool = True) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, h, w) with ``resize_weights`` on both axes."""
    wh = torch.from_numpy(resize_weights(images.shape[2], h, antialias)).to(images.device)
    ww = torch.from_numpy(resize_weights(images.shape[3], w, antialias)).to(images.device)
    return torch.matmul(wh.t(), torch.matmul(images, ww))


def tiny_descriptor(images: torch.Tensor) -> torch.Tensor:
    """Weight-free global descriptor of (B, 3, H, W) images in [0, 1]: the
    16x16 contrast-normalised grey thumbnail and the 4x4 colour means, in the
    JAX package's (h, w, c) order, L2-normalised."""
    B = images.shape[0]
    thumb = resize_linear(images.mean(dim=1, keepdim=True), 16, 16).reshape(B, -1)
    mu = thumb.mean(dim=1, keepdim=True)
    sd = thumb.std(dim=1, keepdim=True, unbiased=False) + 1e-6
    color = resize_linear(images, 4, 4).permute(0, 2, 3, 1).reshape(B, -1)
    return _l2n(torch.cat([(thumb - mu) / sd, color], dim=1))


# ---------------------------------------------------------------------------
# upstream torch checkpoints -> the modules' state dicts
# ---------------------------------------------------------------------------

def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def openibl_state_from_torch(state_dict) -> Dict[str, torch.Tensor]:
    """OpenIBL ``vgg16_netvlad`` (``base_model.{i}.*`` VGG16 features,
    ``net_vlad.centroids`` (K, D), ``net_vlad.conv.*``) -> VGG16NetVLAD's."""
    sd = {k: np.asarray(v, np.float32) for k, v in state_dict.items()}
    out = {}
    for i in vgg16_conv_indices():
        for p in ("weight", "bias"):
            out[f"features.{i}.{p}"] = _t(sd[f"base_model.{i}.{p}"])
    for k in ("net_vlad.centroids", "net_vlad.conv.weight", "net_vlad.conv.bias"):
        if k in sd:
            out[k] = _t(sd[k])
    return out


def resnet_state_from_torch(state_dict, stages: Sequence[Tuple[int, int, int]],
                            bottleneck: bool, strip_prefixes=("module.", "backbone.", "net."),
                            proj_keys=("whiten", "fc", "proj"),
                            gem_keys=("adpool.p", "pool.p", "gem.p", "adpooling.p")
                            ) -> Dict[str, torch.Tensor]:
    """A torchvision-style ResNet (``conv1``/``bn1``, ``layer{s}.{b}.conv{k}``
    / ``bn{k}``, ``downsample``) with an optional projection and learned GeM
    exponent -> ResNetGeM's state dict, each BatchNorm folded in numpy f32
    (``w * s``, ``beta - mean * s``, ``s = gamma / sqrt(var + 1e-5)``)."""
    sd = {}
    for k, v in state_dict.items():
        for p in strip_prefixes:
            if k.startswith(p):
                k = k[len(p):]
        sd[k] = np.asarray(v)

    out: Dict[str, torch.Tensor] = {}

    def fold(dst: str, conv: str, bn: str) -> None:
        s = sd[f"{bn}.weight"] / np.sqrt(sd[f"{bn}.running_var"] + _BN_EPS)
        out[f"{dst}.weight"] = _t(sd[f"{conv}.weight"] * s[:, None, None, None])
        out[f"{dst}.bias"] = _t(sd[f"{bn}.bias"] - sd[f"{bn}.running_mean"] * s)

    fold("stem", "conv1", "bn1")
    convs = (1, 2, 3) if bottleneck else (1, 2)
    for si, (n_blocks, _, _) in enumerate(stages):
        for bi in range(n_blocks):
            p, q = f"layer{si + 1}.{bi}", f"layers.{si}.{bi}"
            for c in convs:
                fold(f"{q}.conv{c}", f"{p}.conv{c}", f"{p}.bn{c}")
            if f"{p}.downsample.0.weight" in sd:
                fold(f"{q}.downsample", f"{p}.downsample.0", f"{p}.downsample.1")
    for key in proj_keys:
        if f"{key}.weight" in sd:
            w = sd[f"{key}.weight"]
            out["proj.weight"] = _t(w)
            out["proj.bias"] = _t(sd.get(f"{key}.bias", np.zeros(w.shape[0])))
            break
    out["gem_p"] = torch.tensor(3.0)
    for key in gem_keys:
        if key in sd:
            out["gem_p"] = _t(sd[key].reshape(()))
            break
    return out


def cosplace_state_from_torch(state_dict) -> Dict[str, torch.Tensor]:
    """The official CosPlace ResNet-18 (``backbone.`` prefix; GeM
    ``aggregation.1.p``, projection ``aggregation.3`` / ``.2`` or ``fc``)."""
    return resnet_state_from_torch(
        state_dict, R18_STAGES, bottleneck=False, strip_prefixes=("backbone.",),
        proj_keys=("aggregation.3", "aggregation.2", "fc"),
        gem_keys=("aggregation.1.p", "aggregation.0.p", "gem.p"))
