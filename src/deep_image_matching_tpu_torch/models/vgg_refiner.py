"""VGG19-bn encoder and ConvRefiner decoder (port of
``deep_image_matching_tpu/models/vgg_refiner.py``).

The encoder (RoMa's fine encoder; DeDoDe's and RIPE's): VGG19-bn features up
to the conv4 pooling, taken just before each pooling (post-ReLU), at scales
1/2/4/8 with 64/128/256/512 channels. BatchNorm is folded into the
convolutions once, when a checkpoint is loaded
(``convert.vgg19_params_from_torch``), so the parameters are plain
convolutions: ``{"stages": [[{"w": (out, in, 3, 3), "b": (out,)}, ...], ...]}``.

The decoder (DeDoDe, RIPE): per scale a ConvRefiner (``block1``: 1x1 conv,
folded BN, ReLU, 1x1 conv; ``hidden``: the same with a depthwise 5x5 first;
the residual over the hidden blocks divided by 1.4; ``out``: 1x1 conv) whose
output splits into prototype logits and context; ``decode_multiscale`` sums
the logits coarse to fine, upsampling logits and context bilinearly
(half-pixel, as ``jax.image.resize``'s "linear" upsampling) between scales.
Refiner parameters: ``{"block1": {"conv1", "conv2"}, "hidden": [...],
"out"}``, each ``{"w": OIHW, "b"}`` (``convert.refiner_params_from_torch``).
Activations are NHWC, as in the JAX package; the convolutions run
channels-last.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

# vgg19_bn features[:40]: conv indices per stage (bn = idx + 1)
VGG19_CONV_IDX = [[0, 3], [7, 10], [14, 17, 20, 23], [27, 30, 33, 36]]
VGG19_STAGE_DIMS = [64, 128, 256, 512]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, b=None, padding: int = 0,
              groups: int = 1, stride: int = 1) -> torch.Tensor:
    """A convolution of NHWC ``x`` with OIHW ``w``, run channels-last (the
    NCHW view of an NHWC tensor is channels-last); NHWC out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def init_tree() -> Dict:
    """The JAX package's random init recipe (``init_vgg19_params``), in its
    layouts, as numpy: the same draws from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    stages = []
    cin = 3
    for dims, idxs in zip(VGG19_STAGE_DIMS, VGG19_CONV_IDX):
        convs = []
        for _ in idxs:
            w = rng.normal(0, np.sqrt(2.0 / (cin * 9)), (3, 3, cin, dims)).astype(np.float32)
            convs.append({"w": w, "b": np.zeros((dims,), np.float32)})
            cin = dims
        stages.append(convs)
    return {"stages": stages}


def vgg19_features(params: Dict, images: torch.Tensor) -> List[torch.Tensor]:
    """ImageNet-normalized (B, H, W, 3) -> feature maps (B, h, w, c) at
    scales [1, 2, 4, 8]."""
    x = images
    feats = []
    for i, convs in enumerate(params["stages"]):
        if i:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        for p in convs:
            x = F.relu(conv_nhwc(x, p["w"], p["b"], padding=1))
        feats.append(x)
    return feats


def init_refiner_tree(cin: int, hidden: int, cout: int, n_hidden: int) -> Dict:
    """The JAX package's ConvRefiner init (``init_refiner_params``) in its
    layouts, as numpy: the same draws, seeded by the refiner's widths."""
    rng = np.random.default_rng(abs(hash((cin, hidden, cout))) % 2**31)

    def conv(k, ci, co, groups=1):
        w = rng.normal(0, np.sqrt(2.0 / (ci // groups * k * k)), (k, k, ci // groups, co))
        return {"w": w.astype(np.float32), "b": np.zeros((co,), np.float32)}

    return {
        "block1": {"conv1": conv(1, cin, hidden), "conv2": conv(1, hidden, hidden)},
        "hidden": [{"conv1": conv(5, hidden, hidden, groups=hidden),
                    "conv2": conv(1, hidden, hidden)} for _ in range(n_hidden)],
        "out": conv(1, hidden, cout),
    }


def refiner_forward(x: torch.Tensor, p: Dict, residual: bool = True) -> torch.Tensor:
    """One ConvRefiner over NHWC ``x``."""

    def block(x, bp, groups=1):
        w = bp["conv1"]["w"]
        h = F.relu(conv_nhwc(x, w, bp["conv1"]["b"], padding=(w.shape[-1] - 1) // 2,
                             groups=groups))
        return conv_nhwc(h, bp["conv2"]["w"], bp["conv2"]["b"])

    x0 = block(x, p["block1"])
    h = x0
    for bp in p["hidden"]:
        h = block(h, bp, groups=h.shape[-1])
    if residual:
        h = (h + x0) / 1.4
    return conv_nhwc(h, p["out"]["w"], p["out"]["b"])


def upsample_linear(x: torch.Tensor, hw) -> torch.Tensor:
    """NHWC bilinear upsampling to ``hw``, half-pixel (``align_corners=False``,
    which for a larger target is ``jax.image.resize``'s "linear")."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(int(v) for v in hw), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def decode_multiscale(feats: List[torch.Tensor], refiners: Dict, num_prototypes: int,
                      scales: Sequence[str] = ("8", "4", "2", "1")) -> torch.Tensor:
    """Coarse-to-fine decoding of ``feats`` (fine -> coarse, one map per
    scale): each refiner's output splits into (prototype logits, context);
    the summed logits and the context go up to the next finer scale."""
    out = context = None
    scales = list(scales)
    for idx, (fmap, scale) in enumerate(zip(reversed(feats), scales)):
        inp = fmap if context is None else torch.cat([fmap, context], dim=-1)
        stuff = refiner_forward(inp, refiners[scale])
        logits, context = stuff[..., :num_prototypes], stuff[..., num_prototypes:]
        out = logits if out is None else out + logits
        if idx < len(scales) - 1:
            tgt = feats[len(feats) - idx - 2].shape[1:3]
            out, context = upsample_linear(out, tgt), upsample_linear(context, tgt)
    return out
