"""VGG19-bn feature pyramid (port of the pyramid half of
``deep_image_matching_tpu/models/vgg_refiner.py``).

RoMa's fine encoder: VGG19-bn features up to the conv4 pooling, taken just
before each pooling (post-ReLU), at scales 1/2/4/8 with 64/128/256/512
channels. BatchNorm is folded into the convolutions once, when a checkpoint
is loaded (``convert.vgg19_params_from_torch``), so the parameters are plain
convolutions: ``{"stages": [[{"w": (out, in, 3, 3), "b": (out,)}, ...], ...]}``.
Activations are NHWC, as in the JAX package; the convolutions run
channels-last. The ConvRefiner decoder of DeDoDe (``refiner_forward``,
``decode_multiscale``) has no caller in the port yet.
"""

from __future__ import annotations

from typing import Dict, List

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
