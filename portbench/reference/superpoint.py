"""SuperPoint (DeTone et al., CVPRW 2018), as the published
``SuperPointPretrainedNetwork`` and SuperGlue's ``models/superpoint.py``
compute it, one image at a time at its own size.

Parameters carry the published state-dict keys (``conv1a.weight`` ...
``convDb.bias``); the benchmark's seeded checkpoint is ``FILE``, drawn by
``std`` and ``fixed``. Departures: top-k is a stable descending sort in raster
order (``torch.topk`` orders ties in no set order), so tied scores keep
the first position.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from .lowp import exact

# name, in, out, kernel (SuperPointNet)
LAYERS = (
    ("conv1a", 1, 64, 3), ("conv1b", 64, 64, 3),
    ("conv2a", 64, 64, 3), ("conv2b", 64, 64, 3),
    ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3),
    ("conv4a", 128, 128, 3), ("conv4b", 128, 128, 3),
    ("convPa", 128, 256, 3), ("convPb", 256, 65, 1),
    ("convDa", 128, 256, 3), ("convDb", 256, 256, 1),
)


def shapes() -> Dict[str, tuple]:
    """Every parameter's shape under its published key."""
    out = {}
    for name, cin, cout, k in LAYERS:
        out[f"{name}.weight"] = (cout, cin, k, k)
        out[f"{name}.bias"] = (cout,)
    return out


FILE = "superpoint_v1.pth"


def std(name: str, shape: tuple) -> float:
    """The seeded checkpoint's normal standard deviation of one entry, the
    port's ``reset_random`` recipe: He-normal weights; 0 where the entry is
    not drawn (the biases, which ``fixed`` gives)."""
    return math.sqrt(2.0 / math.prod(shape[1:])) if name.endswith("weight") else 0.0


def fixed(name: str, shape: tuple) -> torch.Tensor:
    return torch.zeros(shape)


def _conv(sd, name, x, rnd, relu=True):
    w = sd[f"{name}.weight"]
    y = F.conv2d(rnd(x), rnd(w), sd[f"{name}.bias"], padding=w.shape[-1] // 2)
    return F.relu(y) if relu else y


def simple_nms(scores: torch.Tensor, r: int) -> torch.Tensor:
    """SuperGlue's ``simple_nms`` on a (H, W) map."""
    def pool(x):
        return F.max_pool2d(x[None, None], 2 * r + 1, stride=1, padding=r)[0, 0]

    zeros = torch.zeros_like(scores)
    max_mask = scores == pool(scores)
    for _ in range(2):
        supp_mask = pool(max_mask.float()) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == pool(supp_scores)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


@torch.no_grad()
def extract(sd: Dict[str, torch.Tensor], image: torch.Tensor, max_keypoints: int,
            nms_radius: int, threshold: float, border: int = 4,
            rnd: Callable = exact) -> Dict[str, torch.Tensor]:
    """``image``: (H, W) uint8 on the device. Returns keypoints (K, 2) as
    (x, y), scores (K,) and L2-normalised descriptors (K, 256)."""
    x = (image.float() / 255.0)[None, None]
    for a, b in (("conv1a", "conv1b"), ("conv2a", "conv2b"), ("conv3a", "conv3b")):
        x = F.max_pool2d(_conv(sd, b, _conv(sd, a, x, rnd), rnd), 2, 2)
    x = _conv(sd, "conv4b", _conv(sd, "conv4a", x, rnd), rnd)
    semi = _conv(sd, "convPb", _conv(sd, "convPa", x, rnd), rnd, relu=False)
    heat = torch.softmax(semi, 1)[0, :-1]                     # (64, Hc, Wc)
    _, hc, wc = heat.shape
    heat = heat.permute(1, 2, 0).reshape(hc, wc, 8, 8).permute(0, 2, 1, 3).reshape(hc * 8, wc * 8)
    heat = simple_nms(heat, nms_radius)
    h, w = heat.shape
    ys, xs = torch.nonzero(heat > threshold, as_tuple=True)
    keep = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    ys, xs = ys[keep], xs[keep]
    s = heat[ys, xs]
    order = torch.sort(s, descending=True, stable=True).indices[:max_keypoints]
    kpts = torch.stack([xs[order], ys[order]], -1).float()
    s = s[order]

    desc = _conv(sd, "convDb", _conv(sd, "convDa", x, rnd), rnd, relu=False)
    desc = F.normalize(desc, p=2, dim=1)
    cell = 8
    grid = kpts - cell / 2 + 0.5
    grid = grid / grid.new_tensor([wc * cell - cell / 2 - 0.5, hc * cell - cell / 2 - 0.5])
    grid = grid * 2 - 1
    d = F.grid_sample(desc, grid.view(1, 1, -1, 2), mode="bilinear", align_corners=True)
    d = F.normalize(d.reshape(desc.shape[1], -1), p=2, dim=0).T
    return {"keypoints": kpts, "scores": s, "descriptors": d}



def extract_image(sd: Dict[str, torch.Tensor], path, conf: dict, device,
                  rnd: Callable = exact) -> Dict[str, torch.Tensor]:
    """``extract`` on one image file, read as the published demo reads it
    (8-bit grayscale), with the configuration's extractor options ``conf``."""
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise OSError(f"cannot read {path}")
    return extract(sd, torch.from_numpy(img).to(device), int(conf["max_keypoints"]),
                   int(conf["nms_radius"]), float(conf["keypoint_threshold"]),
                   int(conf.get("remove_borders", 4)), rnd)
