"""HardNet descriptors, determinant-of-Hessian detection, orientation and
oriented patches: the KeyNet+AffNet+HardNet pipeline (PyTorch port of
``deep_image_matching_tpu/models/hardnet.py``).

- ``hardnet_describe``: the HardNet CNN (Mishchuk et al., NeurIPS'17: seven
  convolutions with affine-free BNs folded at load time, a per-patch input
  norm, a 128-d L2-normalised output) on 32x32 patches;
- ``multiscale_detect``: scale-normalised determinant-of-Hessian detection
  over 4 Gaussian scales with per-level NMS and one top-k (the weight-free
  detector the extractor takes without KeyNet weights);
- ``dominant_orientation``: the angle of the mean gradient over a
  sigma-scaled 8x8 grid (the weight-free orientation);
- ``extract_oriented_patches``: 32x32 patches on the grid rotated by the
  angle, scaled by 6 sigma and, with AffNet, shaped by its ellipse;
- ``keynet_hardnet_extract``: detection -> (AffNet shape) -> (OriNet or
  gradient-moment orientation) -> patches -> HardNet, batched over images.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform import bilinear_sample_zeropad
from ..ops.detect import simple_nms
from .affnet import PatchNet, affnet_shapes, fold_features, orinet_angles

# (cin, cout, kernel, stride, pad)
HARDNET_LAYERS = [(1, 32, 3, 1, 1), (32, 32, 3, 1, 1), (32, 64, 3, 2, 1), (64, 64, 3, 1, 1),
                  (64, 128, 3, 2, 1), (128, 128, 3, 1, 1), (128, 128, 8, 1, 0)]
HARDNET_CONV_IDX = (0, 3, 6, 9, 12, 15, 19)


class HardNet(nn.Module):
    """Seven folded convolutions under ``layers.{i}``."""

    def __init__(self):
        super().__init__()
        self.layers = nn.ModuleList(
            [nn.Conv2d(ci, co, k, stride=s, padding=p) for ci, co, k, s, p in HARDNET_LAYERS])

    @torch.no_grad()
    def reset_random(self, generator: torch.Generator) -> "HardNet":
        for conv in self.layers:
            w = conv.weight
            std = (2.0 / (w.shape[1] * w.shape[2] * w.shape[3])) ** 0.5
            w.copy_(torch.randn(w.shape, generator=generator) * std)
            conv.bias.zero_()
        return self


def hardnet_params_from_torch(state_dict) -> HardNet:
    """A HardNet state dict (``features.{0,3,6,9,12,15,19}`` convolutions,
    affine-free BNs at index + 1) -> ``HardNet``, BNs folded."""
    return fold_features(HardNet(), state_dict, HARDNET_CONV_IDX)


@torch.no_grad()
def hardnet_describe(model: HardNet, patches: torch.Tensor) -> torch.Tensor:
    """(K, 32, 32) -> (K, 128) L2-normalised descriptors."""
    x = patches[:, None].float()
    mu = x.mean(dim=(1, 2, 3), keepdim=True)
    sd = x.std(dim=(1, 2, 3), keepdim=True, unbiased=False) + 1e-7
    x = (x - mu) / sd
    n = len(model.layers)
    for i, conv in enumerate(model.layers):
        x = conv(x)
        if i < n - 1:
            x = F.relu(x)
    d = x.reshape(x.shape[0], -1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp(min=1e-12)


def _gauss_kernel(sigma: float, radius: int) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """(B, H, W) separable Gaussian blur, zero padding."""
    r = max(1, int(3 * sigma))
    g = _gauss_kernel(sigma, r).to(img.device)
    x = F.conv2d(img[:, None], g.reshape(1, 1, 1, -1), padding=(0, r))
    return F.conv2d(x, g.reshape(1, 1, -1, 1), padding=(r, 0))[:, 0]


def _gradients(img: torch.Tensor):
    """Central differences with wrap-around (B, H, W) -> (gx, gy)."""
    gx = (torch.roll(img, -1, dims=2) - torch.roll(img, 1, dims=2)) / 2.0
    gy = (torch.roll(img, -1, dims=1) - torch.roll(img, 1, dims=1)) / 2.0
    return gx, gy


@torch.no_grad()
def multiscale_detect(
    images: torch.Tensor,     # (B, H, W) grey in [0, 1]
    valid_hw: torch.Tensor,   # (B, 2)
    max_keypoints: int,
    n_levels: int = 4,
    init_sigma: float = 1.6,
    nms_radius: int = 3,
    threshold: float = 1e-5,
):
    """Scale-space determinant-of-Hessian detection. Returns (kpts (B, K, 2),
    scores, sigmas, valid), invalid rows 0 (sigma ``init_sigma``)."""
    responses, sigmas = [], []
    images = images.float()
    for lvl in range(n_levels):
        sigma = init_sigma * (1.6 ** lvl)
        gx, gy = _gradients(_blur(images, sigma))
        gxx, gxy = _gradients(gx)
        _, gyy = _gradients(gy)
        responses.append((gxx * gyy - gxy * gxy) * sigma ** 4)
        sigmas.append(sigma)
    resp = torch.stack(responses, dim=1)        # (B, S, H, W)
    B, S, H, W = resp.shape
    nms = simple_nms(resp.reshape(B * S, H, W), nms_radius).reshape(B, S, H, W)
    dev = images.device
    ys = torch.arange(H, device=dev)[None, None, :, None]
    xs = torch.arange(W, device=dev)[None, None, None, :]
    vhw = valid_hw.to(dev)
    border = 16
    ok = ((ys >= border) & (ys < vhw[:, None, 0, None, None] - border)
          & (xs >= border) & (xs < vhw[:, None, 1, None, None] - border))
    flat = torch.where(ok & (nms > threshold), nms, nms.new_tensor(-1.0))
    vals, idx = torch.sort(flat.reshape(B, S * H * W), dim=1, descending=True, stable=True)
    vals, idx = vals[:, :max_keypoints], idx[:, :max_keypoints]
    valid = vals > 0
    rem = idx % (H * W)
    kpts = torch.stack([(rem % W).float(), (rem // W).float()], -1)
    sig = torch.tensor(sigmas, dtype=torch.float32, device=dev)[idx // (H * W)]
    return (torch.where(valid[..., None], kpts, kpts.new_tensor(0.0)),
            torch.where(valid, vals, vals.new_tensor(0.0)),
            torch.where(valid, sig, sig.new_tensor(init_sigma)), valid)


@torch.no_grad()
def dominant_orientation(images: torch.Tensor, kpts: torch.Tensor, sigmas: torch.Tensor,
                         n_samples: int = 8) -> torch.Tensor:
    """(B, K) angles of the mean gradient over an ``n_samples`` square grid
    spanning +-3 sigma around each keypoint."""
    gx, gy = _gradients(images.float())
    lin = torch.linspace(-1.0, 1.0, n_samples, device=images.device)
    oy, ox = torch.meshgrid(lin, lin, indexing="ij")
    offs = torch.stack([ox.reshape(-1), oy.reshape(-1)], -1)          # (n*n, 2)
    out = []
    for b in range(images.shape[0]):
        pos = kpts[b][:, None, :] + offs[None] * (3.0 * sigmas[b][:, None, None])
        sgx = bilinear_sample_zeropad(gx[b][..., None], pos)[..., 0]
        sgy = bilinear_sample_zeropad(gy[b][..., None], pos)[..., 0]
        out.append(torch.atan2(sgy.mean(1), sgx.mean(1)))
    return torch.stack(out)


@torch.no_grad()
def extract_oriented_patches(images: torch.Tensor, kpts: torch.Tensor, sigmas: torch.Tensor,
                             angles: torch.Tensor, patch_size: int = 32,
                             scale_mult: float = 6.0,
                             shapes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, K, ps, ps) patches: grid point g (in [-0.5, 0.5]^2) maps to
    ``kpt + 6 sigma (g^T R)`` with R the rotation by the angle, composed
    with the transposed AffNet shape where ``shapes`` (B, K, 2, 2) is given."""
    ps = patch_size
    lin = torch.linspace(-0.5, 0.5, ps, device=images.device)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)          # (ps*ps, 2)
    out = []
    for b in range(images.shape[0]):
        cos, sin = torch.cos(angles[b]), torch.sin(angles[b])
        R = torch.stack([torch.stack([cos, -sin], -1), torch.stack([sin, cos], -1)], -2)
        if shapes is not None:
            R = torch.einsum("kcd,kde->kce", R, shapes[b].transpose(-1, -2))
        span = (scale_mult * sigmas[b])[:, None, None]
        pos = kpts[b][:, None, :] + torch.einsum("pc,kcd->kpd", grid, R) * span
        vals = bilinear_sample_zeropad(images[b].float()[..., None], pos)[..., 0]
        out.append(vals.reshape(-1, ps, ps))
    return torch.stack(out)


@torch.no_grad()
def keynet_hardnet_extract(
    model: HardNet,
    images: torch.Tensor,      # (B, H, W) grey
    valid_hw: torch.Tensor,
    max_keypoints: int = 4000,
    upright: bool = False,
    detector: str = "doh",
    keynet: Optional[nn.Module] = None,
    affnet: Optional[PatchNet] = None,
    orinet: Optional[PatchNet] = None,
) -> Dict[str, torch.Tensor]:
    """Detect (``detector`` "keynet" with ``keynet``, else DoH) -> AffNet
    shapes (where ``affnet``) -> orientation (zero if ``upright``, OriNet on
    shape-normalised patches where ``orinet``, else the gradient moment) ->
    oriented patches -> HardNet. Returns keypoints, scores, descriptors
    (zero on invalid rows), mask, scales (sigmas) and angles."""
    if detector == "keynet":
        from .keynet import keynet_multiscale_detect

        kpts, scores, sigmas, valid = keynet_multiscale_detect(keynet, images, valid_hw,
                                                               max_keypoints)
    else:
        kpts, scores, sigmas, valid = multiscale_detect(images, valid_hw, max_keypoints)
    zero = torch.zeros(kpts.shape[:2], dtype=torch.float32, device=kpts.device)
    shapes = None
    if affnet is not None:
        probe = extract_oriented_patches(images, kpts, sigmas, zero)
        shapes = torch.stack([affnet_shapes(affnet, p) for p in probe])
    if upright:
        angles = zero
    elif orinet is not None:
        ori = extract_oriented_patches(images, kpts, sigmas, zero, shapes=shapes)
        angles = torch.stack([orinet_angles(orinet, p) for p in ori])
    else:
        angles = dominant_orientation(images, kpts, sigmas)
    patches = extract_oriented_patches(images, kpts, sigmas, angles, shapes=shapes)
    descs = torch.stack([hardnet_describe(model, p) for p in patches]) * valid[..., None]
    return {"keypoints": kpts, "scores": scores, "descriptors": descs, "mask": valid,
            "scales": sigmas, "angles": angles}
