"""Deformable sampling ops for ALIKED (port of
``deep_image_matching_tpu/ops/deform.py``), in the JAX package's per-image
channels-last layout.

- ``bilinear_sample_zeropad``: ``grid_sample(align_corners=True,
  padding_mode='zeros')``: out-of-range corners contribute zero;
- ``bilinear_sample_zeropad_wide``: the same result from one gather of the
  four corners, concatenated channel-wise;
- ``deform_conv2d``: torchvision's deformable convolution (stride 1,
  dilation 1, zero padding, the ``(dy, dx)`` offset layout) as an offset
  im2col followed by one matrix product; torchvision itself is not used;
- ``extract_patches``: the SDDH patches around integer keypoints with the
  reference's corner clamp;
- ``resize_bilinear_align`` / ``upsample_bilinear_align``: align-corners
  bilinear resizing as two products with interpolation matrices.

The JAX package leaves all of these to XLA, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def bilinear_sample_zeropad(fmap: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """fmap (H, W, C); coords (..., 2) float (x, y) in pixels -> (..., C).
    Corners outside the map contribute zero."""
    H, W, C = fmap.shape
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    flat = fmap.reshape(H * W, C)
    out = None
    for dy in (0.0, 1.0):
        for dx in (0.0, 1.0):
            xi, yi = x0 + dx, y0 + dy
            wgt = (1.0 - (x - xi).abs()) * (1.0 - (y - yi).abs())
            valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            idx = yi.clamp(0, H - 1).int() * W + xi.clamp(0, W - 1).int()
            v = flat[idx.reshape(-1).long()].reshape(*idx.shape, C)
            term = v * (wgt * valid)[..., None]
            out = term if out is None else out + term
    return out


def bilinear_sample_zeropad_wide(fmap: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The result of :func:`bilinear_sample_zeropad` from one gather: the four
    taps (identity, x+1, y+1, xy+1 shifts of a zero-padded map) concatenated
    channel-wise, one 4C-wide row per position."""
    H, W, C = fmap.shape
    # one leading zero row and column: a floor of -1 lands on zeros while its
    # +1 tap reads the true border texel
    fp = F.pad(fmap, (0, 0, 1, 0, 1, 0))                      # (H+1, W+1, C)
    fx = F.pad(fp[:, 1:], (0, 0, 0, 1))
    fy = F.pad(fp[1:], (0, 0, 0, 0, 0, 1))
    fxy = F.pad(fp[1:, 1:], (0, 0, 0, 1, 0, 1))
    cat = torch.cat([fp, fx, fy, fxy], dim=-1).reshape((H + 1) * (W + 1), 4 * C)
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    bx = (x0 + 1).clamp(0, W).int()
    by = (y0 + 1).clamp(0, H).int()
    v = cat[(by * (W + 1) + bx).reshape(-1).long()].reshape(*x.shape, 4, C)
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    vx0 = (x0 >= 0) & (x0 <= W - 1)
    vx1 = (x0 >= -1) & (x0 <= W - 2)
    vy0 = (y0 >= 0) & (y0 <= H - 1)
    vy1 = (y0 >= -1) & (y0 <= H - 2)
    wts = torch.stack([wy0 * wx0 * (vy0 & vx0), wy0 * wx1 * (vy0 & vx1),
                       wy1 * wx0 * (vy1 & vx0), wy1 * wx1 * (vy1 & vx1)], dim=-1)
    return (v * wts.to(v.dtype)[..., None]).sum(-2)


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, padding: int = 1) -> torch.Tensor:
    """Deformable convolution, stride 1, dilation 1 (ALIKED's).

    x (H, W, Cin); offset (H, W, 2 kh kw) in torchvision's layout, (dy, dx)
    per tap; weight (Cout, Cin, kh, kw). Output pixel p takes tap (i, j) at
    (y + i - pad + dy, x + j - pad + dx); out-of-range samples are zero.
    Returns (H, W, Cout) in f32 (the product accumulates in f32)."""
    H, W, Cin = x.shape
    Cout, _, kh, kw = weight.shape
    KK = kh * kw
    dev = x.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    offs = offset.reshape(H, W, KK, 2).float()
    dy = torch.arange(kh, dtype=torch.float32, device=dev).repeat_interleave(kw) - padding
    dx = torch.arange(kw, dtype=torch.float32, device=dev).repeat(kh) - padding
    py = ys[..., None] + dy + offs[..., 0]                     # (H, W, KK)
    px = xs[..., None] + dx + offs[..., 1]
    # all taps through one wide gather, then one (H W, KK Cin) x (KK Cin,
    # Cout) product
    col = bilinear_sample_zeropad_wide(x, torch.stack([px, py], dim=-1))  # (H, W, KK, Cin)
    w = weight.permute(2, 3, 1, 0).reshape(KK * Cin, Cout)
    out = (col.reshape(H * W, KK * Cin).float() @ w.float()).reshape(H, W, Cout)
    if bias is not None:
        out = out + bias.float()
    return out


def extract_patches(fmap: torch.Tensor, centers: torch.Tensor, ps: int) -> torch.Tensor:
    """(K, ps, ps, C) patches of fmap (H, W, C) with the reference's corner
    clamp: corner = center - ps // 2 + 1, clamped to [0, dim - 1 - ps]."""
    H, W, C = fmap.shape
    corner_x = (centers[:, 0] - ps // 2 + 1).int().clamp(0, W - 1 - ps)
    corner_y = (centers[:, 1] - ps // 2 + 1).int().clamp(0, H - 1 - ps)
    o = torch.arange(ps, device=fmap.device)
    ys = corner_y[:, None, None] + o[None, :, None]
    xs = corner_x[:, None, None] + o[None, None, :]
    idx = (ys * W + xs).long()                                  # (K, ps, ps)
    return fmap.reshape(H * W, C)[idx.reshape(-1)].reshape(*idx.shape, C)


def _interp_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_out, n_in) align-corners linear interpolation matrix, two nonzeros
    per row (a clipped row sums its two weights into one column)."""
    if n_in == 1:
        return torch.ones(n_out, 1, device=device)
    pos = torch.arange(n_out, dtype=torch.float32, device=device) * (n_in - 1) / (n_out - 1)
    lo = torch.floor(pos).long()
    hi = (lo + 1).clamp(max=n_in - 1)
    w_hi = pos - lo
    rows = torch.arange(n_out, device=device)
    m = torch.zeros(n_out, n_in, device=device)
    m.index_put_((rows, lo), 1.0 - w_hi, accumulate=True)
    m.index_put_((rows, hi), w_hi, accumulate=True)
    return m


def _interp_apply(x: torch.Tensor, Ho: int, Wo: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, Ho, Wo, C) in f32 by one interpolation product per
    resized axis."""
    B, H, W, C = x.shape
    y = x.float()
    if Ho != H:
        y = torch.einsum("oh,bhwc->bowc", _interp_matrix(H, Ho, x.device), y)
    if Wo != W:
        y = torch.einsum("ow,bhwc->bhoc", _interp_matrix(W, Wo, x.device), y)
    return y


def resize_bilinear_align(x: torch.Tensor, size) -> torch.Tensor:
    """(B, H, W, C) -> (B, size[0], size[1], C), bilinear, align_corners=True."""
    return _interp_apply(x, int(size[0]), int(size[1]))


def upsample_bilinear_align(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H f, W f, C), bilinear, align_corners=True."""
    B, H, W, C = x.shape
    return _interp_apply(x, H * factor, W * factor)
