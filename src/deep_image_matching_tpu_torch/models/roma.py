"""RoMa dense matcher (port of ``deep_image_matching_tpu/models/roma.py``).

- coarse encoder: DINOv2 ViT-L/14 patch tokens (``models/dinov2.py``); fine
  encoder: the VGG19-bn pyramid (``models/vgg_refiner.py``);
- per-scale 1x1 projections (BatchNorm folded at load);
- GP match encoder at scale 16: cosine kernel, fourier coordinate basis
  cos(8 pi W p), posterior mean K_xy (K_yy + sigma I)^-1 f (Cholesky);
- transformer coordinate decoder: 5 ViT blocks (width 1024, 8 heads, f32,
  plain PyTorch: the JAX package runs them outside Pallas too) over
  [GP posterior, features] tokens -> 64^2 + 1 anchor classifier, turned into
  a flow by ``cls_to_flow_refine``;
- ConvRefiners at scales 16/8/4/2/1 with displacement embedding and
  (2r+1)^2 local correlation around the current warp; the scale-1 refiner's
  nine depthwise blocks (C = 24) go through ``ops/refiner.py`` (kernel 9 on
  CUDA), the other scales through cuDNN convolutions, as the JAX package
  leaves them to XLA;
- symmetric matching (A->B and B->A in one batch), certainty attenuation,
  and threshold-balanced sampling on the device (``sample_matches_device``).

Activations are NHWC and batch-first, as in the JAX package; every function
here takes batches. Parameters are dicts of tensors in torch layouts
(convolutions OIHW, linear layers ``nn.Linear`` (out, in)), filled by
``convert.roma_params_from_jax`` or ``convert.roma_params_from_torch``.
f32 convolutions and products run in full f32, never TF32
(``utils/device.full_f32``): the flow drifts through the coarse-to-fine
loop otherwise.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.refiner import MAX_C as _REFINER_KERNEL_MAX_C
from ..ops.refiner import refiner_dw_stack
from ..utils.device import full_f32
from . import dinov2
from .vgg_refiner import IMAGENET_MEAN, IMAGENET_STD, conv_nhwc, vgg19_features
from .vgg_refiner import init_tree as vgg_init_tree

Params = Dict

SCALES = ["16", "8", "4", "2", "1"]
CLS_RES = 64
GP_DIM = 512
# ConvRefiner configs: (in_dim, hidden_dim, disp_dim, local_corr_radius)
_REFINERS = {
    "16": (2 * 512 + 128 + 225, 2 * 512 + 128 + 225, 128, 7),
    "8": (2 * 512 + 64 + 49, 2 * 512 + 64 + 49, 64, 3),
    "4": (2 * 256 + 32 + 25, 2 * 256 + 32 + 25, 32, 2),
    "2": (2 * 64 + 16, 128 + 16, 16, None),
    "1": (2 * 9 + 6, 24, 6, None),
}
_PROJ = {"16": (1024, 512), "8": (512, 512), "4": (256, 256), "2": (128, 64), "1": (64, 9)}


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_tree(dinov2_depth: int = 2) -> Params:
    """The JAX package's random init recipe (``init_params``) at the
    published shapes, in its layouts, as numpy: the same draws in the same
    order, so the port's random weights equal the JAX package's."""
    rng = np.random.default_rng(0)

    def lin(ci, co):
        return {"w": rng.normal(0, 1 / np.sqrt(ci), (ci, co)).astype(np.float32),
                "b": np.zeros((co,), np.float32)}

    def conv(k, ci, co, groups=1):
        w = rng.normal(0, np.sqrt(2.0 / (ci // groups * k * k)), (k, k, ci // groups, co))
        return {"w": w.astype(np.float32), "b": np.zeros((co,), np.float32)}

    def refiner(cin, hidden, disp, n_hidden=8):
        return {
            "block1": {"conv1": conv(5, cin, hidden, groups=cin), "conv2": conv(1, hidden, hidden)},
            "hidden": [{"conv1": conv(5, hidden, hidden, groups=hidden),
                        "conv2": conv(1, hidden, hidden)} for _ in range(n_hidden)],
            "out": conv(1, hidden, 3),
            "disp_emb": lin(2, disp),
        }

    d = 1024
    ones, zeros = np.ones((d,), np.float32), np.zeros((d,), np.float32)
    vit_blocks = [{"ln1": {"g": ones, "b": zeros}, "qkv": lin(d, 3 * d), "proj": lin(d, d),
                   "ln2": {"g": ones, "b": zeros}, "fc1": lin(d, 4 * d), "fc2": lin(4 * d, d)}
                  for _ in range(5)]
    return {
        "vgg": vgg_init_tree(),
        "proj": {s: lin(ci, co) for s, (ci, co) in _PROJ.items()},
        "gp_pos_conv": lin(2, GP_DIM),
        "embed_blocks": vit_blocks,
        "embed_out": lin(d, CLS_RES ** 2 + 1),
        "refiners": {s: refiner(ci, h, disp) for s, (ci, h, disp, _r) in _REFINERS.items()},
        "dinov2": dinov2.init_tree(depth=dinov2_depth),
    }


def init_params(dinov2_depth: int = 2) -> Params:
    """Random weights at the published shapes (DINOv2 at ``dinov2_depth``
    blocks), equal to the JAX package's ``init_params``."""
    from ..convert import roma_params_from_jax

    return roma_params_from_jax(init_tree(dinov2_depth))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _grid(h: int, w: int, device=None) -> torch.Tensor:
    """Half-pixel normalized coordinate grid (h, w, 2) in (x, y) order."""
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h * 2.0 - 1.0
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w * 2.0 - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def _grid_sample(fmap: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with zero padding, ``align_corners=False``: fmap
    (B, H, W, C), coords (B, h, w, 2) normalized -> (B, h, w, C)."""
    out = F.grid_sample(fmap.permute(0, 3, 1, 2), coords, mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.permute(0, 2, 3, 1)


def _resize(x: torch.Tensor, hw) -> torch.Tensor:
    """``jax.image.resize(..., "linear")`` of NHWC maps: half-pixel bilinear,
    antialiased when it shrinks (a triangle kernel widened by the scale)."""
    hw = tuple(int(v) for v in hw)
    shrink = hw[0] < x.shape[1] or hw[1] < x.shape[2]
    y = F.interpolate(x.permute(0, 3, 1, 2), size=hw, mode="bilinear", align_corners=False,
                      antialias=shrink)
    return y.permute(0, 2, 3, 1)


def cos_kernel(x, y, T: float = 0.2, eps: float = 1e-6) -> torch.Tensor:
    """K(x, y) = exp((cos(x, y) - 1) / T); x (B, N, D), y (B, M, D) -> (B, N, M)."""
    c = torch.einsum("bnd,bmd->bnm", x, y)
    nx = torch.linalg.norm(x, dim=-1)[..., None]
    ny = torch.linalg.norm(y, dim=-1)[:, None, :]
    return torch.exp((c / (nx * ny + eps) - 1.0) / T)


def gp_posterior(params, f1, f2, T: float = 0.2, sigma_noise: float = 0.1) -> torch.Tensor:
    """GP match encoder at the coarse scale (no covariance): the posterior
    mean of the fourier-embedded image-2 coordinates given feature
    similarity. f1, f2 (B, H, W, C) -> (B, H, W, GP_DIM)."""
    B, H, W, C = f1.shape
    coords = _grid(H, W, f1.device)
    f = torch.cos(8.0 * math.pi * dinov2.lin(coords, params["gp_pos_conv"]))
    f = f.reshape(1, H * W, -1).expand(B, -1, -1)
    x = f1.reshape(B, H * W, C).float()
    y = f2.reshape(B, H * W, C).float()
    K_xy = cos_kernel(x, y, T)
    K_yy = cos_kernel(y, y, T)
    eye = torch.eye(H * W, dtype=torch.float32, device=f1.device) * sigma_noise
    # K_yy + sigma I is symmetric positive definite: Cholesky, no pivoting
    chol = torch.linalg.cholesky(K_yy + eye[None])
    sol = torch.cholesky_solve(f, chol)
    return torch.bmm(K_xy, sol).reshape(B, H, W, -1)


def _vit_block_fwd(x, blk, num_heads: int = 8) -> torch.Tensor:
    """A pre-norm ViT block of the coordinate decoder (width 1024, head dim
    128), in x's dtype with f32 scores."""
    B, N, D = x.shape
    hd = D // num_heads
    h = dinov2.ln(x, blk["ln1"])
    qkv = dinov2.lin(h, blk["qkv"]).reshape(B, N, 3, num_heads, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    sim = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) / np.sqrt(hd)
    attn = torch.softmax(sim, dim=-1).to(x.dtype)
    out = torch.einsum("bhij,bhjd->bhid", attn.float(), v.float()).to(x.dtype)
    out = dinov2.lin(out.transpose(1, 2).reshape(B, N, D), blk["proj"])
    if "ls1" in blk:
        out = out * blk["ls1"]
    x = x + out
    h = dinov2.ln(x, blk["ln2"])
    h = F.gelu(dinov2.lin(h, blk["fc1"]).float())
    h = dinov2.lin(h.to(x.dtype), blk["fc2"])
    if "ls2" in blk:
        h = h * blk["ls2"]
    return x + h


def cls_to_flow_refine(cls_logits: torch.Tensor) -> torch.Tensor:
    """(B, H, W, R*R) anchor logits -> (B, H, W, 2) flow by the local
    5-anchor refinement around the most likely anchor."""
    B, H, W, C = cls_logits.shape
    res = int(round(np.sqrt(C)))
    lin = torch.linspace(-1 + 1 / res, 1 - 1 / res, res, device=cls_logits.device)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    G = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)  # (C, 2)
    p = torch.softmax(cls_logits, dim=-1)
    mode = torch.argmax(p, dim=-1)
    idx = torch.stack([mode - 1, mode, mode + 1, mode - res, mode + res], dim=-1).clamp(0, C - 1)
    nb = torch.gather(p, -1, idx)  # (B, H, W, 5)
    anchors = G[idx]               # (B, H, W, 5, 2)
    return (nb[..., None] * anchors).sum(-2) / nb.sum(-1, keepdim=True)


def local_correlation(f1, f2, flow, radius: int, with_warp: bool = False,
                      gather_dtype: Optional[torch.dtype] = None, impl: str = "auto"):
    """(2r+1)^2 correlation of f1 with f2 sampled around the flow targets.
    f1, f2 (B, H, W, C); flow (B, H, W, 2) normalized -> (B, H, W, (2r+1)^2).

    The window taps lie one pixel apart, so they share their bilinear
    fractional weights: the integer (2r+2)^2 window is correlated once and
    the scalar maps are blended. Taps outside f2 read zeros (grid_sample's
    zero padding). Two implementations with the JAX package's static
    choice: ``dense`` (all correlations as one product, then a window slice
    per position) for N = H * W <= 1500, ``gather`` (the window's features
    gathered per position) above. ``with_warp=True`` also returns the
    bilinear warp ``grid_sample(f2, flow)``, from the window's centre taps
    where the features were gathered."""
    B, H, W, C = f1.shape
    r = radius
    M, K = 2 * r + 2, 2 * r + 1
    px = (flow[..., 0] + 1.0) * W / 2.0 - 0.5
    py = (flow[..., 1] + 1.0) * H / 2.0 - 0.5
    x0, y0 = torch.floor(px), torch.floor(py)
    fx = (px - x0)[..., None, None]
    fy = (py - y0)[..., None, None]
    Hp, Wp = H + 2 * M, W + 2 * M
    v = None
    if impl == "dense" or (impl == "auto" and H * W <= 1500):
        g = _local_corr_dense(f1, f2, x0, y0, r, M, Hp, Wp, gather_dtype)
    else:
        f2g = f2 if gather_dtype is None else f2.to(gather_dtype)
        # an M-wide zero border: clamped taps land on zeros
        f2p = F.pad(f2g, (0, 0, M, M, M, M)).reshape(B, Hp * Wp, C)
        offs = torch.arange(-r, r + 2, device=f1.device)
        tx = (x0.long()[..., None] + M + offs).clamp(0, Wp - 1)   # (B, H, W, M)
        ty = (y0.long()[..., None] + M + offs).clamp(0, Hp - 1)
        idx = (ty[..., :, None] * Wp + tx[..., None, :]).reshape(B, -1)
        v = f2p[torch.arange(B, device=f1.device)[:, None], idx]
        v = v.reshape(B, H, W, M * M, C).float()                  # (y-tap, x-tap) rows
        g = torch.einsum("bhwc,bhwtc->bhwt", f1.float() / np.sqrt(C), v).reshape(B, H, W, M, M)
    corr = ((1 - fy) * (1 - fx) * g[..., 0:K, 0:K]
            + (1 - fy) * fx * g[..., 0:K, 1:K + 1]
            + fy * (1 - fx) * g[..., 1:K + 1, 0:K]
            + fy * fx * g[..., 1:K + 1, 1:K + 1]).reshape(B, H, W, K * K)
    if not with_warp:
        return corr
    if v is None:
        x_hat = _grid_sample(f2.float(), flow).to(f2.dtype)
    else:
        # the bilinear warp from the window's centre 2x2 (taps r, r + 1)
        v = v.reshape(B, H, W, M, M, C)
        wx1, wy1 = fx[..., 0], fy[..., 0]
        x_hat = ((1 - wy1) * (1 - wx1) * v[..., r, r, :] + (1 - wy1) * wx1 * v[..., r, r + 1, :]
                 + wy1 * (1 - wx1) * v[..., r + 1, r, :] + wy1 * wx1 * v[..., r + 1, r + 1, :])
    return corr, x_hat


def _local_corr_dense(f1, f2, x0, y0, r, M, Hp, Wp, dtype):
    """Correlate-then-slice window extraction: g (B, H, W, M, M) with
    g[p, dy, dx] = <f1[p], f2[y0 - r + dy, x0 - r + dx]> / sqrt(C), zeros for
    taps outside f2. The full correlation matrix is built in chunks of
    positions that keep it under 512 MB."""
    B, H, W, C = f1.shape
    N = H * W
    f1c = (f1 if dtype is None else f1.to(dtype)).reshape(B, N, C).float()
    f2c = f2 if dtype is None else f2.to(dtype)
    # an M-wide zero border and one more zero row below, so every window
    # slice of M * Wp values stays in bounds
    f2p = F.pad(f2c, (0, 0, M, M, M, M + 1)).reshape(B, (Hp + 1) * Wp, C).float()
    row = (y0 + (M - r)).clamp(0, Hp - M).long()
    col = (x0 + (M - r)).clamp(0, Wp - M).long()
    start = (row * Wp + col).reshape(B, N)
    MWp = M * Wp
    span = torch.arange(MWp, device=f1.device)
    nch = 1
    while N * (Hp + 1) * Wp * 4 // nch > int(512e6) or N % nch:
        nch += 1
    segs = []
    for c in range(nch):
        sl = slice(c * (N // nch), (c + 1) * (N // nch))
        cfull = torch.bmm(f1c[:, sl], f2p.transpose(1, 2))        # (B, P, (Hp+1) Wp)
        segs.append(torch.gather(cfull, 2, start[:, sl, None] + span))
    seg = torch.cat(segs, dim=1)
    return seg.reshape(B, H, W, M, Wp)[..., :M] / np.sqrt(C)


def _refiner_block(x, bp):
    """Depthwise 5x5 -> ReLU -> 1x1, both with bias (NHWC)."""
    h = F.relu(conv_nhwc(x, bp["conv1"]["w"], bp["conv1"]["b"], padding=2, groups=x.shape[-1]))
    return conv_nhwc(h, bp["conv2"]["w"], bp["conv2"]["b"])


def conv_refiner_fwd(p, f1, f2, flow, scale: str, scale_factor: float = 1.0,
                     compute_dtype: torch.dtype = torch.float32,
                     corr_dtype: Optional[torch.dtype] = None):
    """One refinement step at a scale: (displacement (B, H, W, 2), certainty
    (B, H, W, 1)). ``compute_dtype=bfloat16`` runs the convolution stack and
    the feature gathers in bf16 (flow coordinates and the output head stay
    f32)."""
    B, H, W, C = f1.shape
    _ci, hidden, _disp, radius = _REFINERS[scale]
    if compute_dtype != torch.float32:
        f1, f2 = f1.to(compute_dtype), f2.to(compute_dtype)
        p = {**dinov2.cast({k: v for k, v in p.items() if k != "out"}, compute_dtype),
             "out": p["out"]}
    if radius is not None:
        # one window gather gives the correlation volume and the warp
        corr, x_hat = local_correlation(f1, f2, flow, radius, with_warp=True,
                                        gather_dtype=corr_dtype)
    else:
        x_hat = _grid_sample(f2.float(), flow)
    disp = flow - _grid(H, W, f1.device)
    emb = F.linear(40 / 32 * scale_factor * disp, p["disp_emb"]["w"].float(),
                   p["disp_emb"]["b"].float())
    parts = [f1, x_hat.to(f1.dtype), emb.to(f1.dtype)]
    if radius is not None:
        parts.append(corr.to(f1.dtype))
    x = torch.cat(parts, dim=-1)
    blocks = [p["block1"]] + list(p["hidden"])
    # the JAX package's Pallas gate (f32, hidden width <= 64, 5x5 taps):
    # scale 1 only
    if (compute_dtype == torch.float32 and hidden <= _REFINER_KERNEL_MAX_C
            and all(tuple(bp["conv1"]["w"].shape[2:]) == (5, 5) for bp in blocks)):
        x = refiner_dw_stack(
            x.contiguous(),
            torch.stack([bp["conv1"]["w"].permute(2, 3, 1, 0) for bp in blocks]).contiguous(),
            torch.stack([bp["conv1"]["b"] for bp in blocks]),
            torch.stack([bp["conv2"]["w"].permute(2, 3, 1, 0) for bp in blocks]).contiguous(),
            torch.stack([bp["conv2"]["b"] for bp in blocks]),
        )
    else:
        for bp in blocks:
            x = _refiner_block(x, bp)
    out = conv_nhwc(x.float(), p["out"]["w"], p["out"]["b"])
    return out[..., :2], out[..., 2:3]


# ---------------------------------------------------------------------------
# Full matcher
# ---------------------------------------------------------------------------

def decode(params, f1_pyr, f2_pyr, scales: Sequence[str] = SCALES, flow=None, certainty=None,
           scale_factor: float = 1.0, compute_dtype: torch.dtype = torch.float32,
           corr_dtype: Optional[torch.dtype] = None, with_cert16: bool = False):
    """Coarse-to-fine warp decoding: (flow, certainty[, scale-16 certainty
    after that scale's refiner, for the attenuation])."""
    sizes = {s: tuple(f1_pyr[s].shape[1:3]) for s in f1_pyr}
    coarsest = scales[0]
    B = f1_pyr[coarsest].shape[0]
    dev = f1_pyr[coarsest].device
    if flow is None:
        h, w = sizes[coarsest]
        flow = _grid(h, w, dev)[None].repeat(B, 1, 1, 1)
        certainty = torch.zeros((B, h, w, 1), dtype=torch.float32, device=dev)
    else:
        flow = _resize(flow, sizes[coarsest])
        certainty = _resize(certainty, sizes[coarsest])
    cert16 = None
    for s in scales:
        f1_s = dinov2.lin(f1_pyr[s], params["proj"][s])
        f2_s = dinov2.lin(f2_pyr[s], params["proj"][s])
        if s == "16":
            gp = gp_posterior(params, f1_s, f2_s)
            tokens = torch.cat([gp, f1_s], dim=-1)
            h, w = tokens.shape[1:3]
            t = tokens.reshape(B, h * w, -1)
            for blk in params["embed_blocks"]:
                t = _vit_block_fwd(t, blk)
            out = dinov2.lin(t, params["embed_out"]).reshape(B, h, w, -1)
            cls_logits, certainty = out[..., :-1], out[..., -1:]
            flow = cls_to_flow_refine(cls_logits)
        ins = int(s)
        delta_flow, delta_cert = conv_refiner_fwd(
            params["refiners"][s], f1_s, f2_s, flow, s, scale_factor,
            compute_dtype=compute_dtype, corr_dtype=corr_dtype)
        # the displacement is normalized by the full (scale-1) resolution at
        # every scale, not by the scale's own feature size
        h1, w1 = sizes["1"]
        disp = ins * torch.stack([delta_flow[..., 0] / (4 * w1), delta_flow[..., 1] / (4 * h1)],
                                 dim=-1)
        flow = flow + disp
        certainty = certainty + delta_cert
        if s == "16":
            cert16 = certainty
        if s != "1":
            nxt = str(ins // 2)
            flow = _resize(flow, sizes[nxt])
            certainty = _resize(certainty, sizes[nxt])
    if with_cert16:
        return flow, certainty, cert16
    return flow, certainty


def build_pyramid(params, images, use_dino: bool = True,
                  compute_dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """images (B, H, W, 3) in [0, 1] -> {scale: (B, h, w, c)}."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=images.device)
    std = torch.as_tensor(IMAGENET_STD, device=images.device)
    x = (images - mean) / std
    feats = vgg19_features(params["vgg"], x)
    pyr = {"1": feats[0], "2": feats[1], "4": feats[2], "8": feats[3]}
    if use_dino:
        B, H, W, _ = images.shape
        tokens = dinov2.forward_features(params["dinov2"], x, compute_dtype=compute_dtype)
        pyr["16"] = tokens.reshape(B, H // 14, W // 14, -1)
    return pyr


def _attenuate(cert, cert16):
    """Certainty attenuation: the scale-16 certainty interpolated to the
    output resolution, its negative part scaled by 0.5 and subtracted."""
    low = _resize(cert16, cert.shape[1:3])
    return cert - 0.5 * low * (low < 0.0)


def _as_float_images(im: torch.Tensor) -> torch.Tensor:
    return im.float() / 255.0 if im.dtype == torch.uint8 else im


def _swap_halves(pyr, B):
    return {s: torch.cat([v[B:], v[:B]], dim=0) for s, v in pyr.items()}


@torch.no_grad()
def match_pair(params, imA, imB, compute_dtype: torch.dtype = torch.bfloat16,
               decoder_dtype: torch.dtype = torch.float32,
               corr_dtype: Optional[torch.dtype] = None, attenuate_cert: bool = False,
               with_cert16: bool = False):
    """Symmetric dense matching at the model resolution. imA, imB (B, H, W,
    3), uint8 or [0, 1], H and W multiples of 56. Returns (warpAB, certA,
    warpBA, certB) at scale-1 resolution, normalized; ``with_cert16`` appends
    the scale-16 certainties (certA16, certB16) for the upsample pass;
    ``attenuate_cert`` applies the attenuation here (no upsample pass)."""
    B = imA.shape[0]
    with full_f32():
        both = torch.cat([_as_float_images(imA), _as_float_images(imB)], dim=0)
        pyr = build_pyramid(params, both, compute_dtype=compute_dtype)
        flow, cert, cert16 = decode(params, pyr, _swap_halves(pyr, B),
                                    compute_dtype=decoder_dtype, corr_dtype=corr_dtype,
                                    with_cert16=True)
        if attenuate_cert and not with_cert16:
            cert = _attenuate(cert, cert16)
    if with_cert16:
        return flow[:B], cert[:B], flow[B:], cert[B:], cert16[:B], cert16[B:]
    return flow[:B], cert[:B], flow[B:], cert[B:]


@torch.no_grad()
def match_pair_upsample(params, imA_hr, imB_hr, flow_ab, cert_ab, flow_ba, cert_ba,
                        scale_factor: float = 1.0, compute_dtype: torch.dtype = torch.float32,
                        corr_dtype: Optional[torch.dtype] = None, cert16_ab=None,
                        cert16_ba=None):
    """The second refinement pass at the upsample resolution (H', W'
    multiples of 8): a VGG-only pyramid, scales 8..1 seeded by the coarse
    warp and certainty; with the coarse scale-16 certainties the final
    logits are attenuated."""
    B = imA_hr.shape[0]
    with full_f32():
        both = torch.cat([_as_float_images(imA_hr), _as_float_images(imB_hr)], dim=0)
        pyr = build_pyramid(params, both, use_dino=False)
        flow, cert = decode(params, pyr, _swap_halves(pyr, B), scales=["8", "4", "2", "1"],
                            flow=torch.cat([flow_ab, flow_ba], dim=0),
                            certainty=torch.cat([cert_ab, cert_ba], dim=0),
                            scale_factor=scale_factor, compute_dtype=compute_dtype,
                            corr_dtype=corr_dtype)
        if cert16_ab is not None:
            cert = _attenuate(cert, torch.cat([cert16_ab, cert16_ba], dim=0))
    return flow[:B], cert[:B], flow[B:], cert[B:]


def _top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores, ties broken by the lower index (as
    ``jax.lax.top_k``). Ties are common: Gumbel noise from 23-bit uniforms
    repeats values among ~1e6 draws, and the order of the candidates picks
    the KDE subset."""
    return torch.sort(scores, descending=True, stable=True).indices[:k]


def _gumbel(n: int, generator: torch.Generator, device) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(n, generator=generator, device=device).clamp_min(tiny)
    return -torch.log(-torch.log(u))


@torch.no_grad()
def sample_matches_device(warp_ab, cert_ab, warp_ba, cert_ba,
                          generator: Optional[torch.Generator] = None, num: int = 5000,
                          sample_thresh: float = 0.05,
                          draws: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None):
    """Threshold-balanced sampling of one pair on its device: certainties
    clamp to 1 above the threshold, 4 x ``num`` candidates are drawn by
    certainty without replacement (Gumbel top-k), then rebalanced by inverse
    KDE density. warp (H, W, 2), cert (H, W, 1) -> (matches (k, 4)
    normalized, certainty (k,)).

    The three draws (Gumbel noise over all 2HW positions, the KDE subset as
    indices of the candidates, Gumbel noise over the candidates) come from
    ``generator``, or from ``draws`` where a caller injects its own."""
    H, W = cert_ab.shape[:2]
    dev = cert_ab.device
    with full_f32():
        grid = _grid(H, W, dev)
        m_ab = torch.cat([grid, warp_ab], dim=-1).reshape(-1, 4)
        m_ba = torch.cat([warp_ba, grid], dim=-1).reshape(-1, 4)
        matches = torch.cat([m_ab, m_ba], dim=0)
        cert = torch.sigmoid(torch.cat([cert_ab.reshape(-1), cert_ba.reshape(-1)]))
        # out-of-range warps carry no mass; coordinates clamp to the image
        oob = (matches[:, 2:].abs() > 1).any(dim=1) | (matches[:, :2].abs() > 1).any(dim=1)
        cert = torch.where(oob, torch.zeros_like(cert), cert)
        matches = matches.clamp(-1.0, 1.0)
        cert_s = torch.where(cert > sample_thresh, torch.ones_like(cert), cert)
        n_cand = min(4 * num, cert_s.shape[0])
        n_sub = min(n_cand, 4000)
        if draws is None:
            g1 = _gumbel(cert_s.shape[0], generator, dev)
            sub_idx = torch.randperm(n_cand, generator=generator, device=dev)[:n_sub]
            g2 = _gumbel(n_cand, generator, dev)
        else:
            g1, sub_idx, g2 = (d.to(dev) for d in draws)
        cand = _top_k(torch.log(cert_s.clamp_min(1e-12)) + g1, n_cand)
        good = matches[cand]
        good_cert = cert_s[cand]
        sub = good[sub_idx.long()]
        d2 = (good ** 2).sum(-1)[:, None] + (sub ** 2).sum(-1)[None, :] - 2.0 * good @ sub.T
        density = torch.exp(-d2 / (2 * 0.1 ** 2)).sum(-1) * (n_cand / n_sub)
        p = 1.0 / (density + 1.0)
        p = torch.where(density < 10, torch.full_like(p, 1e-7), p)
        k = min(num, n_cand)
        sel = _top_k(torch.log(p.clamp_min(1e-12)) + g2, k)
    return good[sel], good_cert[sel]


def to_pixel_coordinates(matches: np.ndarray, H_A, W_A, H_B, W_B):
    kA = np.stack([W_A / 2 * (matches[:, 0] + 1), H_A / 2 * (matches[:, 1] + 1)], -1)
    kB = np.stack([W_B / 2 * (matches[:, 2] + 1), H_B / 2 * (matches[:, 3] + 1)], -1)
    return kA, kB
