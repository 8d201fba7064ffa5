"""DINOv2 ViT backbone (port of ``deep_image_matching_tpu/models/dinov2.py``).

RoMa's coarse encoder: ViT-L/14 (width 1024, 24 blocks, 16 heads, MLP 4x,
LayerScale), a convolutional patch embedding, a cls token, learned position
embeddings interpolated bicubically to the input grid, pre-norm blocks and a
final LayerNorm; ``forward_features`` returns the normalized patch tokens.

Parameters are a dict of tensors in torch layouts: ``patch_embed`` (1024, 3,
14, 14) and bias, ``cls_token``, ``pos_embed``, ``blocks`` (a list of
``ln1``, ``qkv``, ``proj``, ``ls1``, ``ln2``, ``fc1``, ``fc2``, ``ls2``; linear
weights as ``nn.Linear`` (out, in)) and ``norm``. ``convert.py`` fills them
from the JAX package's parameters or from ``dinov2_vitl14_pretrain.pth``.

The blocks run in ``compute_dtype`` (bf16 by default) with f32 accumulation,
and their attention goes through ``ops/attention.py::fused_attention``: on
CUDA the attention kernel (bf16, head dim 64; the 1601 tokens of a 560-px
image are a ragged length the kernel masks itself, so nothing is padded), on
the CPU its plain version, the JAX package's dense route.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import fused_attention

VIT_L = {"dim": 1024, "depth": 24, "heads": 16, "mlp_ratio": 4, "patch": 14}


def init_tree(cfg=VIT_L, depth: int = 2) -> Dict:
    """The JAX package's random init recipe (``init_params``: a shallow
    stack for tests and weightless runs), in its layouts, as numpy: the same
    draws from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    d, p = cfg["dim"], cfg["patch"]

    def lin(ci, co):
        return {"w": rng.normal(0, 1 / np.sqrt(ci), (ci, co)).astype(np.float32),
                "b": np.zeros((co,), np.float32)}

    def ln():
        return {"g": np.ones((d,), np.float32), "b": np.zeros((d,), np.float32)}

    blocks = [
        {"ln1": ln(), "qkv": lin(d, 3 * d), "proj": lin(d, d),
         "ls1": np.full((d,), 1.0, np.float32), "ln2": ln(),
         "fc1": lin(d, cfg["mlp_ratio"] * d), "fc2": lin(cfg["mlp_ratio"] * d, d),
         "ls2": np.full((d,), 1.0, np.float32)}
        for _ in range(depth)
    ]
    n_pos = (518 // p) ** 2 + 1
    return {
        "patch_embed": {"w": rng.normal(0, 0.02, (p, p, 3, d)).astype(np.float32),
                        "b": np.zeros((d,), np.float32)},
        "cls_token": np.zeros((1, 1, d), np.float32),
        "pos_embed": rng.normal(0, 0.02, (1, n_pos, d)).astype(np.float32),
        "blocks": blocks,
        "norm": ln(),
    }


def cast(tree, dtype: torch.dtype):
    """``tree`` with every floating tensor in ``dtype`` (a tensor already in
    it is passed through, not copied)."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast(v, dtype) for v in tree]
    return tree.to(dtype) if torch.is_floating_point(tree) else tree


def prepare(params: Dict, dtype: torch.dtype) -> Dict:
    """The parameters with the patch embedding and the blocks in the compute
    dtype, as ``forward_features`` uses them; cast once by a caller that
    runs many forwards (position embeddings, cls token and final norm stay
    f32, as in the JAX package)."""
    return {**params, "patch_embed": cast(params["patch_embed"], dtype),
            "blocks": cast(params["blocks"], dtype)}


def ln(x: torch.Tensor, p: Dict, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm in f32, the result in x's dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * p["g"].float() + p["b"].float()).to(x.dtype)


def lin(x: torch.Tensor, p: Dict) -> torch.Tensor:
    """x @ w.T + b with f32 accumulation and the bias added in f32, the
    result in x's dtype (the JAX package's einsum with
    ``preferred_element_type=f32``). bf16 runs on the card's tensor cores;
    on the CPU it is computed in f32 from the bf16 values."""
    w, b = p["w"], p.get("b")
    if x.dtype == torch.float32 or x.is_cuda:
        return F.linear(x, w, b)
    return F.linear(x.float(), w.float(), None if b is None else b.float()).to(x.dtype)


def _torch_bicubic_matrix(n_in: int, n_out: int, scale: float) -> np.ndarray:
    """Dense (n_out, n_in) matrix of ``F.interpolate(mode='bicubic',
    align_corners=False)`` with the caller's scale factor: cubic convolution
    with A = -0.75, source coordinate ``(dst + 0.5) / scale - 0.5`` and
    edge-replicated taps (DINOv2 passes ``(w0 + 0.1) / sqrt(N)``)."""
    A = -0.75

    def k0(x):  # |x| <= 1
        return ((A + 2.0) * x - (A + 3.0)) * x * x + 1.0

    def k1(x):  # 1 < |x| < 2
        return ((A * x - 5.0 * A) * x + 8.0 * A) * x - 4.0 * A

    W = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        src = (i + 0.5) / scale - 0.5
        i0 = int(np.floor(src))
        t = src - i0
        for tap, wt in zip(range(i0 - 1, i0 + 3), (k1(1.0 + t), k0(t), k0(1.0 - t), k1(2.0 - t))):
            W[i, min(max(tap, 0), n_in - 1)] += wt
    return W.astype(np.float32)


def interp_pos_embed(pos_embed: torch.Tensor, hp: int, wp: int):
    """(cls position embedding (1, 1, D), patch position embeddings
    (1, hp * wp, D)): the patch grid interpolated bicubically to (hp, wp) as
    the reference's torch path does it."""
    n = pos_embed.shape[1] - 1
    side = int(round(float(np.sqrt(n))))
    cls_pe = pos_embed[:, :1]
    patch_pe = pos_embed[:, 1:].reshape(1, side, side, -1)
    if (hp, wp) != (side, side):
        # the reference swaps w and h in its scale factor; for the square
        # grids used here they coincide
        dev = pos_embed.device
        Wy = torch.from_numpy(_torch_bicubic_matrix(side, hp, (hp + 0.1) / side)).to(dev)
        Wx = torch.from_numpy(_torch_bicubic_matrix(side, wp, (wp + 0.1) / side)).to(dev)
        patch_pe = torch.einsum("oy,byxd->boxd", Wy, patch_pe)
        patch_pe = torch.einsum("ox,byxd->byod", Wx, patch_pe)
    return cls_pe, patch_pe.reshape(1, hp * wp, -1)


def _patch_embed(images: torch.Tensor, p: Dict, patch: int) -> torch.Tensor:
    """Stride-``patch`` convolution of NHWC images, rounded to the images'
    dtype, then the bias added in that dtype (the JAX package's order)."""
    x = images.permute(0, 3, 1, 2)
    w = p["w"].to(images.dtype)
    if images.dtype != torch.float32 and not images.is_cuda:
        y = F.conv2d(x.float(), w.float(), stride=patch).to(images.dtype)
    else:
        y = F.conv2d(x, w, stride=patch)
    return y.permute(0, 2, 3, 1) + p["b"].to(images.dtype)


def _block(x: torch.Tensor, bp: Dict, num_heads: int) -> torch.Tensor:
    B, S, D = x.shape
    hd = D // num_heads
    h = ln(x, bp["ln1"])
    qkv = lin(h, bp["qkv"]).reshape(B, S, 3, num_heads, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))
    out = fused_attention(q, k, v, None, None, hd ** -0.5).to(x.dtype)
    out = out.transpose(1, 2).reshape(B, S, D)
    x = x + lin(out, bp["proj"]) * bp["ls1"]
    h = lin(ln(x, bp["ln2"]), bp["fc1"])
    h = F.gelu(h.float()).to(x.dtype)
    return x + lin(h, bp["fc2"]) * bp["ls2"]


@torch.no_grad()
def forward_features(params: Dict, images: torch.Tensor, num_heads: int = 16,
                     compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """images (B, H, W, 3), ImageNet-normalized, H and W multiples of the
    patch size -> normalized patch tokens (B, H/p * W/p, dim) in f32."""
    cdt = compute_dtype
    patch = params["patch_embed"]["w"].shape[-1]
    B, H, W, _ = images.shape
    hp, wp = H // patch, W // patch
    x = _patch_embed(images.to(cdt), params["patch_embed"], patch).reshape(B, hp * wp, -1)
    cls_pe, patch_pe = interp_pos_embed(params["pos_embed"], hp, wp)
    cls_tok = (params["cls_token"] + cls_pe).to(cdt)
    x = torch.cat([cls_tok.expand(B, -1, -1), x + patch_pe.to(cdt)], dim=1)
    for bp in params["blocks"]:
        x = _block(x, cast(bp, cdt), num_heads)
    x = ln(x, params["norm"])
    return x[:, 1:].float()
