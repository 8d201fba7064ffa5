"""LightGlue's attention prologue in one kernel (kernel 10).

``proj_rotary_fused`` computes ``y = x . W^T + b`` (f32 accumulation, the
bias added in f32), splits y into ``n_sections`` D-wide sections, unpacks
each into (B, H, N, hd) heads and applies the rotary embedding to the
sections in ``rot``: ``t * cos + rotate_half(y) * sin`` in the compute
dtype, with t, cos, sin and rotate_half(y) rounded to it. It launches the
CUDA kernel of ``csrc/qkv.cu`` for CUDA tensors (its bf16 form, or its
float32 form in split TF32, whose weight comes split into TF32 halves once
per model: ``weights_tf32``) and runs ``proj_rotary_reference`` for CPU
tensors.

The weight is in ``nn.Linear`` (out, in) layout with section-contiguous
output rows. ``qkv_weights`` permutes the self block's fused ``Wqkv`` (output
rows ordered (head, hd, 3), the torch layout) into ``[q | k | v]`` sections
once; ``qk_v_weights`` stacks the cross block's two projections. Callers
build both once per model and dtype (``models/lightglue.py``).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from . import _lib


@functools.lru_cache(maxsize=8)
def _qkv_perm(D: int, num_heads: int) -> np.ndarray:
    """Row permutation torch-interleaved -> section-contiguous: new row
    ``c*D + h*hd + d`` takes old row ``(h*hd + d)*3 + c``."""
    hd = D // num_heads
    c, h, d = np.meshgrid(np.arange(3), np.arange(num_heads), np.arange(hd), indexing="ij")
    perm = ((h * hd + d) * 3 + c).reshape(-1)
    perm.setflags(write=False)
    return perm


def qkv_weights(w: torch.Tensor, b: torch.Tensor, num_heads: int):
    """The self block's ``Wqkv`` (3D, D) and bias (3D,) with rows permuted
    into ``[q | k | v]`` sections, each ordered (head, hd)."""
    perm = torch.tensor(_qkv_perm(w.shape[1], num_heads), device=w.device)
    return w[perm].contiguous(), b[perm].contiguous()


def qk_v_weights(w_qk, b_qk, w_v, b_v):
    """The cross block's ``to_qk`` and ``to_v`` stacked into one (2D, D)
    projection with its (2D,) bias."""
    return torch.cat([w_qk, w_v]).contiguous(), torch.cat([b_qk, b_v]).contiguous()


def weights_tf32(w: torch.Tensor) -> torch.Tensor:
    """The TF32 halves (hi, then lo) of a section-contiguous weight, (2,
    n_sections*D, D), as the float32 kernel takes them; callers make them once
    per model and dtype (``models/lightglue.py``)."""
    return _lib.tf32_split(w)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """out[2i] = -x[2i+1], out[2i+1] = x[2i] along the last axis."""
    x = x.unflatten(-1, (-1, 2))
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).flatten(-2)


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, N, D = t.shape
    return t.reshape(B, N, num_heads, D // num_heads).transpose(1, 2).contiguous()


def proj_rotary_reference(x, w, b, cos, sin, num_heads: int, n_sections: int = 3,
                          rot: Sequence[int] = (0, 1)) -> Tuple[torch.Tensor, ...]:
    """Plain version with the kernel's numerics: f32 product plus the f32
    bias, rounded to ``x.dtype`` (t); on rotary sections ``t * cos +
    rotate_half(y) * sin`` in ``x.dtype``, each product and the sum rounded
    (the Pallas kernel's bf16 arithmetic)."""
    f32 = torch.float32
    D = x.shape[-1]
    y = x.to(f32) @ w.to(f32).T + b.to(f32)
    outs = []
    for s in range(n_sections):
        ys = _heads(y[..., s * D:(s + 1) * D], num_heads)
        t = ys.to(x.dtype)
        if s in rot:
            c = cos.to(x.dtype)[:, None]
            sn = sin.to(x.dtype)[:, None]
            t = t * c + rotate_half(ys).to(x.dtype) * sn
        outs.append(t)
    return tuple(outs)


def proj_rotary_fused(x, w, b, cos, sin, num_heads: int, n_sections: int = 3,
                      rot: Sequence[int] = (0, 1), split=None) -> Tuple[torch.Tensor, ...]:
    """x (B, N, D); w (n_sections*D, D) section-contiguous rows; b
    (n_sections*D,); cos, sin (B, N, hd), f32 or already rounded to
    ``x.dtype`` as the rotary rounds them (ignored, and may be None, when
    ``rot`` is empty). Returns ``n_sections`` (B, H, N, hd) tensors in
    ``x.dtype``. On CUDA the kernel takes x, w and b all in bf16 or all in
    f32 (its split-TF32 form, with f32 cos and sin), D = 256, hd = 64 and
    raises otherwise; any row count works. ``split``: ``weights_tf32(w)``,
    which the f32 kernel reads; made here when not given."""
    rot = tuple(rot)
    if not x.is_cuda:
        return proj_rotary_reference(x, w, b, cos, sin, num_heads, n_sections, rot)
    B, N, D = x.shape
    if D != 256 or num_heads != 4:
        raise ValueError(f"qkv kernel takes width 256 and 4 heads, got {D} and {num_heads}")
    if n_sections not in (2, 3) or any(s not in range(n_sections) for s in rot):
        raise ValueError(f"qkv kernel: {n_sections} sections with rotary on {rot}")
    dev = x.device
    dt = _lib.kernel_dtype("qkv", x, w, b)
    _lib.check_cuda("x", x, dt, (B, N, D), dev)
    _lib.check_cuda("w", w, dt, (n_sections * D, D), dev)
    _lib.check_cuda("b", b, dt, (n_sections * D,), dev)
    if dt == torch.float32:
        w = weights_tf32(w) if split is None else split
        _lib.check_cuda("w halves", w, dt, (2, n_sections * D, D), dev)
    if rot:
        # the bf16 kernel reads them in bf16, which the rotary rounds them
        # to; the f32 kernel reads them as they are
        cos, sin = cos.to(dt), sin.to(dt)
        _lib.check_cuda("cos", cos, dt, (B, N, 64), dev)
        _lib.check_cuda("sin", sin, dt, (B, N, 64), dev)
    outs = [torch.empty(B, num_heads, N, 64, dtype=dt, device=dev) for _ in range(n_sections)]
    if B * N == 0:
        return tuple(outs)
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - n_sections)
    kernel, entry = (("qkv", "dim_qkv_rotary_bf16") if dt == torch.bfloat16
                     else ("qkv_f32", "dim_qkv_rotary_f32"))
    _lib.launch(
        kernel, entry, dev.index, x.data_ptr(), w.data_ptr(), b.data_ptr(),
        cos.data_ptr() if rot else None, sin.data_ptr() if rot else None, *ptrs,
        B * N, N, n_sections, sum(1 << s for s in rot), _lib.stream_of(x),
    )
    return tuple(outs)


def qkv_rotary_fused(x, w, b, cos, sin, num_heads: int, split=None):
    """Self-block prologue: (q, k, v), each (B, H, N, hd), rotary on q and
    k; ``w``, ``b`` from ``qkv_weights``, ``split`` from ``weights_tf32``."""
    return proj_rotary_fused(x, w, b, cos, sin, num_heads, n_sections=3, rot=(0, 1),
                             split=split)


def qk_v_fused(x, w, b, num_heads: int, split=None):
    """Cross-block prologue: (qk, v), each (B, H, N, hd), no rotary; ``w``,
    ``b`` from ``qk_v_weights``, ``split`` from ``weights_tf32``."""
    return proj_rotary_fused(x, w, b, None, None, num_heads, n_sections=2, rot=(),
                             split=split)
