"""Masked multi-head attention for the matching transformer (kernel 1).

``fused_attention`` launches the CUDA kernel of ``csrc/attention.cu`` for
CUDA tensors (its bf16 form, or its float32 form in split TF32; at head dim
64 the ``wgmma`` core, at head dim 96, LighterGlue's, the ``mma.sync`` form
``attention_mma``) and runs ``attention_reference`` for CPU tensors. Layouts are
the JAX package's: (B, H, T, hd) heads, (B, T) bool padding masks.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _lib

# the head dims of the CUDA kernel: 64 on the wgmma core, 96 (LighterGlue's one
# head of width 96) on the mma.sync form
HEAD_DIMS = (64, 96)


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    sm_scale: float,
) -> torch.Tensor:
    """Plain version, the numerics of the JAX package's ``xla_attention``:
    f32 scores, masked keys at -1e30, f32 softmax cast to ``v.dtype``, f32
    accumulation of the weighted values, output in ``v.dtype``."""
    sim = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * sm_scale
    if key_mask is not None:
        sim = torch.where(key_mask[:, None, None, :], sim, sim.new_tensor(-1e30))
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    out = torch.einsum("bhij,bhjd->bhid", attn.float(), v.float())
    return out.to(v.dtype)


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_mask: Optional[torch.Tensor],
    kv_mask: Optional[torch.Tensor],
    sm_scale: float,
) -> torch.Tensor:
    """(B, H, Tq, hd) x (B, H, Tk, hd) attention with padding masks.

    Rows of masked queries are undefined (the JAX package's flash route and
    its dense route disagree there too): compare valid rows only. On CUDA the
    kernel takes q, k and v all in bf16 or all in f32 (its split-TF32 form),
    hd = 64 or 96, contiguous tensors and raises otherwise.
    """
    if not q.is_cuda:
        return attention_reference(q, k, v, kv_mask, sm_scale)
    B, H, Tq, hd = q.shape
    Tk = k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"attention kernel takes head dim 64 or 96, got {hd}")
    dt = _lib.kernel_dtype("attention", q, k, v)
    for name, t, shape in (("q", q, (B, H, Tq, hd)), ("k", k, (B, H, Tk, hd)),
                           ("v", v, (B, H, Tk, hd))):
        _lib.check_cuda(name, t, dt, shape, q.device)
    for name, m, n in (("q_mask", q_mask, Tq), ("kv_mask", kv_mask, Tk)):
        if m is not None:
            _lib.check_cuda(name, m, torch.bool, (B, n), q.device, align=1)
    out = torch.empty_like(q)
    masks = (None if q_mask is None else q_mask.data_ptr(),
             None if kv_mask is None else kv_mask.data_ptr())
    if hd == 96:
        form = "bf16" if dt == torch.bfloat16 else "f32"
        _lib.launch(
            "attention_hd96" if dt == torch.bfloat16 else "attention_hd96_f32",
            f"dim_attention_hd96_{form}", q.device.index, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), *masks, out.data_ptr(), B, H, Tq, Tk, float(sm_scale),
            _lib.stream_of(q),
        )
        return out
    if dt == torch.bfloat16:
        _lib.launch(
            "attention", "dim_attention_bf16", q.device.index, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), *masks,
            out.data_ptr(), B, H, Tq, Tk, float(sm_scale), _lib.stream_of(q),
        )
        return out
    # the split pass's scratch: Q's and K's TF32 halves, V's transposed
    # halves with the keys rounded up to 8
    qs = torch.empty((2,) + q.shape, dtype=dt, device=q.device)
    ks = torch.empty((2,) + k.shape, dtype=dt, device=q.device)
    vs = torch.empty(2, B * H, hd, -(-Tk // 8) * 8, dtype=dt, device=q.device)
    _lib.launch(
        "attention_f32", "dim_attention_f32", q.device.index, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), *masks, out.data_ptr(), qs.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), B, H, Tq, Tk, float(sm_scale), _lib.stream_of(q),
    )
    return out
