"""Masked multi-head attention for the matching transformer (kernel 1).

``fused_attention`` launches the CUDA kernel of ``csrc/attention.cu`` for
CUDA tensors and runs ``attention_reference`` for CPU tensors. The kernel
replaces the JAX package's Pallas flash attention
(``deep_image_matching_tpu/ops/attention.py::fused_attention``) in four
forms, bf16 and float32 (split TF32), each at head dims 64 and 96, all on
the ``wgmma`` / TMA cores of ``csrc/attention_sm90.cuh`` (bf16) and
``csrc/attention_f32_sm90.cuh`` (float32): 192 (bf16) or 128 (float32) query
rows a block, key tiles fed by TMA, both products on ``wgmma``. They are
bound by tensor-core operations (at LighterGlue's (16, 1, 4096, 96) ~100
GFLOP against 50 MB); at head dim 96 an earlier ``mma.sync`` form took 64
rows a block and so read each (batch, head)'s keys and values from L2 three
times as often, at 15 % of that bound. Layouts are the JAX package's:
(B, H, T, hd) heads, (B, T) bool padding masks.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _lib

# the head dims of the CUDA kernel: 64, and 96 (LighterGlue's one head of
# width 96) on the same cores in 64-byte swizzled tiles (bf16) or three
# 32-float boxes a row (float32)
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
    hd96 = "_hd96" if hd == 96 else ""
    kernel, fn = ((f"attention{hd96}", f"dim_attention{hd96}_bf16") if dt == torch.bfloat16
                  else (f"attention{hd96}_f32", f"dim_attention{hd96}_f32"))
    _lib.launch(
        kernel, fn, q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), *masks,
        out.data_ptr(), B, H, Tq, Tk, float(sm_scale), _lib.stream_of(q),
    )
    return out
