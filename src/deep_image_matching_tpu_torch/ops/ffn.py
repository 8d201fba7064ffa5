"""Fused LightGlue feed-forward block (kernel 2).

``x + W2 . GELU(LN([x | msg] . W1^T + b1) * g + beta) + b2`` on (B, K, D)
inputs. ``ffn_fused`` launches the CUDA kernel of ``csrc/ffn.cu`` for CUDA
tensors and runs ``ffn_reference`` for CPU tensors. Weights are in
``nn.Linear`` (out, in) layout: ``w1`` (2D, 2D), ``w2`` (D, 2D).
"""

from __future__ import annotations

import torch

from . import _lib


def ffn_reference(x, msg, w1, b1, g, beta, w2, b2) -> torch.Tensor:
    """Plain version with the Pallas kernel's numerics: products accumulate
    in f32, LayerNorm statistics (eps 1e-5) and the exact-erf GELU run in
    f32, the activation is cast to ``x.dtype`` before the second product and
    the residual is added in f32."""
    f32 = torch.float32
    cat = torch.cat([x, msg.to(x.dtype)], dim=-1).to(f32)
    h = cat @ w1.to(f32).T + b1.to(f32)
    mu = h.mean(-1, keepdim=True)
    hc = h - mu
    var = (hc * hc).mean(-1, keepdim=True)
    hn = hc * torch.rsqrt(var + 1e-5) * g.to(f32) + beta.to(f32)
    act = 0.5 * hn * (1.0 + torch.erf(hn * 0.7071067811865476))
    y = act.to(x.dtype).to(f32) @ w2.to(f32).T
    return (x.to(f32) + (y + b2.to(f32))).to(x.dtype)


def ffn_fused(x, msg, w1, b1, g, beta, w2, b2) -> torch.Tensor:
    """Fused FFN; on CUDA the kernel takes bf16 everywhere and D = 256 and
    raises otherwise. Any row count works: the kernel masks the last tile."""
    if not x.is_cuda:
        return ffn_reference(x, msg, w1, b1, g, beta, w2, b2)
    B, K, D = x.shape
    if D != 256:
        raise ValueError(f"FFN kernel takes width 256, got {D}")
    dev = x.device
    bf16 = torch.bfloat16
    for name, t, shape in (
        ("x", x, (B, K, D)), ("msg", msg, (B, K, D)), ("w1", w1, (2 * D, 2 * D)),
        ("b1", b1, (2 * D,)), ("g", g, (2 * D,)), ("beta", beta, (2 * D,)),
        ("w2", w2, (D, 2 * D)), ("b2", b2, (D,)),
    ):
        _lib.check_cuda(name, t, bf16, shape, dev)
    out = torch.empty_like(x)
    _lib.launch(
        "ffn", "dim_ffn_bf16", dev.index, x.data_ptr(), msg.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), g.data_ptr(), beta.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), B * K, _lib.stream_of(x),
    )
    return out
