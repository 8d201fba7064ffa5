"""Fused feed-forward block of the matching transformers (kernel 2).

``x + W2 . act([x | msg] . W1^T + b1) + b2`` on (B, K, D) inputs, where act
is ``GELU(LN(h) * g + beta)`` in mode "ln_gelu" (LightGlue) and ``relu(h)``
in mode "relu" (SuperGlue's propagation MLP, BatchNorm folded into W1; g and
beta are ignored). ``ffn_fused`` launches the CUDA kernel of ``csrc/ffn.cu``
for CUDA tensors and runs ``ffn_reference`` for CPU tensors. Weights are in
``nn.Linear`` (out, in) layout: ``w1`` (2D, 2D), ``w2`` (D, 2D).
"""

from __future__ import annotations

import torch

from . import _lib

_MODES = {"ln_gelu": 0, "relu": 1}


def ffn_reference(x, msg, w1, b1, g, beta, w2, b2, mode: str = "ln_gelu") -> torch.Tensor:
    """Plain version with the Pallas kernel's numerics: products accumulate
    in f32, LayerNorm statistics (eps 1e-5) and the exact-erf GELU (or the
    relu) run in f32, the activation is cast to ``x.dtype`` before the second
    product and the residual is added in f32."""
    if mode not in _MODES:
        raise ValueError(f"FFN mode {mode!r}; expected one of {sorted(_MODES)}")
    f32 = torch.float32
    cat = torch.cat([x, msg.to(x.dtype)], dim=-1).to(f32)
    h = cat @ w1.to(f32).T + b1.to(f32)
    if mode == "relu":
        act = torch.relu(h)
    else:
        mu = h.mean(-1, keepdim=True)
        hc = h - mu
        var = (hc * hc).mean(-1, keepdim=True)
        hn = hc * torch.rsqrt(var + 1e-5) * g.to(f32) + beta.to(f32)
        act = 0.5 * hn * (1.0 + torch.erf(hn * 0.7071067811865476))
    y = act.to(x.dtype).to(f32) @ w2.to(f32).T
    return (x.to(f32) + (y + b2.to(f32))).to(x.dtype)


def ffn_fused(x, msg, w1, b1, g, beta, w2, b2, mode: str = "ln_gelu") -> torch.Tensor:
    """Fused FFN; on CUDA the kernel takes bf16 everywhere and D = 256 and
    raises otherwise. Any row count works: the kernel masks the last tile.
    In mode "relu", ``g`` and ``beta`` are not read and may be None."""
    if mode not in _MODES:
        raise ValueError(f"FFN mode {mode!r}; expected one of {sorted(_MODES)}")
    if not x.is_cuda:
        return ffn_reference(x, msg, w1, b1, g, beta, w2, b2, mode)
    B, K, D = x.shape
    if D != 256:
        raise ValueError(f"FFN kernel takes width 256, got {D}")
    dev = x.device
    bf16 = torch.bfloat16
    checks = [("x", x, (B, K, D)), ("msg", msg, (B, K, D)), ("w1", w1, (2 * D, 2 * D)),
              ("b1", b1, (2 * D,)), ("w2", w2, (D, 2 * D)), ("b2", b2, (D,))]
    if mode == "ln_gelu":
        checks += [("g", g, (2 * D,)), ("beta", beta, (2 * D,))]
    for name, t, shape in checks:
        _lib.check_cuda(name, t, bf16, shape, dev)
    out = torch.empty_like(x)
    _lib.launch(
        "ffn", "dim_ffn_bf16", dev.index, x.data_ptr(), msg.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), None if mode == "relu" else g.data_ptr(),
        None if mode == "relu" else beta.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), B * K, _MODES[mode], _lib.stream_of(x),
    )
    return out
