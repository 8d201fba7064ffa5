"""Fused feed-forward block of the matching transformers (kernel 2).

``x + W2 . act([x | msg] . W1^T + b1) + b2`` on (B, K, D) inputs, where act
is ``GELU(LN(h) * g + beta)`` in mode "ln_gelu" (LightGlue) and ``relu(h)``
in mode "relu" (SuperGlue's propagation MLP, BatchNorm folded into W1; g and
beta are ignored). ``ffn_fused`` launches the CUDA kernel of ``csrc/ffn.cu``
for CUDA tensors (its bf16 form, or its float32 form in split TF32, whose
weights come split into TF32 halves once per model: ``ffn_weights_tf32``)
and runs ``ffn_reference`` for CPU tensors. Weights are in
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


def ffn_xla(x, msg, w1, b1, g, beta, w2, b2) -> torch.Tensor:
    """LightGlue's unfused FFN, the arithmetic of the JAX package's "xla"
    route (``models/lightglue.py::_ffn``), which runs outside any Pallas
    kernel: each product accumulates in f32 and is rounded to ``x.dtype``,
    and so is each bias add; LayerNorm and the exact-erf GELU run in f32,
    the activation is rounded to ``x.dtype``, and the residual is added in
    ``x.dtype``. Plain tensor operations on every device."""
    dt, f32 = x.dtype, torch.float32
    cat = torch.cat([x, msg.to(dt)], dim=-1)
    h = (cat.to(f32) @ w1.to(f32).T).to(dt) + b1.to(dt)
    h32 = h.to(f32)
    mu = h32.mean(-1, keepdim=True)
    var = ((h32 - mu) ** 2).mean(-1, keepdim=True)
    hn = (h32 - mu) * torch.rsqrt(var + 1e-5) * g.to(f32) + beta.to(f32)
    act = torch.nn.functional.gelu(hn).to(dt)
    y = (act.to(f32) @ w2.to(f32).T).to(dt) + b2.to(dt)
    return x + y


def ffn_weights_tf32(w1, w2):
    """The TF32 halves (hi, then lo) of both weights, (2, 2D, 2D) and
    (2, D, 2D), as the float32 kernel takes them: made once per model and
    dtype by the callers (``models/lightglue.py``, ``models/superglue.py``)."""
    return _lib.tf32_split(w1), _lib.tf32_split(w2)


def ffn_fused(x, msg, w1, b1, g, beta, w2, b2, mode: str = "ln_gelu",
              split=None) -> torch.Tensor:
    """Fused FFN; on CUDA the kernel takes every tensor in bf16, or every one
    in f32 (its split-TF32 form), D = 256, and raises otherwise. Any row
    count works: the kernel masks the last tile. In mode "relu", ``g`` and
    ``beta`` are not read and may be None. ``split``: ``ffn_weights_tf32(w1,
    w2)``, which the f32 kernel reads; made here when not given."""
    if mode not in _MODES:
        raise ValueError(f"FFN mode {mode!r}; expected one of {sorted(_MODES)}")
    if not x.is_cuda:
        return ffn_reference(x, msg, w1, b1, g, beta, w2, b2, mode)
    B, K, D = x.shape
    if D != 256:
        raise ValueError(f"FFN kernel takes width 256, got {D}")
    dev = x.device
    checks = [("x", x, (B, K, D)), ("msg", msg, (B, K, D)), ("w1", w1, (2 * D, 2 * D)),
              ("b1", b1, (2 * D,)), ("w2", w2, (D, 2 * D)), ("b2", b2, (D,))]
    if mode == "ln_gelu":
        checks += [("g", g, (2 * D,)), ("beta", beta, (2 * D,))]
    dt = _lib.kernel_dtype("FFN", *(t for _, t, _ in checks))
    if dt == torch.float32:
        w1, w2 = ffn_weights_tf32(w1, w2) if split is None else split
        checks[2] = ("w1 halves", w1, (2, 2 * D, 2 * D))
        checks[4] = ("w2 halves", w2, (2, D, 2 * D))
    for name, t, shape in checks:
        _lib.check_cuda(name, t, dt, shape, dev)
    out = torch.empty_like(x)
    kernel, entry = ("ffn", "dim_ffn_bf16") if dt == torch.bfloat16 else ("ffn_f32", "dim_ffn_f32")
    _lib.launch(
        kernel, entry, dev.index, x.data_ptr(), msg.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), None if mode == "relu" else g.data_ptr(),
        None if mode == "relu" else beta.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), B * K, _MODES[mode], _lib.stream_of(x),
    )
    return out
