"""Bidirectional shared-score cross attention for LightGlue (kernel 6).

``S = qk0 . qk1^T / sqrt(d)``, ``m0 = softmax_rows(S) . v1``,
``m1 = softmax_rows(S^T) . v0``, with padding masks entering as -1e30
biases on both sides of S. ``bidir_cross_attention`` launches the CUDA
kernel of ``csrc/bidir_attention.cu`` for CUDA tensors (its bf16 form, or
its float32 form in split TF32) and runs
``bidir_cross_attention_reference`` for CPU tensors. Layouts are the JAX
package's: (B, H, M, d) and (B, H, N, d) heads, (B, M) / (B, N) bool masks.
"""

from __future__ import annotations

import torch

from . import _lib

_NEG = -1e30


def bidir_cross_attention_reference(qk0, qk1, v0, v1, mask0, mask1):
    """Plain version, the JAX package's dense reference: f32 scores with
    masked rows and columns at -1e30, both softmaxes in f32, the
    probabilities cast to the value dtype, f32 accumulation, outputs in the
    input dtype."""
    d = qk0.shape[-1]
    neg = torch.tensor(_NEG)
    s = torch.einsum("bhid,bhjd->bhij", qk0.float(), qk1.float()) * d ** -0.5
    s01 = torch.where(mask1[:, None, None, :], s, neg)
    s01 = torch.where(mask0[:, None, :, None], s01, neg)
    a01 = torch.softmax(s01, -1).to(v1.dtype)
    m0 = torch.einsum("bhij,bhjd->bhid", a01.float(), v1.float())
    a10 = torch.softmax(s01.transpose(2, 3), -1).to(v0.dtype)
    m1 = torch.einsum("bhnm,bhmd->bhnd", a10.float(), v0.float())
    return m0.to(qk0.dtype), m1.to(qk0.dtype)


def bidir_cross_attention(qk0, qk1, v0, v1, mask0, mask1):
    """(B, H, M, d) x (B, H, N, d) -> (m0 (B, H, M, d), m1 (B, H, N, d)).

    Rows of masked tokens are undefined (the kernel averages the other
    side's valid tokens there, the dense reference all of them): compare
    valid rows only. On CUDA the kernel takes qk0, qk1, v0 and v1 all in
    bf16 or all in f32 (its split-TF32 form), d = 64, contiguous tensors and
    raises otherwise; any M and N work (the kernel masks the ragged tiles).
    """
    if not qk0.is_cuda:
        return bidir_cross_attention_reference(qk0, qk1, v0, v1, mask0, mask1)
    B, H, M, d = qk0.shape
    N = qk1.shape[2]
    if d != 64:
        raise ValueError(f"bidir attention kernel takes head dim 64, got {d}")
    dev = qk0.device
    dt = _lib.kernel_dtype("bidir attention", qk0, qk1, v0, v1)
    for name, t, shape in (("qk0", qk0, (B, H, M, d)), ("qk1", qk1, (B, H, N, d)),
                           ("v0", v0, (B, H, M, d)), ("v1", v1, (B, H, N, d))):
        _lib.check_cuda(name, t, dt, shape, dev)
    _lib.check_cuda("mask0", mask0, torch.bool, (B, M), dev, align=1)
    _lib.check_cuda("mask1", mask1, torch.bool, (B, N), dev, align=1)
    o0, o1 = torch.empty_like(qk0), torch.empty_like(qk1)
    if B * H == 0 or M + N == 0:
        return o0, o1
    args = (qk0.data_ptr(), qk1.data_ptr(), v0.data_ptr(), v1.data_ptr(), mask0.data_ptr(),
            mask1.data_ptr(), o0.data_ptr(), o1.data_ptr())
    kernel, fn = (("bidir_attention", "dim_bidir_attention_bf16") if dt == torch.bfloat16
                  else ("bidir_attention_f32", "dim_bidir_attention_f32"))
    _lib.launch(kernel, fn, dev.index, *args, B, H, M, N, float(d ** -0.5), _lib.stream_of(qk0))
    return o0, o1
