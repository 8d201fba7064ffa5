"""The device the models, matching and device RANSAC run on, and the
precision of f32 arithmetic on it."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(spec=None) -> torch.device:
    """``general.tpu.device``: "auto" (the default, or None) is the first
    CUDA device, as are "cuda" and "cuda:N"; "cpu" asks for the CPU. A CUDA
    device that is missing raises: the run never moves to the CPU behind the
    user's back, and the CPU is only ever taken when asked for."""
    auto = spec is None or str(spec).lower() == "auto"
    dev = torch.device("cuda" if auto else spec)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device '{spec or 'auto'}' needs CUDA, which is not available; set "
                "`general.tpu.device: cpu` to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return dev


def check_matcher_dtype(device: torch.device, dtype: torch.dtype) -> torch.dtype:
    """``tpu.dtype`` of a transformer matcher. On CUDA the attention, FFN,
    bidirectional attention and QKV prologue kernels (kernels 1, 2, 6 and 10)
    have a bfloat16 and a float32 form, and a CUDA tensor never falls back to
    a plain version, so any other dtype raises there at start; the CPU runs
    every dtype."""
    if device.type == "cuda" and dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(
            f"tpu.dtype {dtype} on CUDA: the attention and FFN kernels take bfloat16 or "
            "float32; use tpu.dtype: bfloat16 or float32, or run in another dtype on the "
            "CPU with `general.tpu.device: cpu`")
    return dtype


@contextlib.contextmanager
def full_f32():
    """f32 convolutions and matrix products in full f32 inside the block:
    cuDNN runs f32 convolutions in TF32 by default (about three decimal
    digits), which the coarse-to-fine loops of the dense matchers would
    carry from scale to scale. The previous settings are restored after."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm
