"""The device the models, matching and device RANSAC run on, and the
precision of f32 arithmetic on it."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(spec=None) -> torch.device:
    """``general.tpu.device``: "auto" (or None) picks the first CUDA device
    when one is present, else the CPU; "cuda" or "cpu" (or "cuda:N")
    requests one. A requested CUDA device that is missing raises: the run
    never moves to the CPU behind the user's back."""
    if spec is None or str(spec).lower() == "auto":
        return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    dev = torch.device(spec)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device '{spec}' requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return dev


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
