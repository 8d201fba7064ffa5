"""The precisions the references compute in.

``exact`` leaves a tensor as it is (float32 with TF32 off: the reference).
``fp8`` rounds it to float8 e4m3 under a per-tensor scale that maps its
largest magnitude to the format's largest value, 448, and back to float32:
a product whose inputs went through it computes as an fp8 product with
float32 accumulation does. The controls run the references with ``fp8``,
the precision below the bfloat16 the configurations state.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8(t: torch.Tensor) -> torch.Tensor:
    t = t.float()
    amax = t.abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


PRECISIONS = {"f32": exact, "fp8": fp8}


@contextlib.contextmanager
def no_tf32():
    """Float32 products and convolutions in full float32 inside the block;
    the previous settings are restored after."""
    mm, conv = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = conv
