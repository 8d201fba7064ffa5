"""RoMa's depthwise refiner stack (kernel 9).

``refiner_dw_stack`` applies N blocks of ``x = conv1x1(relu(dwconv5x5_same(x)
+ b1)) + b2`` to NHWC f32 input, with the JAX package's layouts at the
boundary (``ops/pallas_refiner.py::refiner_dw_stack``): x (B, H, W, C),
w1 (N, 5, 5, 1, C) depthwise HWIO taps, b1 (N, C), w2 (N, 1, 1, C, C) 1x1
HWIO weights, b2 (N, C). For CUDA tensors it launches the kernel of
``csrc/refiner.cu`` once per block, ping-ponging two buffers; for CPU
tensors it runs ``refiner_dw_stack_reference``. Both are f32 throughout (the
kernel's 1x1 mix in split TF32, which keeps f32-level results).

``refiner_plan`` chooses the kernel's work units: strips of ``Wt`` output
columns over bands of ``Hb`` rows, one thread block each.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..utils.device import full_f32
from . import _lib

MAX_C = 64     # the kernel's widest activation (its taps and tiles are sized for it)
THREADS = 256  # threads of a kernel block; THREADS // C columns of C channels take part
MAXI = 4       # output columns a thread owns
MAX_BOX = 256  # a TMA box's extent: the input row of Wt + 4 columns
CTAS_PER_SM = 2  # thread blocks an SM holds at once (the kernel's __launch_bounds__)


@functools.lru_cache(maxsize=256)
def refiner_plan(B: int, H: int, W: int, C: int, sms: int) -> tuple:
    """(Wt, Hb): the strip width and band height of a launch.

    Strips are the kernel's widest: ``MAXI`` columns per taking-part thread,
    an input row of Wt + 4 columns inside a TMA box, no wider than the
    image. Bands are as many as one wave of thread blocks (``sms *
    CTAS_PER_SM``) holds over the B images' strips, at least one: each band
    recomputes a 4-row halo, so more than a wave buys nothing."""
    Wt = min(MAXI * (THREADS // C), MAX_BOX - 4, W)
    strips = -(-W // Wt)
    bands = min(H, max(1, sms * CTAS_PER_SM // (B * strips)))
    return Wt, -(-H // bands)


def refiner_dw_stack_reference(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain version: the two convolutions of each block (channels-last),
    in full f32."""
    C = x.shape[-1]
    y = x.permute(0, 3, 1, 2)
    with full_f32():
        for k in range(w1.shape[0]):
            h = F.relu(F.conv2d(y, w1[k].permute(3, 2, 0, 1), b1[k], padding=2, groups=C))
            y = F.conv2d(h, w2[k].permute(3, 2, 0, 1), b2[k])
    return y.permute(0, 2, 3, 1).contiguous()


def refiner_dw_stack(x, w1, b1, w2, b2) -> torch.Tensor:
    """N (dw5x5 -> ReLU -> 1x1) blocks, one launch each. On CUDA the kernel
    takes f32, contiguous tensors, 1 <= C <= 64, and raises otherwise."""
    if not x.is_cuda:
        return refiner_dw_stack_reference(x, w1, b1, w2, b2)
    B, H, W, C = x.shape
    N = w1.shape[0]
    if not 1 <= C <= MAX_C:
        raise ValueError(f"refiner kernel takes 1 to {MAX_C} channels, got {C}")
    if N < 1 or B * H * W == 0:
        raise ValueError(f"refiner kernel needs blocks and pixels, got N={N}, x {tuple(x.shape)}")
    dev = x.device
    _lib.check_cuda("x", x, torch.float32, (B, H, W, C), dev)
    _lib.check_cuda("w1", w1, torch.float32, (N, 5, 5, 1, C), dev, align=4)
    _lib.check_cuda("b1", b1, torch.float32, (N, C), dev, align=4)
    _lib.check_cuda("w2", w2, torch.float32, (N, 1, 1, C, C), dev, align=4)
    _lib.check_cuda("b2", b2, torch.float32, (N, C), dev, align=4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    Wt, Hb = refiner_plan(B, H, W, C, sms)
    bufs = [torch.empty_like(x) for _ in range(min(N, 2))]
    src = x
    for k in range(N):
        dst = bufs[k % 2]
        _lib.launch(
            "refiner", "dim_refiner_block", dev.index, src.data_ptr(), w1[k].data_ptr(),
            b1[k].data_ptr(), w2[k].data_ptr(), b2[k].data_ptr(), dst.data_ptr(),
            B, H, W, C, Wt, Hb, _lib.stream_of(x),
        )
        src = dst
    return src
