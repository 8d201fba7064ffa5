"""RoMa's depthwise refiner stack (kernel 9).

``refiner_dw_stack`` applies N blocks of ``x = conv1x1(relu(dwconv5x5_same(x)
+ b1)) + b2`` to NHWC f32 input, with the JAX package's layouts at the
boundary (``ops/pallas_refiner.py::refiner_dw_stack``): x (B, H, W, C),
w1 (N, 5, 5, 1, C) depthwise HWIO taps, b1 (N, C), w2 (N, 1, 1, C, C) 1x1
HWIO weights, b2 (N, C). For CUDA tensors it launches the kernel of
``csrc/refiner.cu`` once per block, ping-ponging two buffers; for CPU
tensors it runs ``refiner_dw_stack_reference``. Both are f32 throughout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.device import full_f32
from . import _lib

MAX_C = 64  # the kernel's shared memory holds the tile of up to 64 channels


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
    """N fused (dw5x5 -> ReLU -> 1x1) blocks. On CUDA the kernel takes f32,
    contiguous tensors, 1 <= C <= 64, and raises otherwise."""
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
    bufs = [torch.empty_like(x) for _ in range(min(N, 2))]
    src = x
    for k in range(N):
        dst = bufs[k % 2]
        _lib.launch(
            "refiner", "dim_refiner_block", dev.index, src.data_ptr(), w1[k].data_ptr(),
            b1[k].data_ptr(), w2[k].data_ptr(), b2[k].data_ptr(), dst.data_ptr(),
            B, H, W, C, _lib.stream_of(x),
        )
        src = dst
    return src
