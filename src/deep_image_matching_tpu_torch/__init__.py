"""deep_image_matching_tpu_torch: the PyTorch/CUDA port of
deep_image_matching_tpu.

The JAX package stays the reference; this package runs its ported presets
(superpoint+lightglue, superpoint+superglue, and superpoint, sift and orb
with kornia_matcher) — pair generation, extraction, matching, batched device
RANSAC, the HDF5 outputs and the COLMAP database export — with PyTorch, and
the TPU kernels of those paths as hand-written CUDA kernels for Hopper
(``csrc/``). Public API as in the JAX package: ``Config``, ``ImageMatcher``,
the enums and the timer/logger utilities.
"""

__version__ = "0.1.0"

import torch as _torch

# PyTorch's CPU exp settles its implementation lazily. When its first call
# in a process runs on several threads, one thread's share of the output can
# differ from every later call by up to ~1e-4 relative (seen with the 2.13 CPU
# build); later calls agree with float64. One serial call at import settles
# it before the plain kernel versions run.
_torch.exp(_torch.zeros(1))

from .config import Config, confs, opt_zoo  # noqa: F401
from .constants import (  # noqa: F401
    GeometricVerification,
    Quality,
    TileSelection,
)
from .image_matching import ImageMatcher  # noqa: F401
from .utils.logger import change_logger_level, setup_logger  # noqa: F401
from .utils.timer import Timer, timeit  # noqa: F401

logger = setup_logger(name="dim_tpu_torch", log_level="info")
