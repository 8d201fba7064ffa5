"""deep_image_matching_tpu_torch: the PyTorch/CUDA port of
deep_image_matching_tpu.

The JAX package stays the reference; this package runs its main path —
pair generation, SuperPoint extraction, LightGlue matching, batched device
RANSAC, the HDF5 outputs and the COLMAP database export — with PyTorch, and
the four TPU kernels of that path as hand-written CUDA kernels for Hopper
(``csrc/``). Public API as in the JAX package: ``Config``, ``ImageMatcher``,
the enums and the timer/logger utilities.
"""

__version__ = "0.1.0"

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
