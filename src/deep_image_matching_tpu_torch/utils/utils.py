"""Misc utilities.

Parity: reference ``utils/utils.py:12-108`` — stdout capture, pairs-file
reading, homogeneous coordinates, epipolar errors (the epipolar math lives
in ``triangulation.compute_epipolar_errors``).
"""

from __future__ import annotations

import contextlib
import io
import logging
import sys
from pathlib import Path
from typing import List, Tuple

import numpy as np

logger = logging.getLogger("dim_tpu_torch")


class OutputCapture:
    """Capture stdout of a block; replay it on failure (used around noisy
    third-party calls, reference ``utils/utils.py:12-40``)."""

    def __init__(self, verbose: bool = False):
        self.verbose = verbose

    def __enter__(self):
        if not self.verbose:
            self._cap = contextlib.redirect_stdout(io.StringIO())
            self._out = self._cap.__enter__()
        return self

    def __exit__(self, exc_type, *args):
        if not self.verbose:
            self._cap.__exit__(exc_type, *args)
            if exc_type is not None:
                logger.error(f"Captured output:\n{self._out.getvalue()}")
        sys.stdout.flush()
        return False


def get_pairs_from_file(pair_file) -> List[Tuple[str, str]]:
    pairs = []
    with open(pair_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                pairs.append((parts[0], parts[1]))
    return pairs


def to_homogeneous(points: np.ndarray) -> np.ndarray:
    return np.concatenate([points, np.ones_like(points[..., :1])], axis=-1)


def from_homogeneous(points: np.ndarray) -> np.ndarray:
    return points[..., :-1] / np.maximum(points[..., -1:], 1e-12)
