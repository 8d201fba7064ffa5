"""Device tracing hooks (port of
``deep_image_matching_tpu/utils/profiler.py``).

``device_trace`` records the enclosed block with ``torch.profiler`` (host
and, where CUDA is available, device activity) and writes a Chrome trace,
``<out_dir>/<name>/trace.json``, viewable in Perfetto or chrome://tracing,
when profiling is on: an explicit ``out_dir`` or the ``DIM_TPU_PROFILE``
environment variable. ``annotate`` names a host section in that trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
from pathlib import Path
from typing import Optional

import torch

logger = logging.getLogger("dim_tpu_torch")


@contextlib.contextmanager
def device_trace(name: str, out_dir: Optional[str] = None):
    """Trace the enclosed block when profiling is on; a no-op otherwise."""
    out_dir = out_dir or os.environ.get("DIM_TPU_PROFILE")
    if not out_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    path = Path(out_dir) / name
    path.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logger.info(f"Profiling '{name}' -> {path}")
    with profile(activities=activities, record_shapes=True) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path / "trace.json"))


def annotate(name: str):
    """A named host section in the trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
