"""Named-section wall-clock timer.

Parity: reference ``utils/timer.py`` (named sections, EWMA smoothing or
cumulate-by-key, ``update``/``print``, ``timeit`` decorator). Used to report
per-stage pipeline timings. CUDA work is asynchronous; callers
must block (e.g. ``torch.cuda.synchronize()``) before ``update`` for meaningful
device timings; the pipeline's stages end on a device->host copy, which
does.
"""

from __future__ import annotations

import functools
import logging
import time
from collections import OrderedDict
from typing import Callable, Optional


class Timer:
    def __init__(
        self,
        smoothing: float = 0.3,
        cumulate_by_key: bool = False,
        logger: Optional[logging.Logger] = None,
        log_level: str = "info",
    ):
        self.smoothing = smoothing
        self.cumulate = cumulate_by_key
        self.logger = logger
        self.log_level = log_level
        self.times: "OrderedDict[str, float]" = OrderedDict()
        self.reset()

    def reset(self) -> None:
        now = time.time()
        self.start = now
        self.last = now
        self.times.clear()

    def update(self, name: str) -> None:
        now = time.time()
        dt = now - self.last
        self.last = now
        if name in self.times:
            if self.cumulate:
                self.times[name] += dt
            else:
                self.times[name] = (
                    self.smoothing * dt + (1.0 - self.smoothing) * self.times[name]
                )
        else:
            self.times[name] = dt

    def print(self, text: str = "Timer") -> None:
        total = time.time() - self.start
        parts = ", ".join(f"{k}={v:.3f}s" for k, v in self.times.items())
        msg = f"[Timer] | [{text}] {parts} (total={total:.3f}s)"
        if self.logger is not None:
            getattr(self.logger, self.log_level)(msg)
        else:
            print(msg)


def timeit(func: Callable) -> Callable:
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        t0 = time.time()
        out = func(*args, **kwargs)
        logging.getLogger("dim_tpu_torch").debug(
            f"{func.__name__} took {time.time() - t0:.4f}s"
        )
        return out

    return wrapper
