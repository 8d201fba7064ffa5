"""The port's tracing: spans and counters in a bounded ring, device spans
on CUDA events, and the operator's Chrome trace (port of
``deep_image_matching_tpu/utils/profiler.py``, which has the trace alone).

``span(name)`` times the enclosed block on the host. On exit it appends one
record to a ring of ``RING_SIZE`` records (older ones are overwritten and
counted, ``dropped()``):
``(name, start_ns, end_ns, parent, run, value)``, with times from
``time.time_ns()``, ``parent`` the path of the enclosing spans on the same
thread (``"match/match.dispatch"``, None at a thread's top level) and ``run``
the identifier of the ``run_scope`` in force, one per ``run_matching`` call,
which every thread's records carry, the prefetch pool's and the feature
writer's included. ``count(name, n)`` appends a record of no length
carrying ``n``. Host records are always kept; a span costs about a
microsecond.

``device_span(name, device)`` records a pair of CUDA events around the
enclosed work on the device's current stream, while a torch profiler
records (``torch.autograd._profiler_enabled()``) or after
``set_device_spans(True)``; otherwise it records nothing and costs one
check. Its record's value is the events' ``elapsed_time`` in
milliseconds, resolved when ``records()`` reads it, so the span adds no
host synchronisation where it runs.

``device_trace(name)`` records the enclosed block with ``torch.profiler``
(host and, where CUDA is available, device activity) and writes a Chrome
trace, ``<out_dir>/<name>/trace.json``, viewable in Perfetto or
chrome://tracing, when profiling is on: an explicit ``out_dir`` or the
``DIM_TPU_PROFILE`` environment variable. Inside it, and nowhere else, every
span also opens ``torch.profiler.record_function(name)``, so the trace shows
the stages over the kernels.

Span names: ``sync.<site>`` spans each wrap one blocking device-to-host
point, ``wait.<site>`` spans a wait on another thread; a dot names a part
of the span of the first word (``match.dispatch`` inside ``match``).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import List, NamedTuple, Optional, Tuple

import torch

logger = logging.getLogger("dim_tpu_torch")

RING_SIZE = 1 << 18

_ring: deque = deque(maxlen=RING_SIZE)
# appends take the lock only near a full ring, where a record is dropped
_near_full = RING_SIZE - 1024
_lock = threading.Lock()
_dropped = [0, 0]           # records overwritten, end_ns of the last one
_tls = threading.local()
_runs = itertools.count(1)
_run: Optional[int] = None  # the run_scope in force, for every thread
_annotate = False           # inside device_trace: spans open record_function
_device_spans = False       # device spans without a profiler (tests)


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    run: Optional[int]
    value: object


_now = time.time_ns


def _append(rec: tuple) -> None:
    if len(_ring) < _near_full:
        _ring.append(rec)
        return
    with _lock:
        if len(_ring) == _ring.maxlen:
            _dropped[0] += 1
            _dropped[1] = max(_dropped[1], _ring[0][2])
        _ring.append(rec)


class span:
    """Time the enclosed block on the host (see the module's docstring);
    ``seconds`` is its length once it has ended."""

    __slots__ = ("name", "value", "start_ns", "end_ns", "_parent", "_rf")

    def __init__(self, name: str, value=None):
        self.name = name
        self.value = value

    def __enter__(self) -> "span":
        try:
            stack = _tls.stack
        except AttributeError:
            stack = _tls.stack = []
        if stack:
            parent = self._parent = stack[-1]
            stack.append(parent + "/" + self.name)
        else:
            self._parent = None
            stack.append(self.name)
        if _annotate:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        self.start_ns = _now()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        end = self.end_ns = _now()
        if self._rf is not None:
            self._rf.__exit__(et, ev, tb)
        _tls.stack.pop()
        rec = (self.name, self.start_ns, end, self._parent, _run, self.value)
        if len(_ring) < _near_full:
            _ring.append(rec)
        else:
            _append(rec)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def count(name: str, n) -> None:
    """A counter: one record of no length carrying ``n``."""
    stack = getattr(_tls, "stack", None)
    t = _now()
    _append((name, t, t, stack[-1] if stack else None, _run, n))


class _DeviceTiming:
    """A device span's two events; ``ms()`` waits for the second."""

    __slots__ = ("start", "end", "_ms")

    def __init__(self, stream):
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start.record(stream)
        self._ms = None

    def ms(self) -> float:
        if self._ms is None:
            self.end.synchronize()
            self._ms = self.start.elapsed_time(self.end)
        return self._ms


class _device_span(span):
    __slots__ = ("_stream",)

    def __init__(self, name: str, device: torch.device):
        super().__init__(name)
        self._stream = torch.cuda.current_stream(device)

    def __enter__(self) -> "span":
        super().__enter__()
        self.value = _DeviceTiming(self._stream)
        return self

    def __exit__(self, et, ev, tb) -> bool:
        self.value.end.record(self._stream)
        return super().__exit__(et, ev, tb)


def device_span(name: str, device) -> contextlib.AbstractContextManager:
    """The device time of the enclosed work on ``device`` (see the module's
    docstring); a no-op off CUDA and while device spans are off."""
    if not (_device_spans or torch.autograd._profiler_enabled()):
        return contextlib.nullcontext()
    device = torch.device(device)
    if device.type != "cuda":
        return contextlib.nullcontext()
    return _device_span(name, device)


def set_device_spans(on: bool) -> None:
    """Record device spans without a profiler (``on``) or only under one."""
    global _device_spans
    _device_spans = bool(on)


@contextlib.contextmanager
def run_scope():
    """A new run identifier for every record made inside, on any thread."""
    global _run
    outer, _run = _run, next(_runs)
    try:
        yield _run
    finally:
        _run = outer


def records() -> List[Record]:
    """The ring's records, oldest first, each device span's value resolved
    to milliseconds (waiting for its events: call this after the work has
    been synchronised)."""
    out = []
    for rec in list(_ring):
        v = rec[5]
        if isinstance(v, _DeviceTiming):
            rec = rec[:5] + (v.ms(),)
        out.append(Record(*rec))
    return out


def dropped() -> Tuple[int, int]:
    """(records overwritten so far, the latest end_ns among them)."""
    with _lock:
        return _dropped[0], _dropped[1]


def reset(capacity: int = RING_SIZE) -> None:
    """Empty the ring, with room for ``capacity`` records."""
    global _ring, _near_full
    with _lock:
        _ring = deque(maxlen=capacity)
        _near_full = max(capacity - 1024, 0)
        _dropped[:] = [0, 0]


@contextlib.contextmanager
def device_trace(name: str, out_dir: Optional[str] = None):
    """Trace the enclosed block when profiling is on; a no-op otherwise."""
    global _annotate
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
        _annotate = True
        try:
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            _annotate = False
    prof.export_chrome_trace(str(path / "trace.json"))
