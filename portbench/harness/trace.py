"""The device trace of a traced run (``torch.profiler``, device activity
only) reduced to what the per-layer metrics read.

Busy time is the union of the device's activity intervals (kernels,
copies, memsets) inside the window's jobs, per card, so that work on two
streams at once (the prefetch pool's uploads beside the kernels) counts
once, and the profiler's own set-up and the harness's work between two
jobs, outside them, not at all. Device
timestamps and the harness's spans share the host's wall clock in
nanoseconds (``time.time_ns``), as the profiler converts its device clock
to it.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

Interval = Tuple[int, int]


def union_ns(intervals: List[Interval]) -> List[Interval]:
    """Sorted, merged intervals: the union of ``intervals``."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: List[Interval], lo: int, hi: int) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def gaps(busy: List[Interval], lo: int, hi: int) -> List[Interval]:
    """The idle intervals of [lo, hi) between merged busy intervals."""
    out, at = [], lo
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def base_name(name: str) -> str:
    """A kernel's function name without its return type, namespaces,
    template and argument lists: ``void (anonymous namespace)::ffn_sm90<0>(...)``
    gives ``ffn_sm90``."""
    n = name.replace("(anonymous namespace)::", "").strip()
    if n.startswith("void "):
        n = n[5:]
    return re.split(r"[(<]", n, maxsplit=1)[0].split("::")[-1].strip()


@dataclass
class DeviceTrace:
    """Device events as (device index, name, start ns, end ns)."""
    events: List[Tuple[int, str, int, int]] = field(default_factory=list)

    def window(self, lo: int, hi: int) -> "DeviceTrace":
        return DeviceTrace([e for e in self.events if e[3] > lo and e[2] < hi])

    def busy_ns(self, spans: List[Interval]) -> Dict[int, int]:
        """Per device, the nanoseconds of the disjoint intervals ``spans`` in
        which it ran anything."""
        by_dev = defaultdict(list)
        for dev, _, a, b in self.events:
            by_dev[dev].append((a, b))
        out = {}
        for d, iv in by_dev.items():
            merged = union_ns(iv)
            out[d] = sum(b - a for lo, hi in spans for a, b in clip(merged, lo, hi))
        return out

    def kernel_ns(self, pattern: str) -> int:
        """Summed durations of the events whose function name (``base_name``)
        matches ``pattern`` in full."""
        rx = re.compile(pattern)
        return sum(b - a for _, name, a, b in self.events if rx.fullmatch(base_name(name)))

    def top_ops(self, n: int = 10) -> List[list]:
        tot = defaultdict(int)
        for _, name, a, b in self.events:
            tot[name] += b - a
        return [[k, v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, windows: List[Interval], spans, n: int = 10) -> List[list]:
        """The ``n`` longest idle gaps of the first device inside the
        intervals ``windows``, each named by the innermost span of ``spans``
        ((name, start ns, end ns)) holding its middle."""
        by_dev = defaultdict(list)
        for dev, _, a, b in self.events:
            by_dev[dev].append((a, b))
        if not by_dev:
            return []
        merged = union_ns(by_dev[min(by_dev)])
        idle = [g for lo, hi in windows for g in gaps(clip(merged, lo, hi), lo, hi)]
        idle.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in idle[:n]:
            mid = (a + b) // 2
            holding = [s for s in spans if s[1] <= mid < s[2]]
            name = min(holding, key=lambda s: s[2] - s[1])[0] if holding else "outside spans"
            out.append([name, (b - a) / 1e9])
        return out


def from_profiler(prof) -> DeviceTrace:
    """The device events (kernels, copies, memsets) of a finished
    ``torch.profiler.profile``, from its Kineto results."""
    out = DeviceTrace()
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0:
            out.events.append((int(e.device_index()), e.name(), int(e.start_ns()),
                               int(e.start_ns() + e.duration_ns())))
    return out
