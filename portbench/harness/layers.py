"""What a traced run hands the per-layer metrics' readers
(``portbench/metrics/<metric>.py``, each ``read(ctx) -> float | None``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from harness import plugins


@dataclass
class Context:
    config: dict
    window_s: float
    n_cards: int
    n_images: int
    n_pairs: int
    spans: List[tuple] = field(default_factory=list)      # (name, start ns, end ns)
    calls: Dict[str, list] = field(default_factory=dict)  # kernel -> call records
    launches: int = 0
    trace: Optional[object] = None                        # trace.DeviceTrace in the window
    busy_s: Optional[Dict[int, float]] = None             # per card
    model_least_s: Optional[float] = None

    def span_s(self, name: str) -> float:
        return sum(b - a for n, a, b in self.spans if n == name) / 1e9

    def roofline(self, name: str) -> Optional[float]:
        """Percent: the least time of a kernel's recorded calls over its
        device time in the window; None where either is missing."""
        k = plugins.kernel(name)
        least = k.least_seconds(self.calls.get(name, []))
        if least is None or self.trace is None:
            return None
        t = self.trace.kernel_ns(k.DEVICE_NAMES) / 1e9
        return 100.0 * least / t if t > 0 else None
