"""Published peaks of one NVIDIA H100 SXM and the least time of a piece of
work at those peaks.

Copied from ``chip_smoke.py`` (``HBM_RATE``, ``PEAK_RATE``, ``_bound``),
with the bound returned in seconds. Rates are NVIDIA's data sheet, dense,
without sparsity, at the 700 W limit: HBM3 at 3.35 TB/s; 989 TFLOP/s in
bf16 and fp16, 495 in TF32 on the tensor cores, 67 in float32 outside them.
"""

from __future__ import annotations

HBM_RATE = 3.35e12
PEAK_RATE = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}


def bound_s(nbytes: float, ops: float, kind: str) -> float:
    """The least seconds the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak rate of ``kind``."""
    return max(nbytes / HBM_RATE, ops / PEAK_RATE[kind])
