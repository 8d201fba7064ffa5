"""The device the models, matching and device RANSAC run on."""

from __future__ import annotations

import torch


def resolve_device(spec=None) -> torch.device:
    """``general.tpu.device``: "auto" (or None) picks the first CUDA device
    when one is present, else the CPU; "cuda" or "cpu" (or "cuda:N")
    requests one. A requested CUDA device that is missing raises: the run
    never moves to the CPU behind the user's back."""
    if spec is None or str(spec).lower() == "auto":
        return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    dev = torch.device(spec)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device '{spec}' requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return dev
