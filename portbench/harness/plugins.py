"""Pieces found by name: a per-layer metric's reader
(``portbench/metrics/<metric>.py``), a kernel's operations and bytes
(``portbench/kernels/<kernel>.py``), a configuration's model FLOPs
(``portbench/flops/<config>.py``), a model's plain reference with its
seeded checkpoint (``portbench/reference/<model>.py``, named by the
configuration's ``reference``). Later cells, models and metrics add files
here; the harness needs no edit for them."""

from __future__ import annotations

import importlib
import importlib.util
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[1]
_LOADED = {}


def _load(kind: str, name: str) -> ModuleType:
    path = ROOT / kind / f"{name}.py"
    key = (kind, name)
    if key not in _LOADED:
        spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[key] = mod
    return _LOADED[key]


def metric(name: str) -> ModuleType:
    return _load("metrics", name)


def kernel(name: str) -> ModuleType:
    return _load("kernels", name)


def flops(config: str) -> ModuleType:
    return _load("flops", config)


def reference(model: str) -> ModuleType:
    """``reference/<model>.py``, imported as a module of the ``reference``
    package (the references share ``reference/lowp.py``)."""
    return importlib.import_module(f"reference.{model}")


def kernel_names():
    return sorted(p.stem for p in (ROOT / "kernels").glob("*.py"))
