"""Native (C++) runtime components, loaded via ctypes.

``unionfind.cpp`` (a copy of the JAX package's, which uses no framework) is
compiled with ``g++ -O3 -shared -fPIC`` at first use into
``build/native/`` at the root of the checkout, keyed by a hash of the source
and the flags, so an unchanged checkout reuses its library and nothing is
written beside the sources. A failed build or load raises with the
compiler's or the loader's message: there is no fallback that would hide it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LIB = None
_lock = threading.Lock()


def build() -> Path:
    """Compile ``unionfind.cpp`` unless this exact build exists."""
    src = _NATIVE_DIR / "unionfind.cpp"
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(src.read_bytes())
    so = BUILD_DIR / f"libunionfind_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not build {src.name}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {src.name} ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def _load_lib() -> ctypes.CDLL:
    global _LIB
    with _lock:
        if _LIB is None:
            so = build()
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e:
                raise RuntimeError(f"cannot load {so}: {e}") from e
            lib.uf_components.restype = ctypes.c_int64
            lib.uf_components.argtypes = [
                ctypes.c_int64,
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                ctypes.c_int64,
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ]
            _LIB = lib
    return _LIB


def connected_components(n_nodes: int, edges: np.ndarray) -> np.ndarray:
    """Root label per node for the graph given by (E, 2) int edges."""
    edges = np.ascontiguousarray(edges, np.int64).reshape(-1, 2)
    roots = np.empty(n_nodes, np.int64)
    _load_lib().uf_components(n_nodes, edges.reshape(-1), len(edges), roots)
    return roots
