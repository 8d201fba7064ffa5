"""Build, load and count the hand-written CUDA kernels in ``csrc/``.

The ``.cu`` files compile with ``nvcc``, one process per source, all
started together, and link into one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), loaded with ``ctypes``. The
build runs at first use into ``build/torch_kernels/`` at the
root of the checkout, keyed by a hash of the sources, the headers they
include and the flags, so an unchanged checkout reuses its library.
``-Xptxas -v`` output (registers, shared memory, spills per kernel) is kept
in ``build/torch_kernels/ptxas.log``.

Every kernel wrapper adds one to its entry of ``LAUNCHES`` where it launches
its kernel, and nowhere else, so a run can show which kernels its main path
went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("attention.cu", "ffn.cu", "assignment.cu", "nullspace.cu", "nn.cu",
           "sinkhorn.cu", "refiner.cu", "bidir_attention.cu", "qkv.cu")
# attention_sm90.cuh and attention_f32_sm90.cuh are included by attention.cu
# and bidir_attention.cu; sm90_common.cuh (mbarriers, TMA, wgmma helpers) by
# both, sinkhorn.cu, ffn.cu, assignment.cu, qkv.cu and refiner.cu
HEADERS = ("attention_sm90.cuh", "attention_f32_sm90.cuh", "sm90_common.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the float32 forms of kernels 1, 2, 6 and 10 count apart from the bf16 ones,
# and kernel 1's head-dim-96 forms apart from its head-dim-64 ones
LAUNCHES: Dict[str, int] = {
    "attention": 0, "ffn": 0, "assignment": 0, "nullspace": 0, "nn": 0,
    "sinkhorn": 0, "lse_rows": 0, "refiner": 0, "bidir_attention": 0, "qkv": 0,
    "attention_f32": 0, "ffn_f32": 0, "bidir_attention_f32": 0, "qkv_f32": 0,
    "attention_hd96": 0, "attention_hd96_f32": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "dim_attention_bf16": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "dim_ffn_bf16": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "dim_assignment_pass": [_I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _F, _I, _P],
    "dim_nullspace_8x9": [_I, _P, _P, _I, _P],
    "dim_nn_top2": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "dim_sinkhorn_iteration": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "dim_lse_rows": [_I, _P, _P, _P, _P, _I, _I, _I, _P],
    "dim_refiner_block": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "dim_bidir_attention_bf16": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "dim_qkv_rotary_bf16": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "dim_attention_f32": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "dim_ffn_f32": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "dim_bidir_attention_f32": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _F, _P],
    "dim_qkv_rotary_f32": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "dim_attention_hd96_bf16": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "dim_attention_hd96_f32": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
}

# the dtypes of the kernels with a bf16 and a float32 form
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

_lib = None
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def build() -> Path:
    """Compile ``csrc/*.cu`` for sm_90a unless this exact build exists."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    so = BUILD_DIR / f"libdim_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(name).stem}.{tag}.o" for name in SOURCES]
    procs = [
        subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, obj in zip(SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    (BUILD_DIR / "ptxas.log").write_text("".join(logs))
    for name, p, log in zip(SOURCES, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} ({p.returncode}):\n{log[-4000:]}")
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    res = subprocess.run(
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
         *(str(o) for o in objs)], capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def launch(kernel: str, fn_name: str, *args) -> None:
    """Call one C launcher, raise on its ``cudaGetLastError`` result, and
    count the launch under ``kernel``."""
    err = getattr(lib(), fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")
    LAUNCHES[kernel] += 1


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None,
               device: torch.device = None, align: int = 16) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``, where given) on ``device``, its data ``align``-byte aligned."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer must be {align}-byte aligned")


def kernel_dtype(name: str, *tensors: torch.Tensor) -> torch.dtype:
    """The one dtype of ``tensors`` if it is bf16 or f32 (kernels 1, 2, 6
    and 10 have a form for each); raise on any other dtype or on a mix,
    naming the two the kernel takes."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or next(iter(dtypes)) not in KERNEL_DTYPES:
        raise ValueError(
            f"{name}: dtypes {sorted(str(d) for d in dtypes)}; the kernel takes all operands "
            "in one dtype, torch.bfloat16 or torch.float32")
    return dtypes.pop()


def tf32_split(t: torch.Tensor) -> torch.Tensor:
    """(2, *t.shape) f32: hi = rna_tf32(t) and lo = rna_tf32(t - hi), the
    TF32 halves of the split-TF32 products (``cvt.rna.tf32.f32``: 10 mantissa
    bits, ties away from zero, i.e. the low 13 bits cleared after adding
    0x1000 to the word), computed with integer operations on any device."""

    def rna(x):
        bits = x.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(t)
    return torch.stack([hi, rna(t.float() - hi)])
