"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
1. environment: torch and CUDA versions, the card's name and power limit;
2. kernel build: the CUDA sources of ``src/deep_image_matching_tpu_torch/csrc``
   compiled for sm_90a (one nvcc per source, all started together), with
   ptxas' register and spill report, and the count of HGMMA instructions in
   the SASS of the two attention kernels, the FFN, the assignment and the
   QKV prologue (each of the four in its bf16 and its float32 form, and
   kernel 1 also at head dim 96 in both), and of HMMA (``mma.sync``) in the
   refiner's (``cuobjdump -sass``; none fails);
3. each kernel against its plain PyTorch version on the card, at the
   main-path shapes (partial masks, degenerate hypotheses, integer
   descriptors with ties), with its tolerance and both times (CUDA events
   around runs of back-to-back calls, median of 10; for the null space and
   the refiner also ``device_ms``, the device time of their own kernels under
   ``torch.profiler``), its bound (the larger of
   the bytes it must move over 3.35 TB/s and its operations over the peak
   rate of their type) and the time of one PyTorch call that computes the
   same function, where there is one: attention (LightGlue's, SuperGlue's,
   and DINOv2's at RoMa's 560 px and at DeDoDe-G's 784 px), the FFN in
   both modes (ln_gelu at LightGlue's shape, relu at SuperGlue's),
   assignment (SuperPoint's and ALIKED's keypoint counts), null space,
   nearest neighbours (SuperPoint's width 256, and LiftFeat's and alike-t's
   64, alike-s's 96 and RIPE's 960 at (16, 4096, 4096), each timed against
   its bound), the Sinkhorn
   iteration, the
   row logsumexp, RoMa's refiner stack (both passes' shapes), LightGlue's
   bidirectional cross attention (LightGlue's and ALIKED's lengths) and its
   fused QKV + rotary prologue (both modes, beside the path's own unfused
   prologue on the same inputs), kernel 1's head-dim-96 forms (the
   ``wgmma`` / TMA cores at D = 96, bf16 and split TF32) at LighterGlue's
   (16, 1, 4096, 96) with partial masks; then the float32 forms (split TF32) of
   attention (LightGlue's and SuperGlue's shapes), the FFN (both modes),
   the bidirectional attention (2048 and 4096) and the QKV prologue (both
   modes), each against its plain version in f32 with its tolerance relative
   to the output's largest magnitude, its registers and spills;
4. LightGlue and SuperGlue at full width on small batches with planted
   matches: the kernels on the card against the plain versions on the CPU,
   LightGlue also with ``attn_impl: bidir`` and the fused prologue; ALIKED at
   480 x 640 on one demo image, card against CPU in f32; RoMa (DINOv2 at 2
   blocks, 224 / 320 px) on the card against the CPU, its sampler with the
   CPU's draws, and RoMa with DINOv2 at its published depth (24 blocks) on
   one pair at the default 560 / 864 px; LightGlue (also with both opt-ins)
   and SuperGlue again in float32, card against CPU: matches equal but for
   near-ties, scores within 1e-4, the float32 kernels' launches counted;
5. the main paths through the port's CLI entry ``run_matching`` (random
   weights, --skip_reconstruction), each with the launch counts set to 0
   just before it and read just after:
   - superpoint+lightglue: 16 synthetic 1024x1024 views with ``bruteforce``
     pairs (match threshold 0, since random weights never reach the default
     0.1; two views are shifted copies of the first, whose verified matches
     must carry the shift), then the 5 demo images with the default
     ``matching_lowres`` strategy and default settings;
   - superpoint+superglue on the synthetic views (``bruteforce``, match
     threshold 0);
   - superpoint+kornia_matcher on the synthetic views (the shifted copies
     keep their descriptors, so their verified matches carry the shift);
   - sift+kornia_matcher and orb+kornia_matcher on the 5 demo images
     (``bruteforce``), on the card and again on the CPU: the raw matches must
     be equal pair by pair, since the arithmetic on integer descriptors is
     exact;
   - roma on the 5 demo images (``bruteforce``, default settings): the
     keypoints each pair appends, the multiview merge and its database;
   - aliked+lightglue with a seeded random ALIKED checkpoint (ALIKED has no
     random initialisation), ``DIM_TPU_FUSED_PROLOGUE=1`` and the checkpoint's
     directory as ``DIM_TPU_WEIGHTS_DIR`` for this path only: the synthetic
     views (``bruteforce``, match threshold 0, ``tpu.attn_impl: bidir``),
     then the 5 demo images with the default ``matching_lowres``, whose probe
     runs ALIKED and counts mutual nearest neighbours (no SuperPoint or
     LightGlue checkpoint);
   - with ``general.tpu.dtype: float32``: superpoint+lightglue on the 16
     synthetic views, superpoint+superglue and aliked+lightglue (bidir, fused
     prologue) on 6 of them, each checking that the float32 kernels of its
     path launched;
   - the presets of ``SPARSE_PATHS`` (``phase_sparse_presets``):
     disk+lightglue, xfeat+lighterglue (bf16 and float32: kernel 1's
     head-dim-96 forms, never kernel 2) and superpoint_open+kornia_matcher
     on the synthetic views (match threshold 0), keynetaffnethardnet+
     kornia_matcher on the demo images at the preset's 4000 features (DoH,
     then seeded KeyNet, AffNet and OriNet checkpoints, ``keynet_weights``),
     the AdaLAM matcher over sift (``adalam``, ``adalam_fast``), and
     dedode+kornia_matcher (descriptor B, then G, whose DINOv2 runs kernel 1
     in bf16), liftfeat+kornia_matcher and ripe+kornia_matcher on the
     synthetic views with seeded checkpoints
     (``dedode_liftfeat_ripe_weights``; kernel 5 at widths 256, 64 and
     960), rdd_sparse+lightglue on the synthetic views (random RDD and
     LightGlue weights, RDD in full f32, kernels 1-4 at K = 4096), and ALIKE
     through a YAML over sift+kornia_matcher with seeded checkpoints
     (``alike_weights``): alike-n on the synthetic views (held to the
     planted shifts), alike-s and alike-t on the demo images (kernel 5 at
     D = 96 and 64), each once more warm under
     ``torch.profiler`` (wall, device busy, idle share, peak memory), then
     each against the CPU (``SPARSE_CPU_CHECKS``: shares of keypoints and raw
     matches; DeDoDe and RIPE at their rows' sizes on view 0 of the synthetic
     views and its shifted copy, G's DINOv2 in f32 on both sides, and the
     timed bf16 G against the CPU's f32; DISK, XFeat, ALIKED and SuperPoint
     (open or not) at 1024 x 1024 on the same two views and the seeded
     KeyNet / AffNet / OriNet on the demo images, RDD and ALIKE in full f32
     at 1024 x 1024 on the two views, each share printed beside its bound);
   - the extract -> match handoff (``phase_handoff``): features.h5 written
     through the handoff byte-equal to the host path's for SuperPoint,
     ALIKED, XFeat and ALIKE on the demo images at medium quality and for
     SuperPoint's tiled device route, and superpoint+lightglue's
     raw_matches.h5 and matches.h5 from the handoff's store equal to a
     ``--resume`` of its match stage, whose store reads features.h5;
   - the LoFTR family (``phase_loftr``, seeded checkpoints
     ``loftr_weights``, match threshold 0, no kernel may launch): loftr on
     the synthetic views (held to the planted shifts, once more warm under
     ``torch.profiler``), loftr dense and with ``coarse_impl: blocked`` on 6
     of them (the same coarse matches but for near-ties, which are printed),
     se2loftr on its SE2 backbone on the 6 views, srif on the demo images,
     then loftr and se2loftr on the card against the CPU on view 0 and its
     shifted copy at 1024 x 1024 (the share of each pair's coarse matches
     held by both, the largest difference of the fine coordinates).
   Each run checks features.h5, raw_matches.h5 and database.db and prints
   the wall time per stage; each path checks that its kernels launched;
6. tiled extraction and matching (``--tiling``), each counted run with the
   launch counts set to 0 just before it and read just after:
   - superpoint+lightglue ``--tiling preselection`` on 6 synthetic views of
     6000 x 4000 (24 MP; the default tiles (2400, 2000), 6 an image; 15
     ``bruteforce`` pairs; match threshold 0; views 4 and 5 are view 0
     shifted by ``TILED_SHIFTS``, whose verified matches must carry the
     shift) at the preset's 2048 keypoints, again warm under
     ``torch.profiler`` (device busy, idle share, peak memory), and at 8192;
     every image's keypoints carry ``tile_idx`` from at least two tiles and
     no pair holds a query keypoint twice; the tile-pair jobs per pair;
   - ``--tiling grid`` on the 5 demo images at tiles (400, 300) with
     sift+kornia_matcher and superpoint+lightglue;
   - 2 views of 4800 x 3200 (4 tiles an image, view 1 a shifted copy of
     view 0) on the card and on the CPU: equal tile-pair jobs on the shifted
     pair, at least 90 % of the
     keypoints shared, and LightGlue on the CPU run's tile-pair jobs as one
     batch gathered from a tiled store on each device, card against CPU in
     float32 (the reference phase's float32 rule) and in bf16 (against the
     CPU's float32, within twice the plain bf16 version's distance);
   - ``cut_tiles`` and ``merge_tile_features`` on the card bitwise equal to
     the CPU on a 24 MP view's tiles, and kernels 1 and 3 against their plain
     versions on a batch of tile-pair jobs gathered from the tiled store
     (masks scattered over the capacity);
7. reconstruction, the main path's stage 5 (no exception caught):
   - bundle adjustment alone at 64 poses, 8192 points and ~262k observations
     (``ba_scene``: perturbed as ``tests/test_sfm.py`` perturbs its scene):
     the mapper's default solve on the card down to under 1.5 x the injected
     noise; ms a LM step between CUDA events, device time, launches and the
     idle share a step under ``torch.profiler``, peak memory and the CPU's
     time a step; card against CPU, the float64 cost traces within 1e-3;
   - ``native_incremental_mapping`` on the card at the JAX package's mapper
     profile size (``mapper_scene``: 60 images, 6000 points, window 40)
     against the ground truth (at least 58/60 registered, focal within 1 %,
     relative rotations within 0.5 deg), with its phase table and wall;
   - ``run_matching`` without --skip_reconstruction on the 5 demo images,
     on the card and on the CPU: sift+kornia_matcher (``bruteforce``; the
     same registered images, and stage 5 on the card over the CPU run's
     database within 2 % of the CPU's points; the model's files), and the
     default superpoint+lightglue (``matching_lowres``), which must end on
     the card as on the CPU; each with its kernels' launches counted;
8. retrieval pairs (``phase_retrieval``): NetVLAD, OpenIBL, CosPlace, DIR
   and the tiny descriptor at their published widths (seeded checkpoints in
   their files' own layouts, ``retrieval_weights``) on the 16 synthetic
   views, on the card (warm wall, device busy) against the CPU (descriptors
   within RETRIEVAL_TOL, top-10 pairs equal but for near-ties), then
   ``run_matching --strategy retrieval --global_feature netvlad`` with
   superpoint+lightglue, kernels 1-4 counted;
9. ``--upright`` (``phase_upright``) on the 5 demo images plus three copies
   of the first rotated by 90, 180 and 270 degrees (lossless PNG): the
   2clusters probe on the card and on the CPU must recover the planted
   rotations, launching kernel 5 twice an image; kernel 5 against its plain
   version at the probe's shapes (4, 512, 256) and (4, 512, 128); then
   ``run_matching --upright`` with superpoint+lightglue under ``custom``
   (``rotations.txt``) and ``2clusters`` (kernel 5 counted): the upright
   copies equal the reference's pixels, and features.h5 holds each copy's
   keypoints, the reference's rotated into its frame, with its image_size;
10. the exports (``phase_exports``) on the sift+kornia_matcher demo run of
   stage 5: Bundler, Metashape, MicMac with its import back to h5, OpenMVG
   and the view graph, their files and tie-point counts against matches.h5
   and database.db, with no device event; then ``run_matching --openmvg``.

Exits non-zero without a CUDA device, without the package beside it, or on
any failure. The last three lines are the card, the kernel report and the
device report.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
PKG = SRC / "deep_image_matching_tpu_torch"
WORK = ROOT / "build" / "chip_smoke"

# the last two synthetic views are view 0 shifted by these pixels: whole cells
# of ALIKED's coarsest block (32 px), so SuperPoint's (8 px) and ALIKED's
# features both move with the image
SHIFTS = {-2: (64, -32), -1: (-96, 32)}

# kernel name -> (source, TPU kernel it replaces)
KERNELS = {
    "attention": ("src/deep_image_matching_tpu_torch/csrc/attention.cu",
                  "src/deep_image_matching_tpu/ops/attention.py:96"),
    "ffn": ("src/deep_image_matching_tpu_torch/csrc/ffn.cu",
            "src/deep_image_matching_tpu/ops/pallas_ffn.py:89"),
    "assignment": ("src/deep_image_matching_tpu_torch/csrc/assignment.cu",
                   "src/deep_image_matching_tpu/ops/pallas_assignment.py:101"),
    "nullspace": ("src/deep_image_matching_tpu_torch/csrc/nullspace.cu",
                  "src/deep_image_matching_tpu/ops/pallas_nullspace.py:140"),
    "nn": ("src/deep_image_matching_tpu_torch/csrc/nn.cu",
           "src/deep_image_matching_tpu/ops/pallas_nn.py:122"),
    "sinkhorn": ("src/deep_image_matching_tpu_torch/csrc/sinkhorn.cu",
                 "src/deep_image_matching_tpu/ops/pallas_sinkhorn.py:140"),
    "lse_rows": ("src/deep_image_matching_tpu_torch/csrc/sinkhorn.cu",
                 "src/deep_image_matching_tpu/ops/pallas_sinkhorn.py:64"),
    "refiner": ("src/deep_image_matching_tpu_torch/csrc/refiner.cu",
                "src/deep_image_matching_tpu/ops/pallas_refiner.py:90"),
    "bidir_attention": ("src/deep_image_matching_tpu_torch/csrc/bidir_attention.cu",
                        "src/deep_image_matching_tpu/ops/pallas_bidir_attention.py:151"),
    "qkv": ("src/deep_image_matching_tpu_torch/csrc/qkv.cu",
            "src/deep_image_matching_tpu/ops/pallas_qkv.py:115"),
    # the float32 forms (split TF32) of kernels 1, 2, 6 and 10: the JAX
    # package runs its Pallas kernels in the dtype they are given
    "attention_f32": ("src/deep_image_matching_tpu_torch/csrc/attention.cu",
                      "src/deep_image_matching_tpu/ops/attention.py:96"),
    "ffn_f32": ("src/deep_image_matching_tpu_torch/csrc/ffn.cu",
                "src/deep_image_matching_tpu/ops/pallas_ffn.py:89"),
    "bidir_attention_f32": ("src/deep_image_matching_tpu_torch/csrc/bidir_attention.cu",
                            "src/deep_image_matching_tpu/ops/pallas_bidir_attention.py:151"),
    "qkv_f32": ("src/deep_image_matching_tpu_torch/csrc/qkv.cu",
                "src/deep_image_matching_tpu/ops/pallas_qkv.py:115"),
    # kernel 1 at LighterGlue's head dim 96 (the wgmma / TMA cores at
    # D = 96), in bf16 and in split TF32
    "attention_hd96": ("src/deep_image_matching_tpu_torch/csrc/attention.cu",
                       "src/deep_image_matching_tpu/ops/attention.py:96"),
    "attention_hd96_f32": ("src/deep_image_matching_tpu_torch/csrc/attention.cu",
                           "src/deep_image_matching_tpu/ops/attention.py:96"),
}

# NVIDIA H100 SXM data sheet: HBM bytes/s, dense peak operations/s by type
# (bf16 and TF32 on the tensor cores, f32 outside them)
HBM_RATE = 3.35e12
PEAK_RATE = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}


def _bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, ops / PEAK_RATE[kind] * 1e3
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes, "bound_by": "bytes"}
    return {"bound_ms": t_ops, "bound_by": "operations"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)

# no path of the JAX package calls logsumexp_rows: it is held against its
# plain version only and exempt from the launch check
NO_CALLER = {"lse_rows": "no caller on any path of the JAX package; held against its "
                         "plain version only"}


@contextlib.contextmanager
def _env(values: dict):
    """Environment variables set inside the block, restored after it."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _time_ms(fn, reps: int = 10) -> float:
    """Median milliseconds per call of ``fn``: ``reps`` samples, each a run
    of back-to-back calls between two CUDA events (as many as fill about 2
    ms, at most 50), after one warm-up call and one warm-up run; the host's
    dispatch of one call overlaps the device's work on the one before, as in
    a pipeline."""
    import torch

    def run(n: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    fn()
    torch.cuda.synchronize()
    n = max(1, min(50, int(2.0 / max(run(1), 1e-3))))
    run(n)
    times = sorted(run(n) for _ in range(reps))
    return times[len(times) // 2]


def _device_ms(fn, names, reps: int = 20):
    """Device milliseconds per call of ``fn`` spent in the ``__global__``
    functions whose names hold one of ``names``: ``torch.profiler``'s CUDA
    events over ``reps`` back-to-back calls, after a warm-up call. Unlike
    ``_time_ms`` it leaves out the host's dispatch between launches. None
    where the profiler recorded no such event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = sum(ms for ms, _, key in _device_busy(prof)[2] if any(n in key for n in names))
    return ms / reps if ms > 0 else None


def _device_busy(prof) -> tuple:
    """(device milliseconds, device events: kernels, copies and memsets, the
    events by time as (ms, count, name)) of a ``torch.profiler`` run; (None,
    None, []) where it recorded no device event."""
    events = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            events.append((us / 1e3, e.count, e.key))
    events.sort(reverse=True)
    if not events:
        return None, None, []
    return sum(e[0] for e in events), sum(e[1] for e in events), events


def _profiled(fn) -> tuple:
    """``fn()`` under ``torch.profiler`` (device activity), its wall seconds
    and ``_device_busy`` of the run. CUPTI now and then drops every device
    event of a session (1 session in 30 of a loop of identical runs on the
    H100), so a session that recorded none runs once more; the caller fails
    where the second records none either."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = _device_busy(prof)
        if busy[0] is not None:
            break
    return wall, busy


def phase_environment() -> str:
    import torch

    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    if not card:
        _fail(f"nvidia-smi gave no card ({smi.stderr.strip()})")
    print(f"[env] device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    return card


def phase_build() -> None:
    from deep_image_matching_tpu_torch.ops import _lib

    t0 = time.perf_counter()
    so = _lib.build()
    _lib.lib()
    dt = time.perf_counter() - t0
    print(f"[build] {so.relative_to(ROOT)} for sm_90a in {dt:.1f} s "
          f"(sources: {', '.join(_lib.SOURCES)})", flush=True)
    log = (_lib.BUILD_DIR / "ptxas.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {line.strip()}", flush=True)
    # the attention core, the FFN, the assignment, the nearest-neighbour
    # top-2 and the QKV prologue must have compiled to Hopper's warpgroup
    # products, the refiner's 1x1 mix to tensor-core products
    for kernel, count in _sass_mma(so).items():
        op = MMA_KERNELS[kernel][1]
        print(f"[build] {kernel}: {count} {op} instructions in its SASS", flush=True)
        if not count:
            _fail(f"{kernel}: no {op} in its SASS (its tensor-core products did not compile)")


# kernel entry -> (the name its SASS section carries (anonymous namespace),
# the tensor-core instruction it must hold)
MMA_KERNELS = {"attention": ("attention_sm90", "HGMMA"),
               "bidir_attention": ("bidir_attention_sm90", "HGMMA"),
               "ffn": ("ffn_sm90", "HGMMA"), "assignment": ("assignment_sm90", "HGMMA"),
               "qkv": ("qkv_sm90", "HGMMA"), "refiner": ("refiner_block_kernel", "HMMA"),
               "attention_f32": ("attention_f32_sm90", "HGMMA"),
               "bidir_attention_f32": ("bidir_attention_f32_sm90", "HGMMA"),
               "ffn_f32": ("ffn_f32_sm90", "HGMMA"), "qkv_f32": ("qkv_f32_sm90", "HGMMA"),
               "attention_hd96": ("attention_hd96_sm90", "HGMMA"),
               "attention_hd96_f32": ("attention_hd96_f32_sm90", "HGMMA"),
               "nn": ("nn_top2_sm90", "HGMMA")}


def _ptxas(name: str) -> dict:
    """Registers and spill bytes per entry function whose (mangled) name
    holds ``name``, from the build's ``ptxas -v`` log."""
    from deep_image_matching_tpu_torch.ops import _lib

    log = _lib.BUILD_DIR / "ptxas.log"
    out, current = {}, None
    for line in (log.read_text().splitlines() if log.exists() else []):
        if "Compiling entry function '" in line:
            fn = line.split("'")[1]
            current = fn if name in fn else None
            if current:
                out[current] = {}
        elif current and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out[current].update(stack_bytes=nums[0], spill_store_bytes=nums[1],
                                spill_load_bytes=nums[2])
        elif current and "Used " in line and " registers" in line:
            out[current]["registers"] = int(line.split("Used ")[1].split()[0])
    return out


def _sass_mma(so: Path) -> dict:
    """Tensor-core instructions per kernel of ``MMA_KERNELS`` in the
    library's SASS, from the CUDA toolkit's ``cuobjdump -sass``."""
    from deep_image_matching_tpu_torch.ops import _lib

    tool = Path(_lib._nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True)
    if res.returncode != 0:
        _fail(f"cuobjdump -sass failed ({res.returncode}): {res.stderr.strip()[-500:]}")
    counts, current = {name: 0 for name in MMA_KERNELS}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            # the longest matching name: bidir_attention_sm90 holds attention_sm90
            hits = [k for k, v in MMA_KERNELS.items() if v[0] in fn]
            current = max(hits, key=lambda k: len(MMA_KERNELS[k][0])) if hits else None
        elif current is not None and MMA_KERNELS[current][1] in line:
            counts[current] += 1
    return counts


def _masks(torch, gen, B, N, dev):
    """Partial masks: pair b keeps a random prefix count; one pair is
    fully valid and one keeps only a few points (its tail query tiles are
    fully masked)."""
    counts = torch.randint(N // 2, N + 1, (B,), generator=gen)
    counts[0] = N
    counts[1] = 37
    return (torch.arange(N)[None] < counts[:, None]).to(dev)


def _attention_case(torch, fused_attention, attention_reference, q, k, v, qm, km):
    """One attention shape: the error held to two bf16 ulps elementwise over
    valid query rows (inf if any element exceeds it), the bound, the three
    times (kernel, plain version, one scaled_dot_product_attention call with
    the same boolean key mask)."""
    B, H, Tq, hd = q.shape
    Tk = k.shape[2]
    scale = hd ** -0.5
    got = fused_attention(q, k, v, qm, km, scale)
    ref = attention_reference(q, k, v, km, scale)
    torch.cuda.synchronize()
    qm_ = qm if qm is not None else torch.ones(B, Tq, dtype=torch.bool, device=q.device)
    km_ = km if km is not None else torch.ones(B, Tk, dtype=torch.bool, device=q.device)
    rows = qm_[:, None, :, None].expand_as(got)
    diff = (got.float() - ref.float()).abs()[rows]
    mag = ref.float().abs()[rows].clamp(min=1.0)
    err = diff.max().item()
    # two bf16 ulps of the output (2^-6 relative at |x| >= 1): the output's
    # own rounding plus the probabilities, which the kernel rounds to bf16
    # before normalising and the plain version after
    if bool((diff > (2.0 ** -6) * mag).any()):
        err = float("inf")
    tol = float((2.0 ** -6) * mag.max())
    del got, ref, diff, rows, mag
    # the work these masks need: valid queries against valid keys
    pairs = float((qm_.sum(1).double() * km_.sum(1).double()).sum())
    bound = _bound(_nbytes(q, k, v, q) + qm_.numel() + km_.numel(), 4.0 * H * hd * pairs, "bf16")
    mask = None if km is None else km[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {"ms": _time_ms(lambda: fused_attention(q, k, v, qm, km, scale)),
             "plain_ms": _time_ms(lambda: attention_reference(q, k, v, km, scale)),
             "library_ms": _time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale))}
    return err, tol, {**times, **bound}


def check_attention(torch, dev, card):
    from deep_image_matching_tpu_torch.ops.attention import (
        attention_reference, fused_attention)

    gen = torch.Generator().manual_seed(1)
    # LightGlue's shape: (B, H, T, 64) heads split from contiguous channels
    B, H, N, d = 16, 4, 2048, 64
    q, k, v = (torch.randn(B, H, N, d, generator=gen).mul(s).to(dev, torch.bfloat16)
               for s in (2.0, 2.0, 1.0))
    qm = _masks(torch, gen, B, N, dev)
    km = _masks(torch, gen, B, N, dev)
    err, tol, main = _attention_case(torch, fused_attention, attention_reference, q, k, v, qm, km)
    del q, k, v
    torch.cuda.empty_cache()
    # SuperGlue's shape: T = 4096, heads interleaved across the 256 channels
    # (viewed as (head_dim, heads)), made contiguous as models/superglue.py's
    # _mha makes them
    T = 4096

    def heads(t):
        return t.reshape(B, T, d, H).permute(0, 3, 1, 2).contiguous()

    q, k, v = (heads(torch.randn(B, T, H * d, generator=gen).mul(s).to(dev, torch.bfloat16))
               for s in (2.0, 2.0, 1.0))
    qm = _masks(torch, gen, B, T, dev)
    km = _masks(torch, gen, B, T, dev)
    sg_err, sg_tol, sg = _attention_case(torch, fused_attention, attention_reference,
                                         q, k, v, qm, km)
    del q, k, v
    torch.cuda.empty_cache()
    # DINOv2's shape at RoMa's 560 px: 2 images, 16 heads, 1601 tokens (a
    # ragged length), no masks, q, k, v made contiguous from the fused qkv
    # projection as models/dinov2.py makes them
    S, Hd = 1601, 16
    qkv = (torch.randn(2, S, 3, Hd, d, generator=gen) * 1.5).to(dev, torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))
    dn_err, dn_tol, dn = _attention_case(torch, fused_attention, attention_reference,
                                         q, k, v, None, None)
    del qkv, q, k, v
    torch.cuda.empty_cache()
    # DeDoDe-G's DINOv2 at its default 784 px: one image, 16 heads, 56 x 56
    # patches and the class token (3137 tokens), no masks, made the same way
    S_g = (784 // 14) ** 2 + 1
    qkv = (torch.randn(1, S_g, 3, Hd, d, generator=gen) * 1.5).to(dev, torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))
    dg_err, dg_tol, dg = _attention_case(torch, fused_attention, attention_reference,
                                         q, k, v, None, None)
    del qkv, q, k, v
    torch.cuda.empty_cache()
    what = (f"valid query rows, 2 bf16 ulps elementwise; (16, 4, 2048, 64) reported; "
            f"SuperGlue's (16, 4, 4096, 64) interleaved heads: max err {sg_err:.3e}, kernel "
            f"{sg['ms']:.3f} ms, plain {sg['plain_ms']:.3f} ms, sdpa {sg['library_ms']:.3f} ms, "
            f"bound {sg['bound_ms']:.3f} ms; DINOv2's (2, 16, 1601, 64): max err {dn_err:.3e}, "
            f"kernel {dn['ms']:.3f} ms, plain {dn['plain_ms']:.3f} ms, sdpa "
            f"{dn['library_ms']:.3f} ms, bound {dn['bound_ms']:.3f} ms; DeDoDe-G's DINOv2 "
            f"(1, 16, {S_g}, 64): max err {dg_err:.3e}, kernel {dg['ms']:.3f} ms, plain "
            f"{dg['plain_ms']:.3f} ms, sdpa {dg['library_ms']:.3f} ms, bound "
            f"{dg['bound_ms']:.3f} ms")
    extra = {**main, "superglue_shape": [B, H, T, d], "superglue_max_abs_err": sg_err,
             **{f"superglue_{k}": v for k, v in sg.items()},
             "dinov2_shape": [2, Hd, S, d], "dinov2_max_abs_err": dn_err,
             **{f"dinov2_{k}": v for k, v in dn.items()},
             "dedode_g_shape": [1, Hd, S_g, d], "dedode_g_max_abs_err": dg_err,
             **{f"dedode_g_{k}": v for k, v in dg.items()}}
    # each shape is held to its own elementwise bound (inf on failure)
    return (max(err, sg_err, dn_err, dg_err), max(tol, sg_tol, dn_tol, dg_tol), what, extra)


def check_ffn(torch, dev, card):
    from deep_image_matching_tpu_torch.ops.ffn import ffn_fused, ffn_reference

    gen = torch.Generator().manual_seed(2)
    D = 256
    bf = torch.bfloat16

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen) * s).to(dev, bf)

    w1 = rnd(2 * D, 2 * D, s=(2 * D) ** -0.5)
    b1 = rnd(2 * D, s=0.1)
    g = (1.0 + 0.1 * torch.randn(2 * D, generator=gen)).to(dev, bf)
    beta = rnd(2 * D, s=0.1)
    w2 = rnd(D, 2 * D, s=(2 * D) ** -0.5)
    b2 = rnd(D, s=0.1)
    errs, times, bounds = {}, {}, {}
    # each mode at its path's shape: LightGlue's ln_gelu at K = 2048,
    # SuperGlue's relu at K = 4096
    for mode, K in (("ln_gelu", 2048), ("relu", 4096)):
        args = (rnd(16, K, D), rnd(16, K, D), w1, b1, g, beta, w2, b2)
        # inputs, weights and the (16, K, 256) output; two products per row
        bounds[mode] = _bound(_nbytes(*args, args[0]), 2.0 * 16 * K * (4 * D * D + 2 * D * D),
                              "bf16")
        got = ffn_fused(*args, mode=mode)
        ref = ffn_reference(*args, mode=mode)
        torch.cuda.synchronize()
        diff = (got.float() - ref.float()).abs()
        err = diff.max().item()
        # one bf16 ulp of the output (2^-7 relative at |x| >= 1), for rounding
        # ties the f32 sums (other order, erff vs erf) put on the other side
        ulp = (2.0 ** -7) * ref.float().abs().clamp(min=1.0)
        if bool((diff > ulp + 1e-6).any()):
            err = float("inf")
        errs[mode] = (err, float((2.0 ** -7) * ref.float().abs().max().clamp(min=1.0)))
        times[mode] = (_time_ms(lambda: ffn_fused(*args, mode=mode)),
                       _time_ms(lambda: ffn_reference(*args, mode=mode)))
    # each mode is held to its own elementwise bound above (inf on failure);
    # the report carries the larger error and the larger bound
    err = max(e for e, _ in errs.values())
    tol = max(t for _, t in errs.values())
    what = ("1 bf16 ulp elementwise; ln_gelu (16, 2048, 256) (reported times) max err "
            f"{errs['ln_gelu'][0]:.3e}; relu (16, 4096, 256) max err {errs['relu'][0]:.3e}, "
            f"kernel {times['relu'][0]:.3f} ms, plain {times['relu'][1]:.3f} ms")
    extra = {"ms": times["ln_gelu"][0], "plain_ms": times["ln_gelu"][1], **bounds["ln_gelu"],
             "library_ms": None,
             "library_note": "none: LayerNorm, GELU (or ReLU) and two products; no single "
                             "PyTorch call does all of them",
             "relu_shape": [16, 4096, D], "relu_max_abs_err": errs["relu"][0],
             "relu_ms": times["relu"][0], "relu_plain_ms": times["relu"][1],
             "relu_bound_ms": bounds["relu"]["bound_ms"], "ptxas": _ptxas("ffn_sm90")}
    return err, tol, what, extra


def _assignment_case(torch, gen, B, N, D, dev, masks=None):
    """One assignment shape with partial masks (``_masks``'s, or ``masks``
    (m0, m1)): the error on valid rows and columns (inf if an argmax
    differs beyond a near-tie), the near-ties, the times and the bounds."""
    from deep_image_matching_tpu_torch.ops.assignment import (
        assignment_fused, assignment_reference, log_assignment_dense)

    md0 = (torch.randn(B, N, D, generator=gen) * D ** -0.25).to(dev)
    md1 = (torch.randn(B, N, D, generator=gen) * D ** -0.25).to(dev)
    z0 = torch.randn(B, N, generator=gen).to(dev)
    z1 = torch.randn(B, N, generator=gen).to(dev)
    if masks is None:
        masks = (_masks(torch, gen, B, N, dev), _masks(torch, gen, B, N, dev))
    m0, m1 = masks
    args = (md0, md1, z0, z1, m0, m1)
    got = assignment_fused(*args)
    ref = assignment_reference(*args)
    scores = log_assignment_dense(*args)
    torch.cuda.synchronize()
    err = max((got[0] - ref[0]).abs()[m0].max().item(),
              (got[2] - ref[2]).abs()[m1].max().item())
    # argmax: equal, or a near-tie whose dense score is within 1e-4 of the max
    s_at0 = torch.gather(scores, 2, got[1].long()[..., None])[..., 0]
    s_at1 = torch.gather(scores, 1, got[3].long()[:, None, :])[:, 0, :]
    far0 = ((got[1] != ref[1]) & m0 & ((ref[0] - s_at0).abs() > 1e-4)).sum().item()
    far1 = ((got[3] != ref[3]) & m1 & ((ref[2] - s_at1).abs() > 1e-4)).sum().item()
    ties = int(((got[1] != ref[1]) & m0).sum().item() + ((got[3] != ref[3]) & m1).sum().item())
    if far0 or far1:
        err = float("inf")
    del ref, scores, s_at0, s_at1
    torch.cuda.empty_cache()
    # one product over the valid rows and columns: the kernel's arithmetic,
    # three TF32 products per multiply-add on the tensor cores, and, kept for
    # comparison with the earlier rows, one f32 product outside them; inputs
    # read once, the four (B, N) outputs written once
    pairs = float((m0.sum(1).double() * m1.sum(1).double()).sum())
    nbytes = _nbytes(*args, *got)
    return err, ties, {
        "ms": _time_ms(lambda: assignment_fused(*args)),
        "plain_ms": _time_ms(lambda: assignment_reference(*args)),
        **_bound(nbytes, 3 * 2.0 * D * pairs, "tf32"),
        "fma_bound_ms": _bound(nbytes, 2.0 * D * pairs, "f32")["bound_ms"]}


def check_assignment(torch, dev, card):
    gen = torch.Generator().manual_seed(3)
    # SuperPoint's K = 2048 (reported), then ALIKED's 4096
    err, ties, main = _assignment_case(torch, gen, 16, 2048, 256, dev)
    torch.cuda.empty_cache()
    a_err, a_ties, aliked = _assignment_case(torch, gen, 16, 4096, 256, dev)
    tol = 1e-3  # f32-level sums in another order over D = 256 and N <= 4096
    extra = {**main, "library_ms": None,
             "library_note": "none: the row and column maxima and argmaxima of a dual "
                             "softmax over a product; no single PyTorch call gives them",
             "bound_note": "bound_ms: one product of the valid pairs as three TF32 products "
                           "at 495 TFLOP/s; fma_bound_ms: as one f32 product at 67 TFLOP/s",
             "aliked_shape": [16, 4096, 4096, 256], "aliked_max_abs_err": a_err,
             **{f"aliked_{k}": v for k, v in aliked.items()},
             "ptxas": _ptxas("assignment_sm90")}
    what = (f"valid rows and columns; (16, 2048, 2048, 256) reported, argmax near-ties {ties}; "
            f"ALIKED's (16, 4096, 4096, 256): max err {a_err:.3e}, near-ties {a_ties}, kernel "
            f"{aliked['ms']:.3f} ms, plain {aliked['plain_ms']:.3f} ms, bound "
            f"{aliked['bound_ms']:.3f} ms ({aliked['bound_by']}), f32-FMA bound "
            f"{aliked['fma_bound_ms']:.3f} ms; f32-FMA bound at 2048 {main['fma_bound_ms']:.3f} ms")
    # each shape is held to the same rule (inf on a far argmax)
    return max(err, a_err), tol, what, extra


def check_nullspace(torch, dev, card):
    from deep_image_matching_tpu_torch.ops.nullspace import (
        nullspace_planes, nullspace_reference)

    gen = torch.Generator().manual_seed(4)
    N = 16 * 2048
    p0 = torch.rand(N, 8, 2, generator=gen) * 2 - 1
    shift = torch.rand(N, 1, 2, generator=gen) - 0.5
    kind = torch.arange(N) % 4
    # 0, 1: generic; 2: pure translation (f33 = 0, degenerate); 3: all-zero
    p1 = torch.where((kind == 2)[:, None, None], p0 + shift,
                     torch.rand(N, 8, 2, generator=gen) * 2 - 1)
    x0, y0, x1, y1 = p0[..., 0], p0[..., 1], p1[..., 0], p1[..., 1]
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0,
                     torch.ones_like(x0)], dim=-1)          # (N, 8, 9)
    A[kind == 3] = 0.0
    A9 = A.permute(2, 1, 0).contiguous().to(dev)            # (9, 8, N)
    got = nullspace_planes(A9)
    ref = nullspace_reference(A9)
    torch.cuda.synchronize()
    gen_cols = (kind <= 1).to(dev)
    diff = torch.minimum((got - ref).abs().amax(0), (got + ref).abs().amax(0))
    err = diff[gen_cols].max().item()
    live = (kind <= 2).to(dev)
    res = torch.einsum("nrc,cn->nr", A.to(dev), got).abs().amax(1)
    norm_err = (got.norm(dim=0) - 1).abs()[live].max().item()
    if res[live].max().item() > 1e-4 or norm_err > 1e-5 or not torch.isfinite(got).all():
        err = float("inf")
    # generic systems, up to sign: f32 null directions of random 8x9 systems
    # move by ~eps / sigma_8 between two QR orderings; degenerate ones (a
    # >= 2-dim null space) are held to the residual |A f| < 1e-4 only
    tol = 1e-3
    A_rows = A.to(dev)  # (N, 8, 9): the systems as torch.linalg.svd takes them
    # Householder QR of the 9 x 8 transpose, 2 m n^2 - 2 n^3 / 3 flops
    # (m = 9, n = 8), and the null vector; the systems read once, the
    # vectors written once
    extra = {"ms": _time_ms(lambda: nullspace_planes(A9)),
             "device_ms": _device_ms(lambda: nullspace_planes(A9), ("nullspace_kernel",)),
             # the plain version (torch.linalg.qr of 32768 small systems) takes
             # 2-4 s a call, so its median is of 3 runs, not 10
             "plain_ms": _time_ms(lambda: nullspace_reference(A9), reps=3),
             **_bound(_nbytes(A9, got), N * (2 * 9 * 64 - 2 * 512 / 3), "f32"),
             "library_ms": _time_ms(lambda: torch.linalg.svd(A_rows))}
    dev_ms = extra["device_ms"]
    what = (f"generic up to sign; residual < 1e-4 incl. f33 = 0; device time of its kernel "
            f"alone {'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}")
    return err, tol, what, extra


def _nn_bounds(nbytes: float, B: int, K0: int, K1: int, D: int) -> dict:
    """Kernel 5's bound: the product as three TF32 products at 495 TFLOP/s
    (the design's arithmetic) or the bytes, whichever is larger; and, as a
    note on the f32 FMA design it replaced, one f32 product at 67
    TFLOP/s."""
    flops = 2.0 * B * K0 * K1 * D
    return {**_bound(nbytes, 3 * flops, "tf32"),
            "ffma_bound_ms": _bound(nbytes, flops, "f32")["bound_ms"]}


def check_nn(torch, dev, card):
    from deep_image_matching_tpu_torch.ops.nn import nn_top2, nn_top2_reference

    gen = torch.Generator().manual_seed(5)
    F = torch.nn.functional
    # SuperPoint's shape: unit-norm f32, K = 4096, half the queries with a
    # near copy among the references, partial masks (invalid references carry
    # the 1e12 squared-norm offset, as nn_match_fused gives them)
    B, K, D = 16, 4096, 256
    d0 = F.normalize(torch.randn(B, K, D, generator=gen), dim=-1)
    d1 = F.normalize(torch.randn(B, K, D, generator=gen), dim=-1)
    d1[:, : K // 2] = F.normalize(d0[:, : K // 2] + 0.3 * torch.randn(B, K // 2, D, generator=gen),
                                  dim=-1)
    m0 = _masks(torch, gen, B, K, "cpu")
    m1 = _masks(torch, gen, B, K, "cpu")
    d0 = (d0 * m0[..., None]).to(dev)
    d1 = (d1 * m1[..., None]).to(dev)
    sq1 = (d1 ** 2).sum(-1) + torch.where(m1.to(dev), 0.0, 1e12)
    got = nn_top2(d0, d1, sq1)
    ref = nn_top2_reference(d0, d1, sq1)
    torch.cuda.synchronize()
    err = max((got[0] - ref[0]).abs().max().item(), (got[1] - ref[1]).abs().max().item())
    gap = ref[1] - ref[0]
    same = got[2] == ref[2]
    equal_share = same.float().mean().item()
    far = int((~same & (gap > 1e-3)).sum().item())
    if far or equal_share < 0.999:
        err = float("inf")
    tol = 1e-4  # split-TF32 products (~2^-22 relative) summed in another order over D = 256
    extra = {"ms": _time_ms(lambda: nn_top2(d0, d1, sq1)),
             "plain_ms": _time_ms(lambda: nn_top2_reference(d0, d1, sq1)),
             **_nn_bounds(_nbytes(d0, d1, sq1, *got), B, K, K, D),
             "bound_note": "bound_ms: the product as three TF32 products at 495 TFLOP/s (the "
                           "kernel's split-TF32 wgmma); ffma_bound_ms: one f32 product at 67 "
                           "TFLOP/s, the bound of the f32 FMA design it replaced",
             "library_ms": None,
             "library_note": "none: the top-2 of the distances needs two calls "
                             "(torch.cdist, then topk)",
             "ptxas": _ptxas("nn_top2_sm90")}
    # SIFT (128) and ORB (32) widths: byte-valued descriptors at capacity
    # 4000 with exact neighbours, double minima and duplicated columns; the
    # split-TF32 arithmetic is exact on them, so every output must be bitwise
    # equal
    exact = []
    for Dw in (128, 32):
        Bi, Ki = 4, 4000
        q = torch.randint(0, 256, (Bi, Ki, Dw), generator=gen).float()
        r = torch.randint(0, 256, (Bi, Ki, Dw), generator=gen).float()
        r[:, 10:1010] = q[:, :1000]
        r[:, 1010:1510] = q[:, :500]      # queries 0-499 reach their minimum twice
        r[:, 2000:3000] = r[:, 1000:2000]  # duplicated columns
        q, r = q.to(dev), r.to(dev)
        sq = (r ** 2).sum(-1)
        g, rf = nn_top2(q, r, sq), nn_top2_reference(q, r, sq)
        ok = all(torch.equal(a, b) for a, b in zip(g, rf))
        ok &= bool((g[0][:, :500] == g[1][:, :500]).all())
        exact.append(f"D={Dw} {'bitwise equal' if ok else 'DIFFERENT'}")
        if not ok:
            err = float("inf")
    # LiftFeat's and alike-t's 64, alike-s's 96 and RIPE's 960 (kernel 5 at
    # its other paths' widths), unit-norm f32 at (16, 4096, 4096) as at
    # D = 256, each timed with its bound and plain version
    extra["widths"] = {}
    for Dw in (64, 96, 960):
        q = F.normalize(torch.randn(B, K, Dw, generator=gen), dim=-1)
        r = F.normalize(torch.randn(B, K, Dw, generator=gen), dim=-1)
        r[:, : K // 2] = F.normalize(q[:, : K // 2] + 0.3 * torch.randn(B, K // 2, Dw,
                                                                       generator=gen), dim=-1)
        q, r = (q * m0[..., None]).to(dev), (r * m1[..., None]).to(dev)
        sq = (r ** 2).sum(-1) + torch.where(m1.to(dev), 0.0, 1e12)
        g, rf = nn_top2(q, r, sq), nn_top2_reference(q, r, sq)
        e = max((g[0] - rf[0]).abs().max().item(), (g[1] - rf[1]).abs().max().item())
        same_w = g[2] == rf[2]
        share_w = same_w.float().mean().item()
        far_w = int((~same_w & (rf[1] - rf[0] > 1e-3)).sum().item())
        if far_w or share_w < 0.999:
            e = float("inf")
        err = max(err, e)
        extra["widths"][Dw] = {
            "max_abs_err": e, "argmin_equal": share_w,
            "ms": _time_ms(lambda: nn_top2(q, r, sq)),
            "plain_ms": _time_ms(lambda: nn_top2_reference(q, r, sq)),
            **_nn_bounds(_nbytes(q, r, sq, *g), B, K, K, Dw)}
        wd = extra["widths"][Dw]
        exact.append(f"D={Dw} at ({B}, {K}, {K}) min1/min2 abs {e:.2e}, argmin equal "
                     f"{share_w:.5f}, kernel {wd['ms']:.3f} ms, three-TF32 bound "
                     f"{wd['bound_ms']:.3f} ms ({100 * wd['bound_ms'] / wd['ms']:.1f} %), FFMA "
                     f"bound {wd['ffma_bound_ms']:.3f} ms")
        del q, r, sq, g, rf
    what = (f"D=256 min1/min2 abs; argmin equal {equal_share:.5f}, none differs where the "
            f"gap > 1e-3; bound: three TF32 products; FFMA bound at 256 "
            f"{extra['ffma_bound_ms']:.3f} ms; {', '.join(exact)}")
    return err, tol, what, extra


def _couplings(torch, gen, B, M, N, dev):
    """SuperGlue-shaped log couplings with dustbins: masked rows and columns
    at -1e30, the marginals of masked entries at -1e30, the last row and
    column (the dustbins) valid."""
    m0 = _masks(torch, gen, B, M, "cpu")
    m1 = _masks(torch, gen, B, N, "cpu")
    m0[:, -1] = True
    m1[:, -1] = True
    z = torch.randn(B, M, N, generator=gen) * 3.0
    z = torch.where(m0[:, :, None] & m1[:, None, :], z, torch.tensor(-1e30))
    norm = -torch.log((m0.sum(1) + m1.sum(1)).float())[:, None]
    log_mu = torch.where(m0, norm, torch.tensor(-1e30))
    log_nu = torch.where(m1, norm, torch.tensor(-1e30))
    return z.to(dev), log_mu.to(dev), log_nu.to(dev), m0.to(dev), m1.to(dev)


def check_sinkhorn(torch, dev, card):
    from deep_image_matching_tpu_torch.models.superglue import _filter
    from deep_image_matching_tpu_torch.ops.sinkhorn import (
        sinkhorn_fused, sinkhorn_iteration, sinkhorn_iteration_reference)

    gen = torch.Generator().manual_seed(6)
    # SuperGlue at 4096 keypoints: (4097, 4097) couplings; the kernel masks
    # the ragged edge, so nothing is padded
    B, M, N = 16, 4097, 4097
    z, log_mu, log_nu, m0, m1 = _couplings(torch, gen, B, M, N, dev)
    v0 = torch.zeros_like(log_nu)
    u1, v1 = sinkhorn_iteration(z, v0, log_mu, log_nu)
    ru, rv = sinkhorn_iteration_reference(z, v0, log_mu, log_nu)
    torch.cuda.synchronize()
    err1 = max((u1 - ru).abs()[m0].max().item(), (v1 - rv).abs()[m1].max().item())
    u, v = sinkhorn_fused(z, log_mu, log_nu, 100)
    ru, rv = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(100):
        ru, rv = sinkhorn_iteration_reference(z, rv, log_mu, log_nu)
    torch.cuda.synchronize()
    err100 = max((u - ru).abs()[m0].max().item(), (v - rv).abs()[m1].max().item())
    # the matches SuperGlue's _filter reads from each (threshold 0)
    got_m, _, got_v = _filter(z + u[:, :, None] + v[:, None, :], m0[:, :-1], m1[:, :-1], 0.0)
    ref_m, _, ref_v = _filter(z + ru[:, :, None] + rv[:, None, :], m0[:, :-1], m1[:, :-1], 0.0)
    rows = got_v | ref_v
    agree = ((got_m == ref_m) & (got_v == ref_v))[rows].float().mean().item()
    # 1e-4 after one iteration, 1e-3 after 100 (f32 logsumexps over 4097
    # terms summed in another order, compounded over the iterations)
    err = err1 if err100 <= 1e-3 and agree >= 0.999 else float("inf")
    tol = 1e-4
    what = (f"valid u, v after 1 iteration; after 100: {err100:.3e} (tol 1e-3), _filter "
            f"matches equal {agree:.5f} of {int(rows.sum())}; times per iteration")
    # z read once; per element two exponentials and four additions
    extra = {"ms": _time_ms(lambda: sinkhorn_iteration(z, v0, log_mu, log_nu)),
             "plain_ms": _time_ms(lambda: sinkhorn_iteration_reference(z, v0, log_mu, log_nu)),
             **_bound(_nbytes(z, v0, log_mu, log_nu, u1, v1), 6.0 * z.numel(), "f32"),
             "library_ms": None,
             "library_note": "none: an iteration is two logsumexp passes (rows, then "
                             "columns) with an update between them",
             "max_abs_err_100_iterations": err100, "ptxas": _ptxas("sinkhorn_")}
    return err, tol, what, extra


def check_lse_rows(torch, dev, card):
    from deep_image_matching_tpu_torch.ops.sinkhorn import (
        logsumexp_rows, logsumexp_rows_reference)

    gen = torch.Generator().manual_seed(8)
    B, M, N = 16, 4097, 4097
    z, log_mu, _, _, _ = _couplings(torch, gen, B, M, N, dev)
    v = torch.randn(B, N, generator=gen).to(dev)
    got = logsumexp_rows(z, v, log_mu)
    ref = logsumexp_rows_reference(z, v, log_mu)
    torch.cuda.synchronize()
    # relative 1e-5 (the -1e30 rows compare relatively too)
    rel = ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    extra = {"ms": _time_ms(lambda: logsumexp_rows(z, v, log_mu)),
             "plain_ms": _time_ms(lambda: logsumexp_rows_reference(z, v, log_mu)),
             **_bound(_nbytes(z, v, log_mu, got), 3.0 * z.numel(), "f32"),
             "library_ms": _time_ms(lambda: torch.logsumexp(z, -1)),
             "library_note": "torch.logsumexp(z, -1): the same read of z, without the v "
                             "and log_mu terms"}
    return rel, 1e-5, "relative to max(|u|, 1), every row", extra


def check_refiner(torch, dev, card):
    from deep_image_matching_tpu_torch.ops.refiner import (
        refiner_dw_stack, refiner_dw_stack_reference)

    gen = torch.Generator().manual_seed(14)
    # RoMa's scale-1 refiner: 9 blocks of C = 24, weights drawn as the JAX
    # package's init draws them (depthwise taps N(0, 2/25), 1x1 N(0, 2/C))
    N, C = 9, 24
    w1 = (torch.randn(N, 5, 5, 1, C, generator=gen) * (2 / 25) ** 0.5).to(dev)
    b1 = (0.1 * torch.randn(N, C, generator=gen)).to(dev)
    w2 = (torch.randn(N, 1, 1, C, C, generator=gen) * (2 / C) ** 0.5).to(dev)
    b2 = (0.1 * torch.randn(N, C, generator=gen)).to(dev)
    res = {}
    # both passes' shapes: 2 images at coarse_res 560 and upsample_res 864
    for side in (560, 864):
        x = torch.randn(2, side, side, C, generator=gen).to(dev)
        args = (x, w1, b1, w2, b2)
        got = refiner_dw_stack(*args)
        ref = refiner_dw_stack_reference(*args)
        torch.cuda.synchronize()
        px = 2.0 * N * x.numel()  # (pixel, channel, block) triples, times 2 flops
        # the stack as one function: x read once, the result written once
        t_bytes = _nbytes(*args, got) / HBM_RATE * 1e3
        # the arithmetic the kernel runs: 25 taps per pixel, channel and
        # block in f32 FMA, the 1x1's C products as three TF32 products
        t_ops = (px * 25 / PEAK_RATE["f32"] + 3 * px * C / PEAK_RATE["tf32"]) * 1e3
        res[side] = {
            "err": ((got - ref).abs().max() / ref.abs().max()).item(),
            "ms": _time_ms(lambda: refiner_dw_stack(*args)),
            "device_ms": _device_ms(lambda: refiner_dw_stack(*args), ("refiner_block_kernel",)),
            "plain_ms": _time_ms(lambda: refiner_dw_stack_reference(*args)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            # the same work with the 1x1 in f32 FMA as well
            "fma_bound_ms": _bound(_nbytes(*args, got), px * (25 + C), "f32")["bound_ms"],
            # what this design moves: one launch per block reads and writes
            # the activations
            "per_block_traffic_ms": N * _nbytes(x, got) / HBM_RATE * 1e3,
        }
        del x, got, ref, args
        torch.cuda.empty_cache()
    # relative to the output's max: f32 sums of 25 taps and 24 split-TF32
    # products in another order than cuDNN's, compounded over 9 blocks
    tol = 1e-5
    err = max(r["err"] for r in res.values())
    a, b = res[864], res[560]

    def dms(v):
        return "not measured" if v is None else f"{v:.3f} ms"

    what = (f"|err| / max|out|, TF32 off in cuDNN; (2, 864, 864, 24) reported, {N} launches, "
            f"device {dms(a['device_ms'])}, f32-FMA bound {a['fma_bound_ms']:.3f} ms, the "
            f"launches' traffic {a['per_block_traffic_ms']:.3f} ms; (2, 560, 560, 24): err "
            f"{b['err']:.3e}, kernel {b['ms']:.3f} ms (device {dms(b['device_ms'])}), plain "
            f"{b['plain_ms']:.3f} ms, bound {b['bound_ms']:.3f} ms, f32-FMA bound "
            f"{b['fma_bound_ms']:.3f} ms")
    extra = {"ms": a["ms"], "device_ms": a["device_ms"], "plain_ms": a["plain_ms"],
             "bound_ms": a["bound_ms"], "bound_by": a["bound_by"], "library_ms": None,
             "library_note": "none: nine blocks of a depthwise 5x5 and a 1x1 convolution; "
                             "cuDNN runs them as 18 convolution calls",
             "bound_note": "bound_ms: the taps in f32 FMA at 67 TFLOP/s plus the 1x1 as three "
                           "TF32 products at 495 TFLOP/s, or the bytes; fma_bound_ms: the 1x1 "
                           "in f32 FMA too",
             "shape": [2, 864, 864, C], "blocks": N, "launches_per_stack": N,
             "fma_bound_ms": a["fma_bound_ms"], "per_block_traffic_ms": a["per_block_traffic_ms"],
             "ptxas": _ptxas("refiner_block_kernel"),
             "coarse_shape": [2, 560, 560, C], "coarse_max_abs_err": b["err"],
             **{f"coarse_{k}": v for k, v in b.items() if k != "err"}}
    return err, tol, what, extra


def check_bidir_attention(torch, dev, card):
    from deep_image_matching_tpu_torch.ops.bidir_attention import (
        bidir_cross_attention, bidir_cross_attention_reference)

    gen = torch.Generator().manual_seed(17)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res = {}
    # LightGlue's length with SuperPoint (2048) and with ALIKED (4000
    # keypoints padded to 4096), partial masks on both sides
    for N in (2048, 4096):
        B, H, d = 16, 4, 64
        qk0, qk1 = (torch.randn(B, H, N, d, generator=gen).mul(2.0).to(dev, torch.bfloat16)
                    for _ in range(2))
        v0, v1 = (torch.randn(B, H, N, d, generator=gen).to(dev, torch.bfloat16)
                  for _ in range(2))
        m0, m1 = _masks(torch, gen, B, N, dev), _masks(torch, gen, B, N, dev)
        args = (qk0, qk1, v0, v1, m0, m1)
        got = bidir_cross_attention(*args)
        ref = bidir_cross_attention_reference(*args)
        torch.cuda.synchronize()
        err, tol = 0.0, 0.0
        for g, r, m in zip(got, ref, (m0, m1)):
            rows = m[:, None, :, None].expand_as(g)
            diff = (g.float() - r.float()).abs()[rows]
            # two bf16 ulps elementwise (the output's rounding and the
            # probabilities', rounded before normalising here, after in the
            # plain version); inf if any element exceeds it
            bound = 2.0 ** -6 * r.float().abs()[rows].clamp(min=1.0)
            err = max(err, diff.max().item() if bool((diff <= bound).all()) else float("inf"))
            tol = max(tol, bound.max().item())
        del ref, diff, rows, bound
        # the shared-score function: S once and two PV products over the
        # valid rows and columns
        pairs = float((m0.sum(1).double() * m1.sum(1).double()).sum())
        res[N] = {"err": err, "tol": tol, **_bound(_nbytes(*args, *got), 6.0 * H * d * pairs, "bf16"),
                  "ms": _time_ms(lambda: bidir_cross_attention(*args)),
                  "plain_ms": _time_ms(lambda: bidir_cross_attention_reference(*args)),
                  "library_ms": _time_ms(lambda: (
                      sdpa(qk0, qk1, v1, attn_mask=m1[:, None, None, :]),
                      sdpa(qk1, qk0, v0, attn_mask=m0[:, None, None, :])))}
        del qk0, qk1, v0, v1, got, args
        torch.cuda.empty_cache()
    a, b = res[2048], res[4096]
    what = (f"valid rows, 2 bf16 ulps elementwise; (16, 4, 2048, 64) reported; ALIKED's (16, "
            f"4, 4096, 64): max err {b['err']:.3e}, kernel {b['ms']:.3f} ms, plain "
            f"{b['plain_ms']:.3f} ms, two sdpa {b['library_ms']:.3f} ms, bound "
            f"{b['bound_ms']:.3f} ms")
    extra = {k: v for k, v in a.items() if k not in ("err", "tol")}
    extra.update({"library_note": "two masked scaled_dot_product_attention calls, one per "
                                  "direction",
                  "aliked_shape": [16, 4, 4096, 64], "aliked_max_abs_err": b["err"],
                  **{f"aliked_{k}": v for k, v in b.items() if k not in ("err", "tol")}})
    # each shape is held to its own elementwise bound (inf on failure)
    return max(a["err"], b["err"]), max(a["tol"], b["tol"]), what, extra


def check_qkv(torch, dev, card):
    from deep_image_matching_tpu_torch.models.lightglue import cross_prologue, self_prologue
    from deep_image_matching_tpu_torch.ops.qkv import (
        proj_rotary_fused, proj_rotary_reference, rotate_half)

    gen = torch.Generator().manual_seed(18)
    # ALIKED's pair batch: 16 images of 4096 padded keypoints, width 256
    B, N, D, H = 16, 4096, 256, 4
    x = torch.randn(B, N, D, generator=gen).to(dev, torch.bfloat16)
    ang = torch.rand(B, N, 32, generator=gen) * 6.3
    # rounded to bf16 once per forward, as models/lightglue.py passes them
    cos = torch.repeat_interleave(torch.cos(ang), 2, -1).to(dev, torch.bfloat16)
    sin = torch.repeat_interleave(torch.sin(ang), 2, -1).to(dev, torch.bfloat16)
    res = {}
    for sections, rot in ((3, (0, 1)), (2, ())):
        w = (torch.randn(sections * D, D, generator=gen) / 16).to(dev, torch.bfloat16)
        b = (0.1 * torch.randn(sections * D, generator=gen)).to(dev, torch.bfloat16)
        args = (x, w, b, cos, sin, H, sections, rot)
        got = proj_rotary_fused(*args)
        ref = proj_rotary_reference(*args)
        y = proj_rotary_reference(x.float(), w, b, None, None, H, sections, ())
        torch.cuda.synchronize()
        err, tol, equal = 0.0, 0.0, 0.0
        for g, r, ys in zip(got, ref, y):
            diff = (g.float() - r.float()).abs()
            # bitwise but where the f32 products, summed in another order,
            # round t to the other side: one bf16 ulp of the operands there
            bound = 2.0 ** -7 * (r.float().abs() + ys.abs() + rotate_half(ys).abs())
            err = max(err, diff.max().item() if bool((diff <= bound).all()) else float("inf"))
            tol = max(tol, bound.max().item())
            equal += (g == r).float().mean().item() / sections
        del ref, y, diff, bound
        ins = (x, w, b, cos, sin) if rot else (x, w, b)
        # the path's own unfused prologue (models/lightglue.py) on the same
        # inputs: F.linear, the head split and, in self mode, the rotary
        if rot:
            p = {"t.self_attn.Wqkv.weight": w, "t.self_attn.Wqkv.bias": b}
            unfused = lambda: self_prologue(x, p, "t", cos, sin, H)  # noqa: E731
        else:
            p = {"c.to_qk.weight": w[:D], "c.to_qk.bias": b[:D],
                 "c.to_v.weight": w[D:], "c.to_v.bias": b[D:]}
            unfused = lambda: cross_prologue(x, p, "c", H)  # noqa: E731
        res[sections] = {"err": err, "tol": tol, "equal": equal,
                         **_bound(_nbytes(*ins, *got), 2.0 * B * N * D * sections * D, "bf16"),
                         "ms": _time_ms(lambda: proj_rotary_fused(*args)),
                         "plain_ms": _time_ms(lambda: proj_rotary_reference(*args)),
                         "library_ms": _time_ms(lambda: torch.nn.functional.linear(x, w, b)),
                         "unfused_ms": _time_ms(unfused)}
        del got
        torch.cuda.empty_cache()
    a, c = res[3], res[2]
    what = (f"bitwise but 1 bf16 ulp of the operands where the sums round t otherwise; self "
            f"mode (3 sections, rotary) at (65536, 256) reported, bitwise equal {a['equal']:.6f}; "
            f"cross mode (2 sections): max err {c['err']:.3e}, equal {c['equal']:.6f}, kernel "
            f"{c['ms']:.3f} ms, plain {c['plain_ms']:.3f} ms, F.linear {c['library_ms']:.3f} ms, "
            f"unfused prologue {c['unfused_ms']:.3f} ms, bound {c['bound_ms']:.3f} ms; self mode's "
            f"unfused prologue {a['unfused_ms']:.3f} ms")
    drop = ("err", "tol", "equal")
    extra = {k: v for k, v in a.items() if k not in drop}
    extra.update({"library_note": "F.linear(x, W, b) alone: without the head relayout and the "
                                  "rotary embedding",
                  "unfused_note": "the path's own unfused prologue (models/lightglue.py "
                                  "self_prologue / cross_prologue): F.linear, head split, rotary",
                  "shape": [B * N, D], "bitwise_equal_share": a["equal"],
                  "ptxas": _ptxas("qkv_sm90"),
                  "cross_max_abs_err": c["err"], "cross_bitwise_equal_share": c["equal"],
                  **{f"cross_{k}": v for k, v in c.items() if k not in drop}})
    # each mode is held to its own elementwise bound (inf on failure); a
    # bitwise-equal share below 99.9 % fails too
    if min(a["equal"], c["equal"]) < 0.999:
        return float("inf"), max(a["tol"], c["tol"]), what, extra
    return max(a["err"], c["err"]), max(a["tol"], c["tol"]), what, extra


# ---------------------------------------------------------------------------
# the float32 forms of kernels 1, 2, 6 and 10: split TF32 on the tensor cores,
# each held to its plain version in f32 (TF32 off in cuBLAS and cuDNN) with
# the tolerance its CPU model states (tests/test_torch_attention_tiles.py,
# tests/test_torch_f32_tiles.py), relative to the output's largest magnitude

# the attention kernels: f32 scores of |s| up to ~16 at these scales carry
# ~1e-6 relative rounding in both versions, which exp() turns into output
# errors of a few 1e-6 to 1e-5 of max|out| over 2048-4096 keys
F32_ATTENTION_TOL = 5e-5
# the FFN and the QKV prologue: split-TF32 products over K = 512 / 256
F32_PRODUCT_TOL = 1e-5


def _rel_err(got, ref, rows=None):
    """max |got - ref| / max |ref|, over ``rows`` (a bool mask) if given."""
    d, r = (got - ref).abs(), ref.abs()
    if rows is not None:
        d, r = d[rows], r[rows]
    return (d.max() / r.max()).item()


def check_attention_f32(torch, dev, card):
    from deep_image_matching_tpu_torch.ops.attention import (
        attention_reference, fused_attention)

    gen = torch.Generator().manual_seed(21)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, H, d = 16, 4, 64
    res = {}
    # LightGlue's (16, 4, 2048, 64) and SuperGlue's (16, 4, 4096, 64), whose
    # heads are interleaved across the channels, as in check_attention
    for T in (2048, 4096):
        if T == 2048:
            q, k, v = (torch.randn(B, H, T, d, generator=gen).mul(s).to(dev)
                       for s in (2.0, 2.0, 1.0))
        else:
            q, k, v = (torch.randn(B, T, H * d, generator=gen).mul(s).reshape(B, T, d, H)
                       .permute(0, 3, 1, 2).contiguous().to(dev) for s in (2.0, 2.0, 1.0))
        qm, km = _masks(torch, gen, B, T, dev), _masks(torch, gen, B, T, dev)
        scale = d ** -0.5
        got = fused_attention(q, k, v, qm, km, scale)
        ref = attention_reference(q, k, v, km, scale)
        torch.cuda.synchronize()
        err = _rel_err(got, ref, qm[:, None, :, None].expand_as(got))
        del got, ref
        pairs = float((qm.sum(1).double() * km.sum(1).double()).sum())
        mask = km[:, None, None, :]
        res[T] = {"err": err, **_bound(_nbytes(q, k, v, q) + qm.numel() + km.numel(),
                                       3 * 4.0 * H * d * pairs, "tf32"),
                  "ms": _time_ms(lambda: fused_attention(q, k, v, qm, km, scale)),
                  "plain_ms": _time_ms(lambda: attention_reference(q, k, v, km, scale)),
                  "library_ms": _time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale))}
        del q, k, v
        torch.cuda.empty_cache()
    a, b = res[2048], res[4096]
    what = (f"|err| / max|out| over valid rows; (16, 4, 2048, 64) reported; SuperGlue's "
            f"(16, 4, 4096, 64): err {b['err']:.3e}, kernel {b['ms']:.3f} ms, plain "
            f"{b['plain_ms']:.3f} ms, sdpa {b['library_ms']:.3f} ms, bound "
            f"{b['bound_ms']:.3f} ms")
    extra = {k: v for k, v in a.items() if k != "err"}
    extra.update({"library_note": "scaled_dot_product_attention in f32 with the same key mask",
                  "bound_note": "three TF32 products of the valid pairs at 495 TFLOP/s, or the "
                                "f32 bytes",
                  "ptxas": _ptxas("18attention_f32_sm90"), "superglue_shape": [B, H, 4096, d],
                  "superglue_max_abs_err": b["err"],
                  **{f"superglue_{k}": v for k, v in b.items() if k != "err"}})
    return max(a["err"], b["err"]), F32_ATTENTION_TOL, what, extra


def check_attention_hd96(torch, dev, card):
    """Kernel 1's head-dim-96 form at LighterGlue's shape, (16, 1, 4096, 96)
    bf16 with partial masks (a prefix count per pair; one pair full, one with
    37 valid points)."""
    from deep_image_matching_tpu_torch.ops.attention import (
        attention_reference, fused_attention)

    gen = torch.Generator().manual_seed(23)
    B, H, N, d = 16, 1, 4096, 96
    q, k, v = (torch.randn(B, H, N, d, generator=gen).mul(s).to(dev, torch.bfloat16)
               for s in (2.0, 2.0, 1.0))
    qm, km = _masks(torch, gen, B, N, dev), _masks(torch, gen, B, N, dev)
    err, tol, main = _attention_case(torch, fused_attention, attention_reference, q, k, v, qm, km)
    ptxas = _ptxas("19attention_hd96_sm90")
    spills = sum(i.get("spill_store_bytes", 0) + i.get("spill_load_bytes", 0)
                 for i in ptxas.values())
    if not ptxas or spills:
        _fail(f"attention_hd96: ptxas reports {spills} bytes of spills (or no entry): {ptxas}")
    what = ("valid query rows, 2 bf16 ulps elementwise; LighterGlue's (16, 1, 4096, 96), the "
            "wgmma / TMA core at D = 96: 192 rows a block, 64-key tiles of three 64-byte "
            "swizzled boxes, P V one m64n96k16 a k-step")
    return err, tol, what, {**main, "shape": [B, H, N, d], "ptxas": ptxas}


def check_attention_hd96_f32(torch, dev, card):
    """The same in float32 (the split-TF32 wgmma core at D = 96), held as
    kernel 1's float32 form is held."""
    from deep_image_matching_tpu_torch.ops.attention import (
        attention_reference, fused_attention)

    gen = torch.Generator().manual_seed(24)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, H, N, d = 16, 1, 4096, 96
    q, k, v = (torch.randn(B, H, N, d, generator=gen).mul(s).to(dev) for s in (2.0, 2.0, 1.0))
    qm, km = _masks(torch, gen, B, N, dev), _masks(torch, gen, B, N, dev)
    scale = d ** -0.5
    got = fused_attention(q, k, v, qm, km, scale)
    ref = attention_reference(q, k, v, km, scale)
    torch.cuda.synchronize()
    err = _rel_err(got, ref, qm[:, None, :, None].expand_as(got))
    del got, ref
    pairs = float((qm.sum(1).double() * km.sum(1).double()).sum())
    mask = km[:, None, None, :]
    extra = {**_bound(_nbytes(q, k, v, q) + qm.numel() + km.numel(), 3 * 4.0 * H * d * pairs,
                      "tf32"),
             "ms": _time_ms(lambda: fused_attention(q, k, v, qm, km, scale)),
             "plain_ms": _time_ms(lambda: attention_reference(q, k, v, km, scale)),
             "library_ms": _time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale)),
             "library_note": "scaled_dot_product_attention in f32 with the same key mask",
             "bound_note": "three TF32 products of the valid pairs at 495 TFLOP/s, or the f32 "
                           "bytes",
             "shape": [B, H, N, d], "ptxas": _ptxas("23attention_hd96_f32_sm90")}
    what = ("|err| / max|out| over valid rows; LighterGlue's (16, 1, 4096, 96) in f32, the "
            "split-TF32 wgmma core at D = 96: 128 rows a block, 32-key stages")
    return err, F32_ATTENTION_TOL, what, extra


def check_bidir_attention_f32(torch, dev, card):
    from deep_image_matching_tpu_torch.ops.bidir_attention import (
        bidir_cross_attention, bidir_cross_attention_reference)

    gen = torch.Generator().manual_seed(22)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, H, d = 16, 4, 64
    res = {}
    for N in (2048, 4096):
        qk0, qk1 = (torch.randn(B, H, N, d, generator=gen).mul(2.0).to(dev) for _ in range(2))
        v0, v1 = (torch.randn(B, H, N, d, generator=gen).to(dev) for _ in range(2))
        m0, m1 = _masks(torch, gen, B, N, dev), _masks(torch, gen, B, N, dev)
        args = (qk0, qk1, v0, v1, m0, m1)
        got = bidir_cross_attention(*args)
        ref = bidir_cross_attention_reference(*args)
        torch.cuda.synchronize()
        err = max(_rel_err(g, r, m[:, None, :, None].expand_as(g))
                  for g, r, m in zip(got, ref, (m0, m1)))
        pairs = float((m0.sum(1).double() * m1.sum(1).double()).sum())
        res[N] = {"err": err, **_bound(_nbytes(*args, *got), 3 * 6.0 * H * d * pairs, "tf32"),
                  "ms": _time_ms(lambda: bidir_cross_attention(*args)),
                  "plain_ms": _time_ms(lambda: bidir_cross_attention_reference(*args)),
                  "library_ms": _time_ms(lambda: (
                      sdpa(qk0, qk1, v1, attn_mask=m1[:, None, None, :]),
                      sdpa(qk1, qk0, v0, attn_mask=m0[:, None, None, :])))}
        del qk0, qk1, v0, v1, got, ref, args
        torch.cuda.empty_cache()
    a, b = res[2048], res[4096]
    what = (f"|err| / max|out| over valid rows; (16, 4, 2048, 64) reported; ALIKED's (16, 4, "
            f"4096, 64): err {b['err']:.3e}, kernel {b['ms']:.3f} ms, plain {b['plain_ms']:.3f} "
            f"ms, two sdpa {b['library_ms']:.3f} ms, bound {b['bound_ms']:.3f} ms")
    extra = {k: v for k, v in a.items() if k != "err"}
    extra.update({"library_note": "two masked scaled_dot_product_attention calls in f32",
                  "ptxas": _ptxas("bidir_attention_f32_sm90"), "aliked_shape": [B, H, 4096, d],
                  "aliked_max_abs_err": b["err"],
                  **{f"aliked_{k}": v for k, v in b.items() if k != "err"}})
    return max(a["err"], b["err"]), F32_ATTENTION_TOL, what, extra


def check_ffn_f32(torch, dev, card):
    from deep_image_matching_tpu_torch.ops.ffn import ffn_fused, ffn_reference, ffn_weights_tf32

    gen = torch.Generator().manual_seed(23)
    D = 256

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen) * s).to(dev)

    w1, w2 = rnd(2 * D, 2 * D, s=(2 * D) ** -0.5), rnd(D, 2 * D, s=(2 * D) ** -0.5)
    b1, beta, b2 = rnd(2 * D, s=0.1), rnd(2 * D, s=0.1), rnd(D, s=0.1)
    g = (1.0 + 0.1 * torch.randn(2 * D, generator=gen)).to(dev)
    split = ffn_weights_tf32(w1, w2)  # once, as the models make them
    res = {}
    for mode, K in (("ln_gelu", 2048), ("relu", 4096)):
        args = (rnd(16, K, D), rnd(16, K, D), w1, b1, g, beta, w2, b2)
        got = ffn_fused(*args, mode=mode, split=split)
        ref = ffn_reference(*args, mode=mode)
        torch.cuda.synchronize()
        res[mode] = {"err": _rel_err(got, ref),
                     **_bound(_nbytes(*args, args[0]),
                              3 * 2.0 * 16 * K * (4 * D * D + 2 * D * D), "tf32"),
                     "ms": _time_ms(lambda: ffn_fused(*args, mode=mode, split=split)),
                     "plain_ms": _time_ms(lambda: ffn_reference(*args, mode=mode))}
        del args, got, ref
    a, b = res["ln_gelu"], res["relu"]
    what = (f"|err| / max|out|; ln_gelu (16, 2048, 256) reported; relu (16, 4096, 256): err "
            f"{b['err']:.3e}, kernel {b['ms']:.3f} ms, plain {b['plain_ms']:.3f} ms, bound "
            f"{b['bound_ms']:.3f} ms")
    extra = {k: v for k, v in a.items() if k != "err"}
    extra.update({"library_ms": None,
                  "library_note": "none: LayerNorm, GELU (or ReLU) and two products; no single "
                                  "PyTorch call does all of them",
                  "ptxas": _ptxas("ffn_f32_sm90"), "relu_shape": [16, 4096, D],
                  "relu_max_abs_err": b["err"],
                  **{f"relu_{k}": v for k, v in b.items() if k != "err"}})
    return max(a["err"], b["err"]), F32_PRODUCT_TOL, what, extra


def check_qkv_f32(torch, dev, card):
    from deep_image_matching_tpu_torch.ops.qkv import (
        proj_rotary_fused, proj_rotary_reference, weights_tf32)

    gen = torch.Generator().manual_seed(24)
    B, N, D, H = 16, 4096, 256, 4
    x = torch.randn(B, N, D, generator=gen).to(dev)
    ang = torch.rand(B, N, 32, generator=gen) * 6.3
    cos = torch.repeat_interleave(torch.cos(ang), 2, -1).to(dev)
    sin = torch.repeat_interleave(torch.sin(ang), 2, -1).to(dev)
    res = {}
    for sections, rot in ((3, (0, 1)), (2, ())):
        w = (torch.randn(sections * D, D, generator=gen) / 16).to(dev)
        b = (0.1 * torch.randn(sections * D, generator=gen)).to(dev)
        split = weights_tf32(w)  # once, as models/lightglue.py makes it
        args = (x, w, b, cos, sin, H, sections, rot)
        got = proj_rotary_fused(*args, split=split)
        ref = proj_rotary_reference(*args)
        torch.cuda.synchronize()
        ins = (x, w, b, cos, sin) if rot else (x, w, b)
        res[sections] = {"err": max(_rel_err(g, r) for g, r in zip(got, ref)),
                         **_bound(_nbytes(*ins, *got), 3 * 2.0 * B * N * D * sections * D,
                                  "tf32"),
                         "ms": _time_ms(lambda: proj_rotary_fused(*args, split=split)),
                         "plain_ms": _time_ms(lambda: proj_rotary_reference(*args)),
                         "library_ms": _time_ms(lambda: torch.nn.functional.linear(x, w, b))}
        del got, ref
        torch.cuda.empty_cache()
    a, c = res[3], res[2]
    what = (f"|err| / max|out|; self mode (3 sections, rotary) at (65536, 256) reported; cross "
            f"mode (2 sections): err {c['err']:.3e}, kernel {c['ms']:.3f} ms, plain "
            f"{c['plain_ms']:.3f} ms, F.linear {c['library_ms']:.3f} ms, bound "
            f"{c['bound_ms']:.3f} ms")
    extra = {k: v for k, v in a.items() if k != "err"}
    extra.update({"library_note": "F.linear(x, W, b) in f32 alone: without the head relayout "
                                  "and the rotary embedding",
                  "shape": [B * N, D], "ptxas": _ptxas("qkv_f32_sm90"),
                  "cross_max_abs_err": c["err"],
                  **{f"cross_{k}": v for k, v in c.items() if k != "err"}})
    return max(a["err"], c["err"]), F32_PRODUCT_TOL, what, extra


def phase_kernels(card: str) -> dict:
    """Each kernel against its plain version, the plain versions' products and
    convolutions in full f32 (``utils/device.full_f32``, which restores the
    default settings after: the paths run as a user's run does)."""
    from deep_image_matching_tpu_torch.utils.device import full_f32

    with full_f32():
        return _phase_kernels(card)


def _phase_kernels(card: str) -> dict:
    import torch

    dev = torch.device("cuda", 0)
    checks = {"attention": check_attention, "ffn": check_ffn,
              "assignment": check_assignment, "nullspace": check_nullspace,
              "nn": check_nn, "sinkhorn": check_sinkhorn, "lse_rows": check_lse_rows,
              "refiner": check_refiner, "bidir_attention": check_bidir_attention,
              "qkv": check_qkv, "attention_f32": check_attention_f32,
              "ffn_f32": check_ffn_f32, "bidir_attention_f32": check_bidir_attention_f32,
              "qkv_f32": check_qkv_f32, "attention_hd96": check_attention_hd96,
              "attention_hd96_f32": check_attention_hd96_f32}
    report = {}
    ok = True
    for name, fn in checks.items():
        err, tol, what, extra = fn(torch, dev, card)
        good = err <= tol
        ok &= good
        report[name] = {"max_abs_err": err, **extra}
        torch.cuda.empty_cache()
        lib = "none" if extra["library_ms"] is None else f"{extra['library_ms']:.3f} ms"
        print(f"[kernel] {name}: max_abs_err {err:.3e} (tol {tol:.1e}, {what}) "
              f"{'OK' if good else 'FAIL'}; kernel {extra['ms']:.3f} ms, plain "
              f"{extra['plain_ms']:.3f} ms, bound {extra['bound_ms']:.3f} ms "
              f"({extra['bound_by']}), library call {lib} [{card}]", flush=True)
        for Dw, w in extra.get("widths", {}).items():
            print(f"[kernel] {name} at D = {Dw}: max_abs_err {w['max_abs_err']:.3e}; kernel "
                  f"{w['ms']:.3f} ms, plain {w['plain_ms']:.3f} ms, bound {w['bound_ms']:.3f} ms "
                  f"({w['bound_by']}), {100 * w['bound_ms'] / w['ms']:.1f} % of the bound "
                  f"[{card}]", flush=True)
        if extra.get("device_ms") is not None:
            print(f"[kernel] {name}: device time of its own kernels {extra['device_ms']:.4f} ms "
                  f"a call (torch.profiler), against {extra['ms']:.4f} ms between CUDA events "
                  f"[{card}]", flush=True)
        if extra.get("ptxas"):
            info = extra["ptxas"].values()
            print(f"[kernel] {name}: ptxas, {len(info)} entry functions: "
                  f"{min(i['registers'] for i in info)}-{max(i['registers'] for i in info)} "
                  f"registers, {sum(i['spill_store_bytes'] + i['spill_load_bytes'] for i in info)} "
                  f"bytes of spills", flush=True)
    if not ok:
        _fail("a kernel disagrees with its plain version")
    return report


def _synthetic_project(root: Path, n: int = 16, size=1024, seed: int = 0,
                       shifts: dict = SHIFTS) -> Path:
    """``n`` views of one textured plane, written as PNG, ``size`` pixels
    square or (w, h): random homographies (small rotation, scale, shear and
    shift), except that the last views are view 0 shifted by ``shifts``
    (view index from the end -> (dx, dy) in whole SuperPoint cells). Random
    weights give no confident matches between warped views, but shifted
    copies keep their descriptors, so those pairs do match and reach
    verification (a pure translation: the f33 = 0 case of the null-space
    solve)."""
    import cv2
    import numpy as np

    w, h = (size, size) if isinstance(size, int) else size
    rng = np.random.default_rng(seed)
    big_w, big_h = 2 * w, 2 * h
    tex = rng.integers(0, 256, (big_h, big_w), dtype=np.uint8)
    tex = cv2.GaussianBlur(tex, (0, 0), 4)
    # blobs and strokes for corners at several scales, about as many per
    # pixel as at 1024 x 1024 (drawn over the longer side's square; those
    # beyond the shorter side fall off the texture)
    big = max(big_w, big_h)
    for _ in range(max(300, 300 * big * big // (2048 * 2048))):
        c = tuple(int(v) for v in rng.integers(0, big, 2))
        col = int(rng.integers(0, 256))
        if rng.random() < 0.5:
            cv2.circle(tex, c, int(rng.integers(4, 40)), col, -1)
        else:
            d = tuple(int(v) for v in rng.integers(0, big, 2))
            cv2.line(tex, c, d, col, int(rng.integers(1, 6)))
    tex = cv2.normalize(tex, None, 0, 255, cv2.NORM_MINMAX)
    img_dir = root / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    center = np.array([big_w / 2, big_h / 2])
    spread = 200 * max(w, h) / 1024
    png = [cv2.IMWRITE_PNG_COMPRESSION, 1]
    H0 = None
    for i in range(n):
        if i - n in shifts and H0 is not None:
            shift = np.eye(3)
            shift[:2, 2] = shifts[i - n]
            view = cv2.warpPerspective(tex, H0 @ shift, (w, h),
                                       flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
            cv2.imwrite(str(img_dir / f"view_{i:02d}.png"), view, png)
            continue
        ang = rng.uniform(-0.2, 0.2)
        s = rng.uniform(0.8, 1.2)
        R = s * np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
        R = R + rng.normal(0, 0.03, (2, 2))
        t = center - R @ np.array([w / 2, h / 2]) + rng.uniform(-spread, spread, 2)
        H = np.eye(3)
        H[:2, :2], H[:2, 2] = R, t
        H[2, :2] = rng.normal(0, 5e-5 * 1024 / max(w, h), 2)
        if i == 0:
            H[2, :2] = 0.0  # affine, so a shifted copy is an exact pixel shift
            H0 = H
        view = cv2.warpPerspective(tex, H, (w, h), flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
        cv2.imwrite(str(img_dir / f"view_{i:02d}.png"), view, png)
    return root


class _TimerLog:
    """Collects the port's '[Timer]' log lines (the per-stage wall times)."""

    def __init__(self):
        import logging

        self.lines = []
        self.handler = logging.Handler()
        self.handler.emit = lambda rec: (
            self.lines.append(rec.getMessage()) if "[Timer]" in rec.getMessage() else None)
        logging.getLogger("dim_tpu_torch").addHandler(self.handler)


def _check_outputs(out_dir: Path, names: list, n_pairs: int, dim: int):
    """Check a run's files; returns a summary line and the number of
    verified pairs."""
    import sqlite3

    import numpy as np

    from deep_image_matching_tpu_torch.io import hdf5

    feats, raw, ver = out_dir / "features.h5", out_dir / "raw_matches.h5", out_dir / "matches.h5"
    counts = {}
    with hdf5.File(feats, "r") as f:
        if sorted(f.keys()) != sorted(names):
            _fail(f"features.h5 holds {len(f.keys())} of {len(names)} images")
        for name in names:
            k = np.asarray(f[name]["keypoints"])
            d = np.asarray(f[name]["descriptors"])
            w, h = np.asarray(f[name]["image_size"])
            if not (np.isfinite(k).all() and np.isfinite(d).all()) or d.shape != (dim, len(k)):
                _fail(f"features of {name}: bad values or shape {d.shape}")
            if len(k) and (k.min() < 0 or k[:, 0].max() >= w or k[:, 1].max() >= h):
                _fail(f"keypoints of {name} outside the image")
            counts[name] = len(k)

    def pairs_of(path):
        out = []
        if path.exists():
            with hdf5.File(path, "r") as f:
                for a in f:
                    for b in f[a]:
                        m = np.asarray(f[a][b])
                        if len(m) and (m.min() < 0 or m[:, 0].max() >= counts[a]
                                       or m[:, 1].max() >= counts[b]):
                            _fail(f"match indices of {a}-{b} out of range")
                        out.append((a, b, len(m)))
        return out

    raw_pairs, ver_pairs = pairs_of(raw), pairs_of(ver)
    if len(raw_pairs) != n_pairs:
        _fail(f"raw_matches.h5 holds {len(raw_pairs)} of {n_pairs} pairs")
    db = sqlite3.connect(str(out_dir / "database.db"))
    try:
        n_img = db.execute("SELECT COUNT(*) FROM images").fetchone()[0]
        n_kp = db.execute("SELECT COUNT(*) FROM keypoints").fetchone()[0]
        n_m = db.execute("SELECT COUNT(*) FROM matches").fetchone()[0]
        n_tv = db.execute("SELECT COUNT(*) FROM two_view_geometries").fetchone()[0]
    finally:
        db.close()
    if n_img != len(names) or n_m != len(raw_pairs) or n_tv != len(ver_pairs):
        _fail(f"database.db: {n_img} images, {n_m} match rows, {n_tv} two-view rows; "
              f"expected {len(names)}, {len(raw_pairs)}, {len(ver_pairs)}")
    if n_kp != sum(1 for c in counts.values() if c):
        _fail(f"database.db: {n_kp} keypoint rows")
    n_raw = sum(n for _, _, n in raw_pairs)
    n_ver = sum(n for _, _, n in ver_pairs)
    return (f"{len(names)} images, {sum(counts.values())} keypoints, {len(raw_pairs)} pairs "
            f"({n_raw} raw matches), {len(ver_pairs)} verified pairs ({n_ver} inliers)",
            len(ver_pairs))


def _check_dense_outputs(out_dir: Path, names: list, n_pairs: int, num: int = 5000):
    """A detector-free run's files: each image's keypoints are the samples
    its pairs appended, each pair holds (0, num] raw matches, and when a pair
    verified the multiview merge wrote its files and the database was
    exported again from them. Returns a summary line and the number of
    verified pairs."""
    import sqlite3

    import numpy as np

    from deep_image_matching_tpu_torch.io import hdf5

    counts, appended = {}, {}
    with hdf5.File(out_dir / "features.h5", "r") as f:
        if sorted(f.keys()) != sorted(names):
            _fail(f"features.h5 holds {len(f.keys())} of {len(names)} images")
        for name in names:
            k = np.asarray(f[name]["keypoints"])
            w, h = np.asarray(f[name]["image_size"])
            if not np.isfinite(k).all() or (len(k) and (k.min() < 0 or k[:, 0].max() > w
                                                        or k[:, 1].max() > h)):
                _fail(f"keypoints of {name} are not finite or lie outside the image")
            counts[name], appended[name] = len(k), 0

    def pairs_of(path):
        out = []
        if path.exists():
            with hdf5.File(path, "r") as f:
                for a in f:
                    for b in f[a]:
                        out.append((a, b, np.asarray(f[a][b])))
        return out

    raw = pairs_of(out_dir / "raw_matches.h5")
    if len(raw) != n_pairs:
        _fail(f"raw_matches.h5 holds {len(raw)} of {n_pairs} pairs")
    for a, b, m in raw:
        if not 0 < len(m) <= num or m[:, 0].max() >= counts[a] or m[:, 1].max() >= counts[b]:
            _fail(f"raw matches of {a}-{b}: {len(m)} rows or indices out of range")
        appended[a] += len(m)
        appended[b] += len(m)
    if appended != counts:
        _fail(f"keypoints per image {counts} are not the samples of their pairs {appended}")
    ver = pairs_of(out_dir / "matches.h5")
    mv = out_dir / "multiview"
    db = sqlite3.connect(str(out_dir / "database.db"))
    try:
        n_img, n_kp, n_m, n_tv = (db.execute(f"SELECT COUNT(*) FROM {t}").fetchone()[0]
                                  for t in ("images", "keypoints", "matches",
                                            "two_view_geometries"))
    finally:
        db.close()
    if ver:
        if not (mv / "features_multiview.h5").exists():
            _fail("pairs verified but the multiview merge wrote nothing")
        mv_pairs = pairs_of(mv / "matches_multiview.h5")
        with hdf5.File(mv / "features_multiview.h5", "r") as f:
            mv_imgs = len(f.keys())
        # the export from the merged files: their images, keypoints and
        # verified pairs, no raw matches
        expect = (mv_imgs, mv_imgs, 0, len(mv_pairs))
        merged = f"; multiview: {mv_imgs} images, {len(mv_pairs)} pairs"
    else:
        if mv.exists():
            _fail("no pair verified but a multiview directory exists")
        expect = (len(names), sum(1 for c in counts.values() if c), len(raw), 0)
        merged = "; no pair verified, no multiview merge"
    if (n_img, n_kp, n_m, n_tv) != expect:
        _fail(f"database.db: images, keypoints, matches, two-view rows {(n_img, n_kp, n_m, n_tv)}"
              f", expected {expect}")
    sizes = sorted(len(m) for _, _, m in raw)
    return (f"{len(names)} images, {sum(counts.values())} keypoints, {len(raw)} pairs "
            f"({sizes[0]}-{sizes[-1]} raw matches each), {len(ver)} verified pairs "
            f"({sum(len(m) for _, _, m in ver)} inliers){merged}; database {n_img} images, "
            f"{n_kp} keypoint rows, {n_m} match rows, {n_tv} two-view rows", len(ver))


def _check_shifted(out_dir: Path, names: list, shifts: dict = SHIFTS) -> str:
    """Verified matches between view 0 and its shifted copies must carry
    the planted shift, and at least one such pair must verify."""
    import numpy as np

    from deep_image_matching_tpu_torch.io import hdf5

    shift = {names[0]: np.zeros(2)}
    shift.update({names[k]: np.asarray(v, float) for k, v in shifts.items()})
    done = []
    with hdf5.File(out_dir / "features.h5", "r") as f, \
            hdf5.File(out_dir / "matches.h5", "r") as m:
        for a in m:
            for b in m[a]:
                if a not in shift or b not in shift:
                    continue
                mt = np.asarray(m[a][b])
                d = (np.asarray(f[a]["keypoints"])[mt[:, 0]]
                     - np.asarray(f[b]["keypoints"])[mt[:, 1]])
                err = np.median(np.abs(d - (shift[b] - shift[a])).max(1))
                if err > 1.0:
                    _fail(f"verified matches {a}-{b} are off the planted shift by {err:.2f} px")
                done.append(f"{a}-{b} {len(mt)}")
    if not done:
        _fail("no pair of view 0 and its shifted copies verified")
    return "shifted pairs verified: " + ", ".join(done)


def phase_reference(card: str) -> None:
    import torch

    _reference_lightglue(card)
    _reference_lightglue(card, optins=True)
    _reference_aliked(card)
    _reference_superglue(card)
    # the float32 forms of kernels 1, 2, 6 and 10
    _reference_lightglue(card, dtype=torch.float32)
    _reference_lightglue(card, optins=True, dtype=torch.float32)
    _reference_superglue(card, dtype=torch.float32)
    _reference_roma(card)
    _full_depth_roma(card)


def _agreement(cpu: dict, gpu: dict) -> tuple:
    """Card against CPU: the rows whose match or validity differ
    (near-ties of the argmax or of the score threshold, from sums in another
    order) and the largest score difference on the rows valid in both."""
    import torch

    g = {k: v.cpu() for k, v in gpu.items() if torch.is_tensor(v)}
    differ = int(((cpu["matches0"] != g["matches0"]) | (cpu["valid0"] != g["valid0"])).sum())
    both = cpu["valid0"] & g["valid0"]
    score = (cpu["matching_scores0"] - g["matching_scores0"]).abs()[both]
    return differ, (score.max().item() if score.numel() else 0.0)


def _reference_lightglue(card: str, optins: bool = False, dtype=None) -> None:
    """LightGlue at full width (9 layers, D = 256, adaptive depth and width
    pruning) on a small batch: the kernels on the card against the plain
    versions on the CPU, both in ``dtype`` (bf16 by default). Image 1 holds
    image 0's keypoints permuted and shifted with the same descriptors, so
    matches exist. With ``optins`` the cross attention runs on kernel 6
    (``attn_impl="bidir"``) and the prologue on kernel 10
    (``DIM_TPU_FUSED_PROLOGUE=1``, set for this check only), on both
    devices. In float32 the matches must be equal but for near-ties (at most
    one row in 1000) and the scores within 1e-4 (the CPU tests' tolerance)."""
    import torch

    from deep_image_matching_tpu_torch.models.lightglue import LightGlue, forward
    from deep_image_matching_tpu_torch.ops import _lib
    from deep_image_matching_tpu_torch.utils.device import full_f32

    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32

    gen = torch.Generator().manual_seed(7)
    B, K = 2, 512
    model = LightGlue().reset_random(gen).eval()
    kpts0 = torch.rand(B, K, 2, generator=gen) * torch.tensor([640.0, 480.0])
    perm = torch.stack([torch.randperm(K, generator=gen) for _ in range(B)])
    kpts1 = torch.gather(kpts0, 1, perm[..., None].expand(-1, -1, 2)) + torch.tensor([24.0, -16.0])
    desc0 = torch.nn.functional.normalize(torch.randn(B, K, 256, generator=gen), dim=-1)
    desc1 = torch.gather(desc0, 1, perm[..., None].expand(-1, -1, 256))
    mask = torch.ones(B, K, dtype=torch.bool)
    mask[1, 400:] = False
    size = torch.tensor([[640.0, 480.0]]).expand(B, 2)
    kw = dict(filter_threshold=0.0, depth_confidence=0.95, width_confidence=0.99,
              pruning_min_kpts=128, compute_dtype=dtype,
              attn_impl="bidir" if optins else "flash")
    args = (kpts0, kpts1, desc0, desc1, mask, torch.gather(mask, 1, perm), size, size)
    with _env({"DIM_TPU_FUSED_PROLOGUE": "1" if optins else "0"}), full_f32():
        cpu = forward(model, *args, **kw)
        dev = torch.device("cuda", 0)
        _lib.reset_launch_counts()
        gpu = forward(model.to(dev), *(a.to(dev) for a in args), **kw)
        torch.cuda.synchronize()
        launched = {k: v for k, v in _lib.LAUNCHES.items() if v}
    model.cpu()
    both = cpu["valid0"] & gpu["valid0"].cpu()
    agree = (cpu["matches0"] == gpu["matches0"].cpu())[both].float().mean().item()
    inv = torch.argsort(perm, dim=1)
    truth = (gpu["matches0"].cpu() == inv) & gpu["valid0"].cpu()
    name = ("LightGlue bidir + fused prologue" if optins else "LightGlue") + f" ({dtype})"
    differ, score_err = _agreement(cpu, gpu)
    print(f"[ref] {name} B={B} K={K}: layers_run cpu {cpu['layers_run']} gpu "
          f"{gpu['layers_run']}; mutual matches cpu {int(cpu['valid0'].sum())} gpu "
          f"{int(gpu['valid0'].sum())}; agreement on rows matched by both {agree:.4f}; rows "
          f"that differ {differ}; max score difference {score_err:.3e}; gpu matches at the "
          f"planted correspondence {int(truth.sum())}; launches {launched} [{card}]", flush=True)
    # bf16 on both sides, sums in another order: rare flips of near-ties
    # only, and the exit layer must agree; in f32 near-ties only
    planted_cpu = int(((cpu["matches0"] == inv) & cpu["valid0"]).sum())
    if cpu["layers_run"] != gpu["layers_run"] or agree < 0.99 or truth.sum() < 0.95 * planted_cpu:
        _fail(f"{name} on the card disagrees with the plain versions on the CPU")
    if f32 and (differ > B * K // 1000 or score_err > 1e-4):
        _fail(f"{name}: {differ} rows differ, scores by {score_err:.3e}")
    n = gpu["layers_run"]
    sfx = "_f32" if f32 else ""
    want = ({f"bidir_attention{sfx}": n, f"qkv{sfx}": 4 * n, f"attention{sfx}": 2 * n} if optins
            else {f"attention{sfx}": 4 * n})
    want[f"ffn{sfx}"] = 4 * n
    if any(launched.get(k) != v for k, v in want.items()):
        _fail(f"{name}: launches {launched}, expected {want}")


def aliked_state_dict(seed: int = 0) -> dict:
    """A seeded ``aliked-n16rot`` checkpoint in the upstream key layout (ALIKED
    has no random initialisation): He-normal convolutions, BatchNorm with
    running statistics, small deformable offsets, and a score head scaled so
    that a share of the sigmoid scores clears the 0.2 detection threshold
    without saturating, and the coarse blocks' share of the features damped.
    ``tests/test_torch_aliked.py`` builds the same."""
    import numpy as np
    import torch

    from deep_image_matching_tpu_torch.models.aliked import CFGS

    rng = np.random.default_rng(seed)
    c1, c2, c3, c4, dim, K, M = CFGS["aliked-n16rot"]
    sd = {}

    def conv(name, co, ci, k, bias=False, std=None):
        std = (2.0 / (ci * k * k)) ** 0.5 if std is None else std
        sd[f"{name}.weight"] = rng.normal(0, std, (co, ci, k, k))
        if bias:
            sd[f"{name}.bias"] = rng.normal(0, 0.05, co)

    def bn(name, n):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, n)
        sd[f"{name}.bias"] = rng.normal(0, 0.1, n)
        sd[f"{name}.running_mean"] = rng.normal(0, 0.1, n)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, n)
        sd[f"{name}.num_batches_tracked"] = np.array(0)

    conv("block1.conv1", c1, 3, 3)
    bn("block1.bn1", c1)
    conv("block1.conv2", c1, c1, 3)
    bn("block1.bn2", c1)
    conv("block2.conv1", c2, c1, 3)
    bn("block2.bn1", c2)
    conv("block2.conv2", c2, c2, 3)
    bn("block2.bn2", c2)
    conv("block2.downsample", c2, c1, 1, bias=True)
    for blk, ci, co in (("block3", c2, c3), ("block4", c3, c4)):
        for j, cin in ((1, ci), (2, co)):
            conv(f"{blk}.conv{j}.offset_conv", 18, cin, 3, bias=True, std=0.5 / (cin * 9) ** 0.5)
            conv(f"{blk}.conv{j}.regular_conv", co, cin, 3)
            bn(f"{blk}.bn{j}", co)
        conv(f"{blk}.downsample", co, ci, 1, bias=True)
    for i, c in enumerate((c1, c2, c3, c4), 1):
        # the /8 and /32 blocks' align-corners upsampling is not shift
        # equivariant: damped, so shifted copies of a view keep most of
        # their keypoints and descriptors
        conv(f"conv{i}", dim // 4, c, 1, std=(2.0 / c) ** 0.5 * (0.1 if i > 2 else 1.0))
    conv("score_head.0", 8, dim, 1)
    conv("score_head.2", 4, 8, 3)
    conv("score_head.4", 4, 4, 3)
    conv("score_head.6", 1, 4, 3, std=0.05)
    conv("desc_head.offset_conv.0", 2 * M, dim, K, bias=True, std=0.5 / (dim * K * K) ** 0.5)
    conv("desc_head.offset_conv.2", 2 * M, 2 * M, 1, bias=True)
    conv("desc_head.sf_conv", dim, dim, 1)
    sd["desc_head.agg_weights"] = rng.normal(0, (1.0 / (M * dim)) ** 0.5, (M, dim, dim))
    return {k: torch.tensor(v, dtype=torch.int64 if v.ndim == 0 else torch.float32)
            for k, v in sd.items()}


def _reference_aliked(card: str) -> None:
    """ALIKED (aliked-n16rot, full width, the seeded checkpoint) on one demo
    image at 480 x 640, f32 on both devices (TF32 off): the keypoint sets on
    the card and on the CPU, and the descriptors of the shared keypoints."""
    import numpy as np
    import torch

    from deep_image_matching_tpu_torch.models import aliked
    from deep_image_matching_tpu_torch.utils.device import full_f32
    from deep_image_matching_tpu_torch.utils.image import read_image

    img = read_image(ROOT / "notebooks" / "demo_project" / "images" / "sacre_coeur_A.jpg",
                     grayscale=False)
    params = aliked.params_from_torch(aliked_state_dict())
    dev = torch.device("cuda", 0)
    batch = torch.from_numpy(img)[None]
    vhw = torch.tensor([img.shape[:2]])
    kw = dict(max_keypoints=4000, detection_threshold=0.2, nms_radius=3)
    t0 = time.perf_counter()
    cpu = aliked.extract(params, batch, vhw, **kw)
    t_cpu = time.perf_counter() - t0
    with full_f32():
        gpu = aliked.extract(aliked.tree_map(lambda t: t.to(dev), params), batch.to(dev),
                             vhw.to(dev), **kw)
        torch.cuda.synchronize()
    kc = cpu["keypoints"][0][cpu["mask"][0]].double()
    kg = gpu["keypoints"][0][gpu["mask"][0]].cpu().double()
    dist = torch.cdist(kc, kg, p=float("inf"))
    near, idx = dist.min(1)
    shared = near <= 1e-3
    d_err = (cpu["descriptors"][0][cpu["mask"][0]][shared]
             - gpu["descriptors"][0][gpu["mask"][0]].cpu()[idx[shared]]).abs().max().item()
    share = shared.float().mean().item()
    print(f"[ref] ALIKED 480 x 640, f32: keypoints cpu {len(kc)} gpu {len(kg)}, {share:.5f} of "
          f"the CPU's within 1e-3 px on the card; descriptors of those within {d_err:.2e} (CPU "
          f"run {t_cpu:.1f} s) [{card}]", flush=True)
    # f32 sums in another order can move a near-tie across NMS or the
    # threshold: nearly all keypoints must agree
    if len(kc) < 1000 or abs(len(kc) - len(kg)) > 0.01 * len(kc) or share < 0.99 or d_err > 1e-3:
        _fail("ALIKED on the card disagrees with the CPU")


def _reference_superglue(card: str, dtype=None) -> None:
    """SuperGlue at full width (9 blocks, D = 256, 4 heads, 100 Sinkhorn
    iterations) on a small batch: the kernels on the card (attention, the
    FFN's relu mode, Sinkhorn) against the plain versions on the CPU, both in
    ``dtype`` (bf16 by default; in float32 the matches equal but for
    near-ties, the scores within 1e-3 after the 100 iterations). Image 1 holds
    image 0's keypoints permuted, with the same descriptors and scores, so
    every valid keypoint has a planted match."""
    import torch

    from deep_image_matching_tpu_torch.models.superglue import SuperGlue, forward
    from deep_image_matching_tpu_torch.ops import _lib
    from deep_image_matching_tpu_torch.utils.device import full_f32

    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32

    gen = torch.Generator().manual_seed(9)
    B, K = 2, 1024
    model = SuperGlue().reset_random(gen).eval()
    kpts0 = torch.rand(B, K, 2, generator=gen) * torch.tensor([640.0, 480.0])
    perm = torch.stack([torch.randperm(K, generator=gen) for _ in range(B)])
    kpts1 = torch.gather(kpts0, 1, perm[..., None].expand(-1, -1, 2))
    desc0 = torch.nn.functional.normalize(torch.randn(B, K, 256, generator=gen), dim=-1)
    desc1 = torch.gather(desc0, 1, perm[..., None].expand(-1, -1, 256))
    sc0 = torch.rand(B, K, generator=gen)
    mask = torch.ones(B, K, dtype=torch.bool)
    mask[1, 800:] = False
    size = torch.tensor([[640.0, 480.0]]).expand(B, 2)
    args = (kpts0, kpts1, sc0, torch.gather(sc0, 1, perm), desc0, desc1, mask,
            torch.gather(mask, 1, perm), size, size)
    kw = dict(sinkhorn_iterations=100, match_threshold=0.0, compute_dtype=dtype)
    with full_f32():
        cpu = forward(model, *args, **kw)
        dev = torch.device("cuda", 0)
        _lib.reset_launch_counts()
        gpu = forward(model.to(dev), *(a.to(dev) for a in args), **kw)
        torch.cuda.synchronize()
        launched = {k: v for k, v in _lib.LAUNCHES.items() if v}
    model.cpu()
    both = cpu["valid0"] & gpu["valid0"].cpu()
    agree = (cpu["matches0"] == gpu["matches0"].cpu())[both].float().mean().item()
    inv = torch.argsort(perm, dim=1)
    truth = (gpu["matches0"].cpu() == inv) & gpu["valid0"].cpu()
    planted_cpu = int(((cpu["matches0"] == inv) & cpu["valid0"]).sum())
    differ, score_err = _agreement(cpu, gpu)
    print(f"[ref] SuperGlue ({dtype}) B={B} K={K}: mutual matches cpu "
          f"{int(cpu['valid0'].sum())} gpu {int(gpu['valid0'].sum())}; agreement on rows "
          f"matched by both {agree:.4f}; rows that differ {differ}; max score difference "
          f"{score_err:.3e}; planted matches found cpu {planted_cpu} gpu {int(truth.sum())} of "
          f"{int(mask.sum())}; launches {launched} [{card}]", flush=True)
    # bf16 on both sides, sums in another order: the LightGlue phase's bar
    if agree < 0.99 or truth.sum() < 0.95 * planted_cpu:
        _fail("SuperGlue on the card disagrees with the plain versions on the CPU")
    # in f32: near-ties only, and the scores within 1e-3, the bound
    # check_sinkhorn holds u and v to after the same 100 iterations
    if f32 and (differ > B * K // 1000 or score_err > 1e-3):
        _fail(f"SuperGlue ({dtype}): {differ} rows differ, scores by {score_err:.3e}")
    sfx = "_f32" if f32 else ""
    if not (launched.get(f"attention{sfx}") and launched.get(f"ffn{sfx}")
            and launched.get("sinkhorn")):
        _fail(f"SuperGlue ({dtype}): launches {launched}")


def _demo_pair(torch, sizes, dev):
    """Two demo images as uint8 (1, s, s, 3) at each side length of
    ``sizes``, as the RoMa matcher resizes them."""
    from deep_image_matching_tpu_torch.utils.image import read_image, resize_image

    demo = ROOT / "notebooks" / "demo_project" / "images"
    full = [read_image(demo / n, grayscale=False) for n in ("sacre_coeur_A.jpg",
                                                             "sacre_coeur_B.jpg")]
    return [[torch.from_numpy(resize_image(im, (s, s)))[None].to(dev) for im in full]
            for s in sizes]


def _share_within(got, ref, rel):
    """The share of elements within rel * max|ref| of the reference."""
    return ((got.cpu() - ref).abs() <= rel * ref.abs().max()).float().mean().item()


def _reference_roma(card: str) -> None:
    """RoMa with a 2-block DINOv2 on one pair at 224 / 320 px: the kernels
    on the card (attention in DINOv2, the refiner at scale 1) against the
    plain versions on the CPU, on shared weights; DINOv2 in bf16, the
    decoder in f32, TF32 off. Then the sampler on the card with the CPU's
    draws injected, on the CPU's warps."""
    import torch

    from deep_image_matching_tpu_torch.models import dinov2, roma
    from deep_image_matching_tpu_torch.utils.device import full_f32, to_device

    dev = torch.device("cuda", 0)
    params = roma.init_params(dinov2_depth=2)
    params = {**params, "dinov2": dinov2.prepare(params["dinov2"], torch.bfloat16)}
    on_card = to_device(params, dev)
    (a, b), (ah, bh) = _demo_pair(torch, (224, 320), "cpu")

    def two_passes(p, d):
        out = roma.match_pair(p, a.to(d), b.to(d), with_cert16=True)
        return roma.match_pair_upsample(p, ah.to(d), bh.to(d), *out[:4], scale_factor=320 / 224,
                                        cert16_ab=out[4], cert16_ba=out[5])

    t0 = time.perf_counter()
    cpu = two_passes(params, "cpu")
    t_cpu = time.perf_counter() - t0
    gpu = two_passes(on_card, dev)
    torch.cuda.synchronize()
    # the decoder alone on one pyramid (the CPU's): the refiner kernel and
    # cuDNN against the plain versions, without DINOv2's bf16 roundings
    both = torch.cat([a, b]).float() / 255.0
    with torch.no_grad(), full_f32():
        pyr = roma.build_pyramid(params, both)
        ref = roma.decode(params, pyr, roma._swap_halves(pyr, 1))
        pyr = {k: v.to(dev) for k, v in pyr.items()}
        got = roma.decode(on_card, pyr, roma._swap_halves(pyr, 1))
    torch.cuda.synchronize()
    # 1e-3 of each output's magnitude: f32 sums in another order, carried
    # through the coarse-to-fine loop (the bound the CPU tests hold the port
    # to against the JAX package)
    dec = [_share_within(g, r, 1e-3) for g, r in zip(got, ref)]
    full = [_share_within(g, r, 1e-3) for g, r in zip(gpu, cpu)]
    finite = all(bool(torch.isfinite(t).all()) for t in gpu)
    print(f"[ref] RoMa 224 / 320 px, DINOv2 2 blocks: the same pyramid decoded on the card "
          f"and the CPU, share within 1e-3 of the magnitude: warp {dec[0]:.5f}, certainty "
          f"{dec[1]:.5f}; both passes, each device its own bf16 DINOv2: warps "
          f"{full[0]:.5f} / {full[2]:.5f}, certainties {full[1]:.5f} / {full[3]:.5f} (CPU run "
          f"{t_cpu:.1f} s) [{card}]", flush=True)
    if not finite or min(dec) < 0.99:
        _fail("RoMa's decoder on the card disagrees with the plain versions on the CPU")

    # the sampler on the CPU's warps at 320 px, the CPU's draws injected
    warp_ab, cert_ab, warp_ba, cert_ba = (t[0] for t in cpu)
    num = 5000
    n = 2 * 320 * 320
    n_cand = min(4 * num, n)
    gen = torch.Generator().manual_seed(3)
    draws = (roma._gumbel(n, gen, "cpu"),
             torch.randperm(n_cand, generator=gen)[:min(n_cand, 4000)],
             roma._gumbel(n_cand, gen, "cpu"))
    m_cpu, _ = roma.sample_matches_device(warp_ab, cert_ab, warp_ba, cert_ba, num=num,
                                          draws=draws)
    m_gpu, _ = roma.sample_matches_device(*(t.to(dev) for t in (warp_ab, cert_ab, warp_ba,
                                                                 cert_ba)),
                                          num=num, draws=tuple(d.to(dev) for d in draws))
    m_gpu = m_gpu.cpu()
    dist = torch.cdist(m_cpu.double(), m_gpu.double(), p=float("inf"))
    in_order = (m_cpu - m_gpu).abs().amax(1).le(1e-6).float().mean().item()
    found = dist.amin(1).le(1e-6)
    one_to_one = len(set(dist.argmin(1)[found].tolist())) == int(found.sum())
    print(f"[ref] RoMa sampler on the card with the CPU's draws: {int(found.sum())} of "
          f"{len(m_cpu)} samples equal (within 1e-6), {in_order:.5f} in the same place "
          f"[{card}]", flush=True)
    if not (bool(found.all()) and one_to_one):
        _fail("RoMa's sampler on the card picks other samples than on the CPU")


def _full_depth_roma(card: str) -> None:
    """RoMa with DINOv2 at its published depth (24 blocks, width 1024, 16
    heads; random weights drawn on the card) on one pair at the default
    560 / 864 px, 5000 samples: warm time per pair (median of 3), peak
    memory, kernel launches per pair."""
    import torch

    from deep_image_matching_tpu_torch.models import dinov2, roma
    from deep_image_matching_tpu_torch.ops import _lib
    from deep_image_matching_tpu_torch.utils.device import to_device

    dev = torch.device("cuda", 0)
    p = to_device(roma.init_params(dinov2_depth=2), dev)
    gen = torch.Generator(device=dev).manual_seed(24)
    d = 1024

    def lin(ci, co):
        return {"w": torch.randn(co, ci, generator=gen, device=dev) / ci ** 0.5,
                "b": torch.zeros(co, device=dev)}

    def ln():
        return {"g": torch.ones(d, device=dev), "b": torch.zeros(d, device=dev)}

    blocks = [{"ln1": ln(), "qkv": lin(d, 3 * d), "proj": lin(d, d), "ls1": torch.ones(d, device=dev),
               "ln2": ln(), "fc1": lin(d, 4 * d), "fc2": lin(4 * d, d),
               "ls2": torch.ones(d, device=dev)} for _ in range(24)]
    p["dinov2"] = dinov2.prepare({**p["dinov2"], "blocks": blocks}, torch.bfloat16)
    (a, b), (ah, bh) = _demo_pair(torch, (560, 864), dev)

    def one_pair():
        out = roma.match_pair(p, a, b, with_cert16=True)
        up = roma.match_pair_upsample(p, ah, bh, *out[:4], scale_factor=864 / 560,
                                      cert16_ab=out[4], cert16_ba=out[5])
        m, _ = roma.sample_matches_device(*(t[0] for t in up), num=5000,
                                          generator=torch.Generator(device=dev).manual_seed(1))
        return up, m

    one_pair()
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        up, m = one_pair()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_pair = {k: v // 3 for k, v in _lib.LAUNCHES.items() if v}
    ok = all(bool(torch.isfinite(t).all()) for t in (*up, m)) and tuple(m.shape) == (5000, 4)
    print(f"[ref] RoMa with DINOv2 at 24 blocks, one pair at 560 / 864 px: warm "
          f"{sorted(walls)[1] * 1e3:.1f} ms per pair (median of 3: "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}), peak {peak:.2f} GiB, launches per "
          f"pair {per_pair} [{card}]", flush=True)
    if not ok or per_pair.get("attention", 0) != 24 or per_pair.get("refiner", 0) != 18:
        _fail("RoMa at full depth: non-finite output or unexpected launches")


# path -> (kernels it must launch, its runs: (project, strategy, config,
# descriptor width, CPU comparison)). Each path starts with the launch
# counts at 0 and reads them when its runs are done.
PATHS = {
    "superpoint+lightglue": (("attention", "ffn", "assignment", "nullspace"), (
        ("synthetic16", "bruteforce", "threshold0", 256, False),
        ("demo5", "matching_lowres", "default", 256, False))),
    "superpoint+superglue": (("attention", "ffn", "sinkhorn", "nullspace"), (
        ("synthetic16", "bruteforce", "superglue0", 256, False),)),
    "superpoint+kornia_matcher": (("nn", "nullspace"), (
        ("synthetic16", "bruteforce", "default", 256, False),)),
    "sift+kornia_matcher": (("nn", "nullspace"), (
        ("demo5", "bruteforce", "default", 128, True),)),
    "orb+kornia_matcher": (("nn", "nullspace"), (
        ("demo5", "bruteforce", "default", 32, True),)),
    # detector-free: no descriptors (width None); DINOv2's attention and the
    # scale-1 refiner run on the card
    "roma": (("attention", "refiner"), (
        ("demo5", "bruteforce", "default", None, False),)),
    # kernels 6 and 10 through the two opt-ins on the synthetic views; the
    # ALIKED probe of matching_lowres counts mutual nearest neighbours on
    # kernel 5
    "aliked+lightglue": (("attention", "ffn", "assignment", "nullspace", "bidir_attention",
                          "qkv", "nn"), (
        ("synthetic16", "bruteforce", "aliked_bidir", 128, False),
        ("demo5", "matching_lowres", "default", 128, False))),
}


# the float32 runs (``general.tpu.dtype: float32``) through the kernels'
# float32 forms: the main path at full width on the 16 synthetic views, the
# other two on the first 6 (the last two shifted copies) to keep the script's
# time; label -> (pipeline, kernels that must launch, runs)
F32_PATHS = {
    "superpoint+lightglue (float32)": ("superpoint+lightglue", (
        "attention_f32", "ffn_f32", "assignment", "nullspace"), (
        ("synthetic16", "bruteforce", "f32_threshold0", 256, False),)),
    "superpoint+superglue (float32)": ("superpoint+superglue", (
        "attention_f32", "ffn_f32", "sinkhorn", "nullspace"), (
        ("synthetic6", "bruteforce", "f32_superglue0", 256, False),)),
    "aliked+lightglue (float32)": ("aliked+lightglue", (
        "attention_f32", "ffn_f32", "assignment", "nullspace", "bidir_attention_f32",
        "qkv_f32"), (
        ("synthetic6", "bruteforce", "f32_aliked_bidir", 128, False),)),
}


# the presets of DISK, XFeat + LighterGlue, the open SuperPoint, KeyNet +
# AffNet + HardNet and the AdaLAM matcher: label -> (pipeline, kernels that
# must launch, kernels that must not, runs (project, strategy, config,
# descriptor width), environment). LighterGlue (width 96) runs kernel 1's
# head-dim-96 form and the unfused FFN, never kernel 2 or the head-dim-64
# form; AdaLAM's filter is plain tensor arithmetic after a dense nearest
# neighbour, as the JAX package's is XLA, and kernel 4 verifies
SPARSE_PATHS = {
    "disk+lightglue": ("disk+lightglue", ("attention", "ffn", "assignment", "nullspace"), (), (
        ("synthetic16", "bruteforce", "threshold0", 128),), None),
    "xfeat+lighterglue": ("xfeat+lighterglue", ("attention_hd96", "assignment", "nullspace"), (
        "ffn", "ffn_f32", "attention", "attention_f32"), (
        ("synthetic16", "bruteforce", "threshold0", 64),), None),
    "xfeat+lighterglue (float32)": ("xfeat+lighterglue", (
        "attention_hd96_f32", "assignment", "nullspace"), (
        "ffn", "ffn_f32", "attention", "attention_f32", "attention_hd96"), (
        ("synthetic16", "bruteforce", "f32_threshold0", 64),), None),
    "superpoint_open+kornia_matcher": ("superpoint_open+kornia_matcher", ("nn", "nullspace"), (), (
        ("synthetic16", "bruteforce", "default", 256),), None),
    "keynetaffnethardnet+kornia_matcher": ("keynetaffnethardnet+kornia_matcher", (
        "nn", "nullspace"), (), (("demo5", "bruteforce", "default", 128),), None),
    "keynetaffnethardnet+kornia_matcher (KeyNet, AffNet, OriNet)": (
        "keynetaffnethardnet+kornia_matcher", ("nn", "nullspace"), (), (
            ("demo5", "bruteforce", "default", 128),), "keynet_weights"),
    "sift+adalam": ("sift+kornia_matcher", ("nullspace",), ("nn",), (
        ("demo5", "bruteforce", "adalam", 128),), None),
    "sift+adalam_fast": ("sift+kornia_matcher", ("nullspace",), ("nn",), (
        ("demo5", "bruteforce", "adalam_fast", 128),), None),
    # DeDoDe (B and G), LiftFeat and RIPE with seeded checkpoints
    # (``dedode_liftfeat_ripe_weights``): kernel 5 at widths 256, 64 and
    # 960, kernel 4, and G's DINOv2 (bf16) on kernel 1
    "dedode+kornia_matcher": ("dedode+kornia_matcher", ("nn", "nullspace"), (), (
        ("synthetic16", "bruteforce", "default", 256),), "dedode_liftfeat_ripe_weights"),
    "dedode+kornia_matcher (descriptor G)": ("dedode+kornia_matcher", (
        "nn", "nullspace", "attention"), ("attention_f32",), (
        ("synthetic16", "bruteforce", "dedode_g", 256),), "dedode_liftfeat_ripe_weights"),
    "liftfeat+kornia_matcher": ("liftfeat+kornia_matcher", ("nn", "nullspace"), (), (
        ("synthetic16", "bruteforce", "default", 64),), "dedode_liftfeat_ripe_weights"),
    "ripe+kornia_matcher": ("ripe+kornia_matcher", ("nn", "nullspace"), (), (
        ("synthetic16", "bruteforce", "default", 960),), "dedode_liftfeat_ripe_weights"),
    # RDD (random weights from its seeded generator; ResNet-50, the
    # deformable encoder, 4096 keypoints, all in full f32) with LightGlue
    # (random rdd_sparse weights, bf16): kernels 1-4 at K = 4096
    "rdd_sparse+lightglue": ("rdd_sparse+lightglue", ("attention", "ffn", "assignment",
                                                      "nullspace"), ("attention_f32", "ffn_f32"), (
        ("synthetic16", "bruteforce", "threshold0", 256),), None),
    # ALIKE through a YAML that swaps sift+kornia_matcher's extractor, seeded
    # checkpoints (``alike_weights``): alike-n (D = 128, 8192 keypoints) on the
    # synthetic views, alike-s (D = 96) and alike-t (D = 64) on the demo images;
    # kernel 5 and kernel 4
    "alike+kornia_matcher": ("sift+kornia_matcher", ("nn", "nullspace"), (), (
        ("synthetic16", "bruteforce", "alike", 128),), "alike_weights"),
    "alike+kornia_matcher (alike-s)": ("sift+kornia_matcher", ("nn", "nullspace"), (), (
        ("demo5", "bruteforce", "alike_s", 96),), "alike_weights"),
    "alike+kornia_matcher (alike-t)": ("sift+kornia_matcher", ("nn", "nullspace"), (), (
        ("demo5", "bruteforce", "alike_t", 64),), "alike_weights"),
}

# card against CPU on the same inputs: label -> (pipeline, project, card
# config, CPU config, least share of each image's keypoints and of each
# pair's raw matches common to both runs, the weights' environment:
# ``weights_env``). The learned extractors and matchers run in f32 on both
# sides on three views of 320 x 320 (view 0 and two shifted copies), and the
# keypoints must be equal: on an H100 80GB HBM3 every keypoint and every raw
# match came out equal for DISK, XFeat + LighterGlue, DoH + HardNet and
# AdaLAM; a match may still flip between near-tied neighbours, so the raw
# matches are held to 99 %. SuperPoint's convolutions run in bf16 on the card
# (98.3 % of the keypoints, 95.6 % of the matches shared there), so the open
# SuperPoint is held to 95 % and 90 %
SPARSE_CPU_CHECKS = {
    "disk+lightglue": ("disk+lightglue", "synthetic3", "f32_threshold0", "cpu_threshold0",
                       1.0, 0.99, None),
    "xfeat+lighterglue": ("xfeat+lighterglue", "synthetic3", "f32_threshold0", "cpu_threshold0",
                          1.0, 0.99, None),
    "superpoint_open+kornia_matcher": ("superpoint_open+kornia_matcher", "synthetic3",
                                       "f32_threshold0", "cpu_threshold0", 0.95, 0.9, None),
    "keynetaffnethardnet+kornia_matcher": ("keynetaffnethardnet+kornia_matcher", "demo5",
                                           "default", "cpu", 1.0, 0.99, None),
    "sift+adalam": ("sift+kornia_matcher", "demo5", "adalam", "cpu_adalam", 1.0, 0.99, None),
    # DeDoDe and RIPE at the size their timed rows run (DeDoDe at its default
    # 784 x 784, RIPE at 1024 x 1024), on view 0 of the synthetic views and
    # its shifted copy (``shifted2``): their verified matches cannot be held
    # to the planted shift (``_run_path``), so this is the check of those
    # rows' outputs. G's DINOv2 in f32 on both sides (its bf16 form is held
    # at this shape in ``check_attention``). On an H100 80GB HBM3 the least
    # shares of keypoints / raw matches were DeDoDe B 1 / 1 and RIPE
    # 0.9995 / 1 with the extractors' convolutions in full f32 (under cuDNN's
    # default TF32 they were 0.9932 / 0.7891 and 0.7945 / 0.6629), and
    # LiftFeat's on synthetic3 1 / 0.9985, so all are held to 99 %
    "dedode+kornia_matcher": ("dedode+kornia_matcher", "shifted2", "default", "cpu",
                              0.99, 0.99, "dedode_liftfeat_ripe_weights"),
    "dedode+kornia_matcher (descriptor G)": ("dedode+kornia_matcher", "shifted2",
                                             "f32_dedode_g", "cpu_dedode_g", 0.99, 0.99,
                                             "dedode_liftfeat_ripe_weights"),
    "liftfeat+kornia_matcher": ("liftfeat+kornia_matcher", "synthetic3", "default", "cpu",
                                0.99, 0.99, "dedode_liftfeat_ripe_weights"),
    "ripe+kornia_matcher": ("ripe+kornia_matcher", "shifted2", "default", "cpu", 0.99, 0.99,
                            "dedode_liftfeat_ripe_weights"),
    # the timed bf16 DeDoDe-G (its DINOv2 on kernel 1 in bf16) against the
    # CPU's f32 run: on an H100 80GB HBM3 the keypoints were all shared (the
    # detector has no bf16 part) and 0.4375 of the raw matches (the seeded
    # descriptors' nearest neighbours are near-ties, which bf16 rounding
    # moves), so they are held to 99 % and 35 %
    "dedode+kornia_matcher (descriptor G, bf16)": (
        "dedode+kornia_matcher", "shifted2", "dedode_g", "cpu_dedode_g", 0.99, 0.35,
        "dedode_liftfeat_ripe_weights"),
    # the earlier extractors at their timed rows' sizes (1024 x 1024, the
    # demo images for KeyNet), on view 0 and its shifted copy, the matchers
    # in f32 on both sides. DISK, XFeat and the seeded KeyNet / AffNet /
    # OriNet run their convolutions in f32. On an H100 80GB HBM3 under cuDNN's
    # default TF32 the least shares of keypoints / raw matches were DISK
    # 0.9903 / 0.9839, XFeat 0.9990 / 1 and KeyNet 0.9835 / 0.8495, with
    # TF32 off 1 / 1, 1 / 1 and 0.9980 / 0.9913: the three now run in
    # ``full_f32`` (XFeat too, so that its 320 px row stays equal). SuperPoint
    # (open or not) and ALIKED run their convolutions in bf16 on the card in
    # every ``tpu.dtype`` (as the JAX package does on an accelerator), so TF32
    # never reaches them and bf16 against the CPU's f32 bounds their shares:
    # SuperPoint 0.9422 / 0.9556, the open one 0.9711 / 0.9683, both held to
    # 90 %; ALIKED's keypoints are sub-pixel, so its rows pair within
    # ``CPU_CHECK_TOL_PX`` instead of comparing equal: 0.8454 / 0.8089, held
    # to 80 % and 75 %
    "disk+lightglue (1024)": ("disk+lightglue", "shifted2", "f32_threshold0", "cpu_threshold0",
                              0.99, 0.99, None),
    "xfeat+lighterglue (1024)": ("xfeat+lighterglue", "shifted2", "f32_threshold0",
                                 "cpu_threshold0", 0.99, 0.99, None),
    "keynetaffnethardnet+kornia_matcher (KeyNet, AffNet, OriNet)": (
        "keynetaffnethardnet+kornia_matcher", "demo5", "default", "cpu", 0.99, 0.98,
        "keynet_weights"),
    "aliked+lightglue (1024)": ("aliked+lightglue", "shifted2", "f32_aliked_bidir",
                                "cpu_aliked_bidir", 0.8, 0.75, "aliked"),
    "superpoint+lightglue (float32, 1024)": ("superpoint+lightglue", "shifted2",
                                             "f32_threshold0", "cpu_threshold0", 0.9, 0.9, None),
    "superpoint_open+kornia_matcher (float32, 1024)": (
        "superpoint_open+kornia_matcher", "shifted2", "f32_threshold0", "cpu_threshold0",
        0.9, 0.9, None),
    # RDD and ALIKE at their timed rows' size (1024 x 1024) on view 0 and its
    # shifted copy, in full f32 on both sides (LightGlue too), keypoints and
    # raw-match rows paired within 0.01 px: RDD's position embedding is
    # absolute and its coarsest level has a stride of 64 px, so its
    # descriptors do not carry the planted shift and this is the check of its
    # row's outputs. On an H100 80GB HBM3 the least shares of keypoints / raw
    # matches were RDD 1 / 1 and ALIKE 0.9998 / 1; RDD's pair keeps few raw
    # matches under random weights (one flip moves its share by several
    # percent), so it is held to 99 % / 90 %, ALIKE to 99 % / 99 %
    "rdd_sparse+lightglue (1024)": ("rdd_sparse+lightglue", "shifted2", "f32_threshold0",
                                    "cpu_threshold0", 0.99, 0.9, None),
    "alike+kornia_matcher (1024)": ("sift+kornia_matcher", "shifted2", "alike", "cpu_alike",
                                    0.99, 0.99, "alike_weights"),
}
# rows whose keypoints are sub-pixel: keypoints and raw-match rows pair one
# to one within this many pixels (max norm) instead of comparing equal
CPU_CHECK_TOL_PX = {"aliked+lightglue (1024)": 0.25, "rdd_sparse+lightglue (1024)": 0.01,
                    "alike+kornia_matcher (1024)": 0.01}


def keynet_weights(wdir: Path, seed: int = 0) -> dict:
    """Seeded KeyNet, AffNet and OriNet checkpoints in their files' layouts
    (kornia's ``feature_extractor.lb_block.{i}.0`` / ``last_conv.0``; the
    AffNet release's ``features.N`` convolutions, each but the head followed
    by an affine-free BatchNorm at N + 1), He-normal weights; returns the
    environment that points the extractor at them."""
    import numpy as np
    import torch

    if not (wdir / "orinet.pth").exists():
        wdir.mkdir(parents=True, exist_ok=True)
        rng = np.random.default_rng(seed)

        def conv(co, ci, k):
            w = rng.normal(0, np.sqrt(2.0 / (ci * k * k)), (co, ci, k, k)).astype(np.float32)
            return torch.from_numpy(w), torch.from_numpy(rng.normal(0, 0.05, co).astype(np.float32))

        kn = {}
        for i, (co, ci) in enumerate(((8, 10), (8, 8), (8, 8))):
            kn[f"feature_extractor.lb_block.{i}.0.weight"], \
                kn[f"feature_extractor.lb_block.{i}.0.bias"] = conv(co, ci, 5)
        kn["last_conv.0.weight"], kn["last_conv.0.bias"] = conv(1, 24, 5)
        torch.save(kn, wdir / "keynet.pth")
        trunk = [(16, 1, 3), (16, 16, 3), (32, 16, 3), (32, 32, 3), (64, 32, 3), (64, 64, 3)]
        for name, head in (("affnet.pth", (3, 64, 8)), ("orinet.pth", (2, 64, 8))):
            sd = {}
            for i, shape in zip((0, 3, 6, 9, 12, 15, 19), trunk + [head]):
                sd[f"features.{i}.weight"], sd[f"features.{i}.bias"] = conv(*shape)
                if i < 19:
                    sd[f"features.{i + 1}.running_mean"] = torch.zeros(shape[0])
                    sd[f"features.{i + 1}.running_var"] = torch.ones(shape[0])
            torch.save({"state_dict": sd}, wdir / name)
    return {"DIM_TPU_WEIGHTS_DIR": str(wdir)}


def dedode_liftfeat_ripe_weights(wdir: Path) -> dict:
    """Seeded DeDoDe, LiftFeat and RIPE checkpoints in their files' layouts
    (the JAX package's random trees through ``convert.py``); returns the
    environment that points the extractors at them. DeDoDe's detector has
    its refiners' output convolutions scaled by 0.03 and LiftFeat its normal
    MLP's and AFT layers' last layers by 0.01: the seeded detector's logits
    span ~1e5, so its softmax is one-hot and every other keypoint a tie at
    zero, and the seeded booster adds terms shared by every cell, so that
    the ratio test keeps a few matches a pair. G's DINOv2 is the seeded
    depth-2 stack (no ``dinov2_vitl14_pretrain.pth``)."""
    import torch

    from deep_image_matching_tpu_torch import convert
    from deep_image_matching_tpu_torch.models import dedode, liftfeat, ripe

    if not (wdir / "ripe_weights.pth").exists():
        wdir.mkdir(parents=True, exist_ok=True)
        det = dedode.init_detector()
        for r in det["refiners"].values():
            r["out"]["w"] = r["out"]["w"] * 0.03
        torch.save(convert.dedode_params_from_jax(det), wdir / "dedode_detector_L.pth")
        torch.save(convert.dedode_params_from_jax(dedode.init_descriptor()),
                   wdir / "dedode_descriptor_B.pth")
        g = {k: v for k, v in dedode.init_descriptor_g().items() if k != "dinov2"}
        torch.save(convert.dedode_params_from_jax(g), wdir / "dedode_descriptor_G.pth")
        lf = liftfeat.init_tree()
        boost = lf["booster"]
        for lp in [boost["nenc"][-1]] + [a[k] for a in boost["aft"] for k in ("proj", "ffn2")]:
            lp["w"] = lp["w"] * 0.01
        torch.save(convert.liftfeat_params_from_jax(lf), wdir / "LiftFeat.pth")
        torch.save(convert.ripe_params_from_jax(ripe.init_tree()), wdir / "ripe_weights.pth")
    return {"DIM_TPU_WEIGHTS_DIR": str(wdir)}


def loftr_weights(wdir: Path, seed: int = 0) -> dict:
    """Seeded LoFTR (``loftr_outdoor.ckpt``) and exported SE2-LoFTR
    (``se2loftr_8rot_exported.pth``) checkpoints in the original names, from
    the port's random trees; returns the environment that points the matchers
    at them. Random weights leave the coarse features a large shared part
    (logits ~500: a one-hot dual softmax sends every row to one cell and a
    pair keeps one match), so the coarse output projection (``l3_out``,
    SE2's ``l3_triv``) is scaled by 0.2; the fine stage's input projection and
    layer norms by 0.1, so that its soft-argmax is not pinned to a window
    corner. On the CPU this gave 472 matches on a 1024 x 1024 shifted pair,
    469 within 4 px of the shift (median 0.28 px)."""
    import torch

    from deep_image_matching_tpu_torch.convert import loftr_state_dict
    from deep_image_matching_tpu_torch.models import loftr, se2loftr

    if not (wdir / "se2loftr_8rot_exported.pth").exists():
        wdir.mkdir(parents=True, exist_ok=True)
        for init, coarse, name in ((loftr.init_params, "l3_out", "loftr_outdoor.ckpt"),
                                   (se2loftr.init_params, "l3_triv",
                                    "se2loftr_8rot_exported.pth")):
            p = init(torch.Generator().manual_seed(seed))
            p["backbone"][coarse]["w"] = p["backbone"][coarse]["w"] * 0.2
            p["fine_pre"]["merge_feat"]["w"] = p["fine_pre"]["merge_feat"]["w"] * 0.1
            for lp in p["fine"]:
                for ln in ("ln1", "ln2"):
                    lp[ln]["g"] = lp[ln]["g"] * 0.1
            torch.save(loftr_state_dict(p), wdir / name)
    return {"DIM_TPU_WEIGHTS_DIR": str(wdir)}


def alike_state_dict(model_name: str = "alike-n", seed: int = 0) -> dict:
    """A seeded ALNet checkpoint (``alike-t``, ``-s``, ``-n`` or ``-l``) in the
    upstream key layout (ALIKE has no random initialisation): He-normal
    convolutions, BatchNorms with running statistics, the /8 and /32 blocks'
    share of the aggregation damped (their align-corners upsampling is not
    shift equivariant) and the head's score channel scaled by 0.1, so that
    the sigmoid scores spread around the 0.2 threshold.
    ``tests/test_torch_alike.py`` builds the same."""
    import numpy as np
    import torch

    from deep_image_matching_tpu_torch.models.alike import CONFIGS

    cfg = CONFIGS[model_name]
    c1, c2, c3, c4, dim = (cfg[k] for k in ("c1", "c2", "c3", "c4", "dim"))
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, co, ci, k, bias=False, std=None):
        std = (2.0 / (ci * k * k)) ** 0.5 if std is None else std
        sd[f"{name}.weight"] = rng.normal(0, std, (co, ci, k, k))
        if bias:
            sd[f"{name}.bias"] = rng.normal(0, 0.05, co)

    def bn(name, n):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, n)
        sd[f"{name}.bias"] = rng.normal(0, 0.1, n)
        sd[f"{name}.running_mean"] = rng.normal(0, 0.1, n)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, n)
        sd[f"{name}.num_batches_tracked"] = np.array(0)

    for b, ci, co in ((1, 3, c1), (2, c1, c2), (3, c2, c3), (4, c3, c4)):
        conv(f"block{b}.conv1", co, ci, 3)
        bn(f"block{b}.bn1", co)
        conv(f"block{b}.conv2", co, co, 3)
        bn(f"block{b}.bn2", co)
        if b > 1:
            conv(f"block{b}.downsample", co, ci, 1, bias=True)
    for i, c in enumerate((c1, c2, c3, c4), 1):
        conv(f"conv{i}", dim // 4, c, 1, std=(2.0 / c) ** 0.5 * (0.1 if i > 2 else 1.0))
    if not cfg["single_head"]:
        conv("convhead1", dim, dim, 1)
    conv("convhead2", dim + 1, dim, 1)
    sd["convhead2.weight"][-1] *= 0.1
    return {k: torch.tensor(v, dtype=torch.int64 if v.ndim == 0 else torch.float32)
            for k, v in sd.items()}


def alike_weights(wdir: Path) -> dict:
    """Seeded ``alike-n``, ``alike-s`` and ``alike-t`` checkpoints
    (``alike_state_dict``); returns the environment that points the
    extractor at them."""
    import torch

    if not (wdir / "alike-t.pth").exists():
        wdir.mkdir(parents=True, exist_ok=True)
        for model in ("alike-n", "alike-s", "alike-t"):
            torch.save(alike_state_dict(model), wdir / f"{model}.pth")
    return {"DIM_TPU_WEIGHTS_DIR": str(wdir)}


WEIGHT_SETS = {"keynet_weights": keynet_weights,
               "alike_weights": alike_weights,
               "dedode_liftfeat_ripe_weights": dedode_liftfeat_ripe_weights,
               "loftr_weights": loftr_weights}


def _profiled_run(label, pipeline, proj, strategy, cfg, outs, card) -> dict:
    """One more (warm) run of a path under ``torch.profiler``: its wall,
    device busy time (the device-side events), idle share and peak memory."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall, (busy, n_events, events) = _profiled(lambda: _run(pipeline, proj, strategy, cfg, outs))
    if busy is None:
        _fail(f"{label}: the profiled run recorded no device event")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    top = "; ".join(f"{ms:.2f} ms {name[:60]}" for ms, _, name in events[:3])
    print(f"[main] {label}: warm run under torch.profiler: wall {wall:.3f} s, device busy "
          f"{busy:.1f} ms in {n_events} events, idle {100 * (1 - busy / 1e3 / wall):.1f} %, "
          f"peak {peak:.2f} GiB; top: {top} [{card}]", flush=True)
    return {"wall_s": wall, "busy_ms": busy, "idle": 1 - busy / 1e3 / wall, "peak_gib": peak}


def _feature_sets(out_dir: Path) -> dict:
    import numpy as np

    from deep_image_matching_tpu_torch.io import hdf5

    with hdf5.File(out_dir / "features.h5", "r") as f:
        return {n: {tuple(k) for k in np.asarray(f[n]["keypoints"])} for n in f}


def _paired_count(a: set, b: set, tol: float) -> int:
    """How many rows of ``a`` pair one to one with a row of ``b`` within
    ``tol`` (max norm; equal rows where ``tol`` is 0)."""
    if tol == 0.0:
        return len(a & b)
    import numpy as np
    from scipy.spatial import cKDTree

    if not a or not b:
        return 0
    pa, pb = np.array(sorted(a), np.float64), np.array(sorted(b), np.float64)
    dist, idx = cKDTree(pb).query(pa, distance_upper_bound=tol, p=np.inf)
    return len(set(idx[np.isfinite(dist)].tolist()))


def _least_share(a: dict, b: dict, tol: float = 0.0) -> float:
    """The least |a & b| / |a | b| over the keys (1 where both are empty),
    rows paired within ``tol`` pixels."""
    if a.keys() != b.keys():
        return 0.0
    least = 1.0
    for k in a:
        n = _paired_count(a[k], b[k], tol)
        union = len(a[k]) + len(b[k]) - n
        if union:
            least = min(least, n / union)
    return least


def _weights_env(env) -> dict:
    """The environment of a weights set: ``WEIGHT_SETS``' seeded checkpoints
    (written once under WORK), ``aliked`` for the aliked path's, or none."""
    if env == "aliked":
        return _path_env("aliked+lightglue")
    return WEIGHT_SETS[env](WORK / env) if env else {}


def _reload_keynet_stages():
    """The KeyNet extractor keeps the stages it found (or their absence) per
    process; a run with another weights directory looks again."""
    from deep_image_matching_tpu_torch.extractors import keynetaffnethardnet as kah

    kah._KEYNET = kah._FRAMES = kah._UNSET


def phase_sparse_presets(projects, configs, timers, card) -> dict:
    """The slice's presets through ``run_matching`` on the card, each with the
    launch counts set to 0 just before it and read just after, then one warm
    run under ``torch.profiler``; then each against the CPU (a CPU run
    shared by two rows runs once)."""
    from deep_image_matching_tpu_torch.extractors import keynetaffnethardnet as kah

    launches = {}
    for label, (pipeline, needed, banned, runs, env) in SPARSE_PATHS.items():
        extra = _weights_env(env)
        if env == "keynet_weights":
            _reload_keynet_stages()
        with _env(extra):
            launches[label], _ = _run_path(
                pipeline, needed, [run + (False,) for run in runs], projects, configs, timers,
                card, label)
            ran = [k for k in banned if launches[label][k]]
            if ran:
                _fail(f"{label}: kernels {ran} launched, which its path must not run")
            proj_name, strategy, cfg, _ = runs[0]
            _profiled_run(label, pipeline, projects[proj_name], strategy, configs[cfg],
                          WORK / "out" / f"profiled_{pipeline}_{cfg}", card)
        if env == "keynet_weights":
            if kah._KEYNET is None or None in kah._FRAMES:
                _fail(f"{label}: the learned KeyNet, AffNet or OriNet did not load")
            _reload_keynet_stages()
    cpu_runs = {}
    for label, (pipeline, proj_name, cfg_card, cfg_cpu, kp_min, raw_min, env) in \
            SPARSE_CPU_CHECKS.items():
        proj = projects[proj_name]
        out = WORK / "out" / f"vs_cpu_{label}"
        t0 = time.perf_counter()
        if env == "keynet_weights":
            _reload_keynet_stages()
        with _env(_weights_env(env)):
            gpu_dir = _run(pipeline, proj, "bruteforce", configs[cfg_card], out)
            key = (pipeline, proj_name, cfg_cpu, env)
            if key not in cpu_runs:
                cpu_runs[key] = _run(pipeline, proj, "bruteforce", configs[cfg_cpu],
                                     out.with_name(out.name + "_cpu"))
        if env == "keynet_weights":
            _reload_keynet_stages()
        cpu_dir = cpu_runs[key]
        tol = CPU_CHECK_TOL_PX.get(label, 0.0)
        kp = _least_share(_feature_sets(gpu_dir), _feature_sets(cpu_dir), tol)
        raw = _least_share(_raw_match_sets(gpu_dir), _raw_match_sets(cpu_dir), tol)
        print(f"[main] {label} card against CPU on {proj_name}: least share of keypoints "
              f"{kp:.4f} (at least {kp_min}), of raw matches {raw:.4f} (at least {raw_min}); "
              f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
        if kp < kp_min or raw < raw_min:
            _fail(f"{label}: the card and the CPU disagree beyond the stated shares")
    return launches


def phase_handoff(projects, configs, card) -> None:
    """The extract -> match handoff on the card. features.h5 written through
    the handoff (``feature_cache`` armed, as ``ImageMatcher`` arms it) must
    equal the host path's byte for byte for SuperPoint, ALIKED, XFeat and
    ALIKE on the demo images at medium quality (several shape buckets,
    rescaled keypoints, prefetched uploads) and for SuperPoint's tiled device
    route; and ``run_matching`` of superpoint+lightglue on synthetic6, whose
    store came from the handoff, must write the raw and verified matches that
    a ``--resume`` of its match stage writes from features.h5."""
    import filecmp

    import numpy as np

    from deep_image_matching_tpu_torch.__main__ import run_matching
    from deep_image_matching_tpu_torch.constants import Quality, TileSelection
    from deep_image_matching_tpu_torch.extractors.alike import AlikeExtractor
    from deep_image_matching_tpu_torch.extractors.aliked import ALIKEDExtractor
    from deep_image_matching_tpu_torch.extractors.superpoint import SuperPointExtractor
    from deep_image_matching_tpu_torch.extractors.xfeat import XFeatExtractor
    from deep_image_matching_tpu_torch.io import hdf5
    from deep_image_matching_tpu_torch.matchers import matcher_base
    from deep_image_matching_tpu_torch.utils.image import ImageList

    t_phase = time.perf_counter()
    out = WORK / "out" / "handoff"
    out.mkdir(parents=True, exist_ok=True)
    images = list(ImageList(projects["demo5"] / "images"))
    env = {**_path_env("aliked+lightglue"), "DIM_TPU_ALLOW_RANDOM_WEIGHTS": "1"}
    alike_weights(Path(env["DIM_TPU_WEIGHTS_DIR"]))
    grid = {"tile_selection": TileSelection.GRID, "tile_size": (400, 300), "tile_overlap": 20}
    cases = (("superpoint", SuperPointExtractor, {}), ("aliked", ALIKEDExtractor, {}),
             ("xfeat", XFeatExtractor, {}), ("alike", AlikeExtractor, {}),
             ("superpoint, tiled device route", SuperPointExtractor, grid))
    with _env(env):
        for label, cls, extra in cases:
            conf = {"extractor": {}, "general": {"quality": Quality.MEDIUM,
                                                 "tpu": {"device": "cuda"}, **extra}}
            t0 = time.perf_counter()
            host_path, dev_path = out / f"{label}_host.h5", out / f"{label}_handoff.h5"
            for path in (host_path, dev_path):
                path.unlink(missing_ok=True)
            cls(conf).extract_batch(images, host_path)
            ext = cls(conf)
            ext.feature_cache = {}
            ext.extract_batch(images, dev_path)
            handoff = ext.device_handoff
            ext.flush()
            if handoff is None or (handoff.tile_idx is not None) != bool(extra):
                _fail(f"handoff {label}: the extractor did not hand its features over")
            if not filecmp.cmp(host_path, dev_path, shallow=False):
                _fail(f"handoff {label}: features.h5 differs from the host path's")
            print(f"[handoff] {label}: features.h5 byte-equal to the host path's "
                  f"({dev_path.stat().st_size} bytes, {int(handoff.counts.sum())} keypoints over "
                  f"{len(images)} images); {time.perf_counter() - t0:.2f} s [{card}]", flush=True)

    seen = []
    real = matcher_base._PaddedFeatureStore

    def spy(feature_path, names, device, cache=None, handoff=None):
        seen.append(handoff is not None)
        return real(feature_path, names, device, cache=cache, handoff=handoff)

    def files(out_dir):
        got = {}
        for name in ("raw_matches.h5", "matches.h5"):
            with hdf5.File(out_dir / name, "r") as f:
                got[name] = {(a, b): np.asarray(f[a][b]) for a in f for b in f[a]}
        return got

    args = {"dir": str(projects["synthetic6"]), "outs": str(out / "resume"),
            "pipeline": "superpoint+lightglue", "strategy": "bruteforce", "tiling": "none",
            "skip_reconstruction": True, "config_file": str(configs["threshold0"])}
    matcher_base._PaddedFeatureStore = spy
    try:
        run_matching({**args, "force": True})
        first = files(out / "resume")
        for name in ("raw_matches.h5", "matches.h5"):
            (out / "resume" / name).unlink()
        run_matching({**args, "resume": True})
        again = files(out / "resume")
    finally:
        matcher_base._PaddedFeatureStore = real
    if seen != [True, False]:
        _fail(f"handoff: the stores came from {seen} (the handoff, then features.h5 expected)")
    for name in first:
        if first[name].keys() != again[name].keys() or any(
                not np.array_equal(first[name][k], again[name][k]) for k in first[name]):
            _fail(f"handoff: {name} from the handoff's store differs from features.h5's")
    n_raw = sum(len(v) for v in first["raw_matches.h5"].values())
    n_ver = sum(len(v) for v in first["matches.h5"].values())
    print(f"[handoff] superpoint+lightglue on synthetic6: raw_matches.h5 and matches.h5 equal with "
          f"the store from the handoff and from features.h5 ({len(first['raw_matches.h5'])} "
          f"pairs, {n_raw} raw, {n_ver} verified matches); phase wall "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)


# the LoFTR family through ``run_matching`` (detector-free, seeded
# checkpoints ``loftr_weights``, match threshold 0): label -> (pipeline,
# project, config). None of it reaches a hand-written kernel (the JAX package
# runs it outside Pallas, and detector-free matches are verified on the
# host), so each path must launch none of the ten kernels. synthetic16's
# loftr row is timed and profiled and held to the planted shifts; the dense
# and blocked rows on synthetic6 are held to each other
LOFTR_PATHS = {
    "loftr": ("loftr", "synthetic16", "loftr0"),
    "loftr (synthetic6)": ("loftr", "synthetic6", "loftr0"),
    "loftr (coarse_impl: blocked)": ("loftr", "synthetic6", "loftr_blocked"),
    "se2loftr": ("se2loftr", "synthetic6", "loftr0"),
    "srif": ("srif", "demo5", "loftr0"),
}
# the blocked coarse matching against the dense one on the card: the least
# share of each pair's coarse cell pairs both hold (a mutual argmax can flip
# between near-tied cells, as the two take the maxima of differently rounded
# confidences) and the largest difference of a shared match's fine
# coordinates, in pixels. On an H100 80GB HBM3: share 1, difference 0
BLOCKED_MIN_SHARE, BLOCKED_MAX_FINE = 0.995, 1e-3
# card against CPU in f32 on view 0 and its shifted copy at 1024 x 1024:
# label -> (pipeline, least share of each pair's coarse cell pairs held by
# both runs, largest difference of a shared match's fine coordinates, px).
# On an H100 80GB HBM3 both shared every coarse match (466 and 789) with
# fine coordinates within 6.1e-05 px
LOFTR_CPU_CHECKS = {"loftr": ("loftr", 0.99, 0.01), "se2loftr": ("se2loftr", 0.99, 0.01)}


def _coarse_matches(out_dir: Path) -> dict:
    """Each pair's raw matches of a LoFTR run as {(x0, y0, cell x1, cell y1):
    (x1, y1)}: image 0's keypoint is a coarse cell's corner, image 1's its
    cell's corner plus a fine offset of less than half a cell (the
    projects' images are matched at full resolution)."""
    return {pair: {(r[0], r[1], round(float(r[2]) / 8), round(float(r[3]) / 8)): (r[2], r[3])
                   for r in rows}
            for pair, rows in _raw_match_sets(out_dir).items()}


def _coarse_agreement(a: dict, b: dict) -> tuple:
    """(the least share |A & B| / |A | B| of a pair's coarse cell pairs, the
    largest difference of the fine coordinates over the shared ones, the
    cell pairs held by one run only, by pair)."""
    least, worst, differ = 1.0, 0.0, {}
    for pair in sorted(a.keys() | b.keys()):
        ka, kb = a.get(pair, {}), b.get(pair, {})
        union, shared = ka.keys() | kb.keys(), ka.keys() & kb.keys()
        if union:
            least = min(least, len(shared) / len(union))
        if shared != union:
            differ[pair] = sorted(union - shared)
        for k in shared:
            worst = max(worst, abs(float(ka[k][0] - kb[k][0])), abs(float(ka[k][1] - kb[k][1])))
    return least, worst, differ


def phase_loftr(projects, configs, timers, card) -> dict:
    """loftr, se2loftr (its SE2 backbone) and srif through ``run_matching``
    on the card, each with the launch counts set to 0 just before it and read
    just after; loftr on synthetic16 once more warm under ``torch.profiler``;
    the blocked coarse matching against the dense one; loftr and se2loftr
    against the CPU at full size."""
    import torch

    launches, dirs = {}, {}
    with _env(_weights_env("loftr_weights")):
        for label, (pipeline, proj_name, cfg) in LOFTR_PATHS.items():
            allocs = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
            launches[label], runs = _run_path(
                pipeline, (), [(proj_name, "bruteforce", cfg, None, True)], projects, configs,
                timers, card, label)
            ran = [k for k, n in launches[label].items() if n]
            if ran:
                _fail(f"{label}: kernels {ran} launched, which its path must not run")
            if torch.cuda.memory_stats().get("allocation.all.allocated", 0) == allocs:
                _fail(f"{label}: nothing was allocated on the card")
            dirs[label] = runs[0][2]
            if label == "loftr":
                _profiled_run(label, pipeline, projects[proj_name], "bruteforce", configs[cfg],
                              WORK / "out" / f"profiled_{pipeline}_{cfg}", card)
        share, fine, differ = _coarse_agreement(
            _coarse_matches(dirs["loftr (synthetic6)"]),
            _coarse_matches(dirs["loftr (coarse_impl: blocked)"]))
        print(f"[main] loftr blocked against dense on synthetic6: least share of coarse matches "
              f"{share:.4f} (at least {BLOCKED_MIN_SHARE}), largest fine difference {fine:.2e} "
              f"px (at most {BLOCKED_MAX_FINE}) [{card}]", flush=True)
        for pair, cells in differ.items():
            print(f"[main]   near-tie: {pair[0]}-{pair[1]} mutual argmax differs at "
                  f"{cells[:6]}", flush=True)
        if share < BLOCKED_MIN_SHARE or fine > BLOCKED_MAX_FINE:
            _fail("loftr: the blocked coarse matching disagrees with the dense one")
        for label, (pipeline, min_share, max_fine) in LOFTR_CPU_CHECKS.items():
            t0 = time.perf_counter()
            out = WORK / "out" / f"vs_cpu_{label}"
            gpu_dir = _run(pipeline, projects["shifted2"], "bruteforce", configs["loftr0"], out)
            cpu_dir = _run(pipeline, projects["shifted2"], "bruteforce", configs["cpu_loftr0"],
                           out.with_name(out.name + "_cpu"))
            gpu, cpu = _coarse_matches(gpu_dir), _coarse_matches(cpu_dir)
            share, fine, differ = _coarse_agreement(gpu, cpu)
            n = sorted(len(v) for v in cpu.values())
            print(f"[main] {label} card against CPU on shifted2 ({n} coarse matches): least share "
                  f"of coarse matches {share:.4f} (at least {min_share}), largest fine "
                  f"difference {fine:.2e} px (at most {max_fine}); "
                  f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
            for pair, cells in differ.items():
                print(f"[main]   near-tie: {pair[0]}-{pair[1]} held by one run only: "
                      f"{cells[:6]}", flush=True)
            if not n or n[0] == 0 or share < min_share or fine > max_fine:
                _fail(f"{label}: the card and the CPU disagree beyond the stated bounds")
    return launches


def _path_env(pipeline: str) -> dict:
    """Environment set for one path's runs only: the aliked path's seeded
    ALIKED checkpoint (and no SuperPoint or LightGlue one) and the fused
    prologue."""
    if pipeline != "aliked+lightglue":
        return {}
    import torch

    wdir = WORK / "weights"
    if not (wdir / "aliked-n16rot.pth").exists():
        wdir.mkdir(parents=True, exist_ok=True)
        torch.save(aliked_state_dict(), wdir / "aliked-n16rot.pth")
    return {"DIM_TPU_WEIGHTS_DIR": str(wdir), "DIM_TPU_FUSED_PROLOGUE": "1"}


def _raw_match_sets(out_dir: Path) -> dict:
    """Raw matches per pair as sets of keypoint-coordinate pairs."""
    import numpy as np

    from deep_image_matching_tpu_torch.io import hdf5

    out = {}
    with hdf5.File(out_dir / "features.h5", "r") as f, \
            hdf5.File(out_dir / "raw_matches.h5", "r") as m:
        for a in m:
            for b in m[a]:
                mt = np.asarray(m[a][b])
                ka, kb = np.asarray(f[a]["keypoints"]), np.asarray(f[b]["keypoints"])
                out[(a, b)] = {tuple(ka[i]) + tuple(kb[j]) for i, j in mt}
    return out


def _run(pipeline: str, proj: Path, strategy: str, cfg: Path, outs: Path, tiling: str = "none"):
    from deep_image_matching_tpu_torch.__main__ import run_matching

    feature_path, _, _ = run_matching({
        "dir": str(proj), "outs": str(outs), "pipeline": pipeline, "strategy": strategy,
        "tiling": tiling, "skip_reconstruction": True, "force": True, "config_file": str(cfg),
    })
    return feature_path.parent


def _run_path(pipeline, needed, runs, projects, configs, timers, card, label=None):
    """One path's runs with the launch counts set to 0 before them; returns
    the counts read after them and the runs to repeat on the CPU. ``label``
    names the path in the report (the pipeline by default)."""
    import torch

    from deep_image_matching_tpu_torch.ops import _lib

    _lib.reset_launch_counts()
    cpu_checks = []
    for proj_name, strategy, cfg, dim, compare_cpu in runs:
        proj = projects[proj_name]
        names = sorted(p.name for p in (proj / "images").iterdir())
        outs = WORK / "out" / f"{pipeline}_{proj_name}_{cfg}"
        t0 = time.perf_counter()
        out_dir = _run(pipeline, proj, strategy, configs[cfg], outs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_pairs = len((out_dir / "pairs.txt").read_text().splitlines())
        if strategy == "bruteforce" and n_pairs != len(names) * (len(names) - 1) // 2:
            _fail(f"bruteforce gave {n_pairs} pairs")
        if dim is None:
            summary, n_verified = _check_dense_outputs(out_dir, names, n_pairs)
        else:
            summary, n_verified = _check_outputs(out_dir, names, n_pairs, dim)
        if proj_name == "synthetic16" and pipeline not in ("superpoint+superglue",
                                                           "xfeat+lighterglue",
                                                           "dedode+kornia_matcher",
                                                           "ripe+kornia_matcher",
                                                           "rdd_sparse+lightglue"):
            # random SuperGlue weights mix the keypoint positions into the
            # descriptors, and LighterGlue's random input projection and six
            # random layers at width 96 leave a few mutual neighbours a pair
            # (on the CPU as on the card), so only the other matchers find
            # the shift; DeDoDe squeezes every view into 784 x 784, where a
            # shift of whole 8 px cells of its /8 features would be 512 px
            # here (a shift of 64 px, 49 there, leaves the seeded DeDoDe's
            # verified matches off it by a few pixels on the CPU); RIPE reads its
            # hypercolumns at k (Wc - 1) / (W - 1), which drifts from k / 8
            # across the image, so its smooth random descriptors match
            # neighbours a few pixels off the shift (2 px median on the CPU
            # between the two copies). RDD's position embedding is absolute
            # and its coarsest level's stride is 64 px, so its descriptors do
            # not follow the shift. These are held to the CPU at this size
            # instead (``SPARSE_CPU_CHECKS``)
            summary += "; " + _check_shifted(out_dir, names)
        if pipeline == "sift+kornia_matcher" and n_verified == 0:
            _fail("sift+kornia_matcher verified no pair of the demo images")
        stages = timers.lines[-1].split("] ", 2)[-1] if timers.lines else "no timer line"
        print(f"[main] {label or pipeline} on {proj_name} ({strategy}): {summary}; run_matching "
              f"{wall:.2f} s; stages {stages} [{card}]", flush=True)
        if compare_cpu:
            cpu_checks.append((proj, strategy, out_dir, outs))
    launches = dict(_lib.LAUNCHES)
    print(f"[main] {label or pipeline}: kernel launches {launches}", flush=True)
    missing = [k for k in needed if launches[k] == 0]
    if missing:
        _fail(f"{label or pipeline}: kernels {missing} of its path were never launched")
    return launches, cpu_checks


def phase_main_path(card: str) -> dict:
    projects, configs, timers = _main_setup()
    launches = {name: {} for name in PATHS}
    return _run_main_paths(projects, configs, timers, card, launches)


def _main_setup():
    """The main paths' projects (synthetic views, the demo images) and YAML
    configurations under WORK, made anew, and the stage-timer log."""
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    base = "general:\n  allow_random_weights: true\n  tpu:\n    device: {}\n"
    configs = {name: WORK / f"{name}.yaml"
               for name in ("default", "threshold0", "superglue0", "cpu", "aliked_bidir",
                            "f32_threshold0", "f32_superglue0", "f32_aliked_bidir",
                            "cpu_threshold0", "adalam", "adalam_fast", "cpu_adalam",
                            "dedode_g", "f32_dedode_g", "cpu_dedode_g", "cpu_aliked_bidir",
                            "loftr0", "loftr_blocked", "cpu_loftr0", "alike", "alike_s",
                            "alike_t", "cpu_alike")}
    configs["default"].write_text(base.format("cuda"))
    configs["aliked_bidir"].write_text(base.format("cuda") + "    attn_impl: bidir\n"
                                       "matcher:\n  filter_threshold: 0.0\n")
    # random weights never reach LightGlue's 0.1 or SuperGlue's 0.3 match
    # score, so the synthetic runs keep every mutual nearest neighbour
    configs["threshold0"].write_text(base.format("cuda") + "matcher:\n  filter_threshold: 0.0\n")
    configs["superglue0"].write_text(base.format("cuda") + "matcher:\n  match_threshold: 0.0\n")
    configs["cpu"].write_text(base.format("cpu"))
    configs["cpu_threshold0"].write_text(base.format("cpu") + "    dtype: float32\n"
                                         "matcher:\n  filter_threshold: 0.0\n")
    # the AdaLAM matcher over sift (its YAML swaps the preset's matcher)
    for name, mode, dev in (("adalam", "adalam", "cuda"), ("adalam_fast", "adalam_fast", "cuda"),
                            ("cpu_adalam", "adalam", "cpu")):
        configs[name].write_text(base.format(dev) + f"matcher:\n  name: adalam\n"
                                                    f"  match_mode: {mode}\n")
    # DeDoDe's descriptor G (its DINOv2 in bf16 at the default dtype), and in
    # f32 on both sides for the CPU comparison
    configs["dedode_g"].write_text(base.format("cuda") + "extractor:\n  descriptor: G\n")
    for name, dev in (("f32_dedode_g", "cuda"), ("cpu_dedode_g", "cpu")):
        configs[name].write_text(base.format(dev) + "    dtype: float32\n"
                                 "extractor:\n  descriptor: G\n")
    configs["cpu_aliked_bidir"].write_text(base.format("cpu") + "    dtype: float32\n"
                                           "    attn_impl: bidir\nmatcher:\n"
                                           "  filter_threshold: 0.0\n")
    # the LoFTR family at match threshold 0 (the seeded weights' confidences
    # stay below the default 0.2), dense and blocked coarse matching
    for name, dev, extra in (("loftr0", "cuda", ""), ("cpu_loftr0", "cpu", ""),
                             ("loftr_blocked", "cuda", "  coarse_impl: blocked\n")):
        configs[name].write_text(base.format(dev) + "matcher:\n  match_threshold: 0.0\n" + extra)
    # ALIKE in place of the preset's extractor (sift+kornia_matcher's YAML)
    for name, dev, model in (("alike", "cuda", "alike-n"), ("alike_s", "cuda", "alike-s"),
                             ("alike_t", "cuda", "alike-t"), ("cpu_alike", "cpu", "alike-n")):
        configs[name].write_text(base.format(dev) + f"extractor:\n  name: alike\n"
                                                    f"  model: {model}\n")
    # the same in float32: the kernels' float32 forms
    for name in ("threshold0", "superglue0", "aliked_bidir"):
        text = configs[name].read_text().replace("    device: cuda\n",
                                                 "    device: cuda\n    dtype: float32\n")
        configs[f"f32_{name}"].write_text(text)
    projects = {"synthetic16": _synthetic_project(WORK / "synthetic16"),
                "synthetic6": _synthetic_project(WORK / "synthetic6", n=6),
                "synthetic3": _synthetic_project(WORK / "synthetic3", n=3, size=320),
                # synthetic16's view 0 and its last view (its shifted copy)
                "shifted2": _synthetic_project(WORK / "shifted2", n=2, shifts={-1: SHIFTS[-1]}),
                "demo5": WORK / "demo5"}
    shutil.copytree(ROOT / "notebooks" / "demo_project" / "images", projects["demo5"] / "images")
    return projects, configs, _TimerLog()


def _run_main_paths(projects, configs, timers, card, launches) -> dict:
    for pipeline, (needed, runs) in PATHS.items():
        with _env(_path_env(pipeline)):
            launches[pipeline], cpu_checks = _run_path(pipeline, needed, runs, projects, configs,
                                                       timers, card)
        for proj, strategy, out_dir, outs in cpu_checks:
            # the same run on the CPU: integer descriptors make the
            # nearest-neighbour arithmetic exact, so the raw matches of the
            # kernel route and of the dense CPU route are equal
            cpu_dir = _run(pipeline, proj, strategy, configs["cpu"], outs.with_name(outs.name + "_cpu"))
            gpu_sets, cpu_sets = _raw_match_sets(out_dir), _raw_match_sets(cpu_dir)
            if gpu_sets.keys() != cpu_sets.keys():
                _fail(f"{pipeline}: the card and the CPU matched other pairs")
            differ = [p for p in gpu_sets if gpu_sets[p] != cpu_sets[p]]
            if differ:
                _fail(f"{pipeline}: raw matches of {differ[:3]} differ between the card and the CPU")
            counts = sorted(len(v) for v in gpu_sets.values())
            print(f"[main] {pipeline}: raw matches equal on the card and the CPU for all "
                  f"{len(gpu_sets)} pairs ({counts[0]}-{counts[-1]} per pair) [{card}]", flush=True)
    for label, (pipeline, needed, runs) in F32_PATHS.items():
        with _env(_path_env(pipeline)):
            launches[label], _ = _run_path(pipeline, needed, runs, projects, configs, timers,
                                           card, label)
    launches.update(phase_sparse_presets(projects, configs, timers, card))
    phase_handoff(projects, configs, card)
    launches.update(phase_loftr(projects, configs, timers, card))
    return launches


# ---------------------------------------------------------------------------
# tiled extraction and matching (--tiling)
# ---------------------------------------------------------------------------

# the tiled projects' shifted copies of view 0: whole SuperPoint cells at full
# resolution and at the preselection probe's (2000 px over 6000 or 4800: a
# third and 5/12), so the probe's matches, the tile-pair jobs and the
# full-resolution matches all follow the shift
TILED_SHIFTS = {-2: (192, -96), -1: (-288, 96)}


@contextlib.contextmanager
def _recording_jobs():
    """The tile pairs ``select_tile_pairs`` chooses inside the block, one
    list per image pair in the matcher's pair order."""
    from deep_image_matching_tpu_torch.matchers import tiling

    calls = []
    orig = tiling.select_tile_pairs

    def record(*args, **kwargs):
        calls.append(orig(*args, **kwargs))
        return calls[-1]

    tiling.select_tile_pairs = record
    try:
        yield calls
    finally:
        tiling.select_tile_pairs = orig


def _check_tiles(out_dir: Path, names: list) -> str:
    """Every image's keypoints carry ``tile_idx`` from at least two tiles,
    and no pair holds a query keypoint twice (the union's dedup)."""
    import numpy as np

    from deep_image_matching_tpu_torch.io import hdf5

    tiles = []
    with hdf5.File(out_dir / "features.h5", "r") as f:
        for name in names:
            t = np.asarray(f[name]["tile_idx"]) if "tile_idx" in f[name] else np.zeros(0)
            if len(t) != len(np.asarray(f[name]["keypoints"])) or len(np.unique(t)) < 2:
                _fail(f"features of {name}: tile_idx from {len(np.unique(t))} tiles")
            tiles.append(len(np.unique(t)))
    for path in (out_dir / "raw_matches.h5", out_dir / "matches.h5"):
        if path.exists():
            with hdf5.File(path, "r") as f:
                for a in f:
                    for b in f[a]:
                        m = np.asarray(f[a][b])
                        if len(np.unique(m[:, 0])) != len(m):
                            _fail(f"{path.name} {a}-{b}: a query keypoint matched twice")
    return f"tiles per image {min(tiles)}-{max(tiles)}, no duplicate query keypoints"


def _tiled_run(label, pipeline, proj, cfg, outs, tiling, needed, timers, card, dim=256,
               shifts=None):
    """One counted tiled run: the launch counts set to 0 just before it and
    read just after; its files, tiles and (with ``shifts``) the shifted
    pairs checked. Returns (out dir, tile pairs per image pair, launches,
    wall s)."""
    import torch

    from deep_image_matching_tpu_torch.ops import _lib

    names = sorted(p.name for p in (proj / "images").iterdir())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    with _recording_jobs() as jobs:
        out_dir = _run(pipeline, proj, "bruteforce", cfg, outs, tiling)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_pairs = len(names) * (len(names) - 1) // 2
    if len(jobs) != n_pairs:
        _fail(f"{label}: tile pairs chosen for {len(jobs)} of {n_pairs} pairs")
    summary, _ = _check_outputs(out_dir, names, n_pairs, dim)
    summary += "; " + _check_tiles(out_dir, names)
    if shifts:
        summary += "; " + _check_shifted(out_dir, names, shifts)
    stages = timers.lines[-1].split("] ", 2)[-1] if timers.lines else "no timer line"
    n_jobs = sum(len(j) for j in jobs)
    print(f"[tiled] {label}: {summary}; {n_jobs} tile-pair jobs over {n_pairs} pairs "
          f"({min(len(j) for j in jobs)}-{max(len(j) for j in jobs)} a pair); run_matching "
          f"{wall:.2f} s; stages {stages}; peak {peak:.2f} GiB [{card}]", flush=True)
    print(f"[tiled] {label}: kernel launches {launches}", flush=True)
    missing = [k for k in needed if launches[k] == 0]
    if missing:
        _fail(f"{label}: kernels {missing} of its path were never launched")
    return out_dir, jobs, launches, wall


def _tiled_card_vs_cpu(proj, cfg_card, cfg_cpu, timers, card) -> dict:
    """The 2-view 4800 x 3200 project (view 1 a shifted copy of view 0) on
    the card and on the CPU: equal tile-pair jobs on the shifted pair and the
    share of equal jobs over all pairs; SuperPoint in bf16 on the card and in
    f32 on the CPU keeping at least 90 % of the same keypoints; then
    LightGlue on one batch of the CPU run's tile-pair jobs, gathered from a
    tiled store of the CPU run's features on each device (``_tiled_lightglue``).
    Returns the card run's launches."""
    import numpy as np

    from deep_image_matching_tpu_torch.io import hdf5

    names = sorted(p.name for p in (proj / "images").iterdir())
    lg = ("attention", "ffn", "assignment", "nullspace", "nn")
    out = WORK / "tiled" / "out"
    gpu_dir, gpu_jobs, launches, _ = _tiled_run(
        "superpoint+lightglue --tiling preselection (4800 x 3200, card)", "superpoint+lightglue",
        proj, cfg_card, out / "p15_card", "preselection", lg, timers, card,
        shifts={-1: TILED_SHIFTS[-1]})
    t0 = time.perf_counter()
    with _recording_jobs() as cpu_jobs:
        cpu_dir = _run("superpoint+lightglue", proj, "bruteforce", cfg_cpu, out / "p15_cpu",
                       "preselection")
    cpu_wall = time.perf_counter() - t0
    pairs = [tuple(line.split()) for line in (gpu_dir / "pairs.txt").read_text().splitlines()]
    shifted = pairs.index((names[0], names[-1]))
    if gpu_jobs[shifted] != cpu_jobs[shifted]:
        _fail(f"tile-pair jobs of the shifted pair differ: card {gpu_jobs[shifted]}, "
              f"CPU {cpu_jobs[shifted]}")
    equal_pairs = sum(g == c for g, c in zip(gpu_jobs, cpu_jobs))
    gj = {(p, t) for p, js in enumerate(gpu_jobs) for t in js}
    cj = {(p, t) for p, js in enumerate(cpu_jobs) for t in js}
    shared = []
    with hdf5.File(gpu_dir / "features.h5", "r") as g, hdf5.File(cpu_dir / "features.h5", "r") as c:
        for name in names:
            gk = {tuple(k) for k in np.asarray(g[name]["keypoints"])}
            ck = {tuple(k) for k in np.asarray(c[name]["keypoints"])}
            shared.append(len(gk & ck) / max(len(ck), 1))
    print(f"[tiled] card vs CPU at 4800 x 3200: tile-pair jobs of the shifted pair equal "
          f"({len(gpu_jobs[shifted])}); pairs with equal jobs {equal_pairs}/{len(pairs)}, equal "
          f"jobs {len(gj & cj)}/{len(gj | cj)} ({len(gj)} card, {len(cj)} CPU); keypoints the "
          f"card's features share with the CPU's: {', '.join(f'{v:.4f}' for v in shared)}; "
          f"CPU run_matching {cpu_wall:.2f} s [{card}]", flush=True)
    if min(shared) < 0.9:
        _fail("SuperPoint on the card keeps under 90 % of the CPU's keypoints")
    _tiled_lightglue(cpu_dir, cpu_jobs, card)
    return launches


def _tiled_lightglue(out_dir: Path, jobs: list, card) -> None:
    """LightGlue (the path's model and settings: random weights, threshold
    0, adaptive depth and width) on every tile-pair job of a run as one
    batch, gathered with ``gather_tiled`` from a tiled store of the run's
    features.h5 built on the card and on the CPU, compared as
    ``_reference_lightglue`` compares (``_agreement``). In float32 (the
    kernels' float32 forms) as the reference phase's float32 rule holds it:
    the same exit layer, at most one row in 1000 differing, scores within
    1e-4. In bf16 (the path's dtype: kernels 1-3) the reference phase's 99 %
    agreement does not hold on random-weight tile batches of a real texture,
    where most matched rows are near-ties: the CPU's own plain bf16 differs
    from its f32 there. So the card's bf16 is held to the CPU's f32: the
    same exit layer, and at most twice as many rows differing as the plain
    bf16 version's, plus one row in 1000."""
    import torch

    from deep_image_matching_tpu_torch.matchers.matcher_base import _PaddedFeatureStore
    from deep_image_matching_tpu_torch.models.lightglue import forward, load_default_model
    from deep_image_matching_tpu_torch.ops import _lib
    from deep_image_matching_tpu_torch.utils.device import full_f32

    pairs = [tuple(line.split()) for line in (out_dir / "pairs.txt").read_text().splitlines()]
    names = sorted({n for p in pairs for n in p})
    flat = [(pairs[p], t0, t1) for p, js in enumerate(jobs) for t0, t1 in js]
    out = {}
    for dev in (torch.device("cuda", 0), torch.device("cpu")):
        store = _PaddedFeatureStore(out_dir / "features.h5", names, dev)
        batches = [store.gather_tiled(
            torch.tensor([store.index[pair[side]] for pair, _, _ in flat], device=dev),
            torch.tensor([float(job[1 + side]) for job in flat], device=dev)) for side in (0, 1)]
        b0, b1 = batches
        model = load_default_model("superpoint").to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            _lib.reset_launch_counts()
            with full_f32():
                o = forward(model, b0["keypoints"], b1["keypoints"], b0["descriptors"],
                            b1["descriptors"], b0["mask"], b1["mask"], b0["image_size"].float(),
                            b1["image_size"].float(), filter_threshold=0.0,
                            depth_confidence=0.95, width_confidence=0.99, compute_dtype=dtype)
            out[dev.type, dtype] = ({k: v.cpu() if torch.is_tensor(v) else v for k, v in o.items()},
                                    {k: v for k, v in _lib.LAUNCHES.items() if v})
        model.cpu()
    B, K = out["cpu", torch.float32][0]["matches0"].shape
    valid = float(b0["mask"].float().mean())
    lines, ok = [], True
    for name, (a, b) in {"bf16 card vs bf16 CPU": (("cuda", torch.bfloat16), ("cpu", torch.bfloat16)),
                         "f32 card vs f32 CPU": (("cuda", torch.float32), ("cpu", torch.float32)),
                         "bf16 card vs f32 CPU": (("cuda", torch.bfloat16), ("cpu", torch.float32)),
                         "bf16 CPU vs f32 CPU": (("cpu", torch.bfloat16), ("cpu", torch.float32))}.items():
        x, y = out[a][0], out[b][0]
        differ, score_err = _agreement(y, x)
        both = x["valid0"] & y["valid0"]
        agree = (x["matches0"] == y["matches0"])[both].float().mean().item()
        lines.append(f"{name}: layers {x['layers_run']} / {y['layers_run']}, rows that differ "
                     f"{differ}, agreement on rows matched by both {agree:.4f}, max score "
                     f"difference {score_err:.3e}")
        ok &= x["layers_run"] == y["layers_run"]
        if name == "f32 card vs f32 CPU":
            ok &= differ <= B * K // 1000 and score_err <= 1e-4
    plain = _agreement(out["cpu", torch.float32][0], out["cpu", torch.bfloat16][0])[0]
    kern = _agreement(out["cpu", torch.float32][0], out["cuda", torch.bfloat16][0])[0]
    ok &= kern <= 2 * plain + B * K // 1000
    print(f"[tiled] LightGlue on {B} tile-pair jobs of the CPU run (K = {K}, valid {valid:.3f} of "
          f"the capacity): {'; '.join(lines)}; launches on the card bf16 "
          f"{out['cuda', torch.bfloat16][1]}, f32 {out['cuda', torch.float32][1]} [{card}]",
          flush=True)
    if not ok:
        _fail("LightGlue on tile-pair batches: the card disagrees with the CPU")


def _tiled_steps_bitwise(proj, card) -> None:
    """``cut_tiles`` and ``merge_tile_features`` on the card against the CPU
    on the same inputs (one 24 MP view, its tiles' SuperPoint outputs from
    the card): equal bits."""
    import numpy as np
    import torch

    from deep_image_matching_tpu_torch.extractors.superpoint import SuperPointExtractor
    from deep_image_matching_tpu_torch.ops.tile_merge import cut_tiles, merge_tile_features
    from deep_image_matching_tpu_torch.utils.image import read_image
    from deep_image_matching_tpu_torch.utils.tiling import Tiler

    dev = torch.device("cuda", 0)
    img = read_image(sorted((proj / "images").iterdir())[0], grayscale=True)
    origins, pad, hw = Tiler().tile_origins(img.shape, (2400, 2000), 10)
    starts = np.stack([origins[:, 1] + pad[0], origins[:, 0] + pad[2]], 1)
    gpu = cut_tiles(torch.from_numpy(img).to(dev), starts, hw, pad)
    cpu = cut_tiles(torch.from_numpy(img), starts, hw, pad)
    if not torch.equal(gpu.cpu(), cpu):
        _fail("cut_tiles on the card differs from the CPU")
    ex = SuperPointExtractor({"extractor": {}, "general": {"tpu": {"device": "cuda"}}})
    out = ex._extract_tiles_dev(gpu)
    wh = (img.shape[1], img.shape[0])
    org = torch.from_numpy(origins.astype(np.float32))
    args = [out[k] for k in ("keypoints", "scores", "descriptors", "mask")]
    for cap in (2048, 8192):
        g = merge_tile_features(*args, org, wh, cap)
        c = merge_tile_features(*(a.cpu() for a in args), org, wh, cap)
        differ = [k for k in c if not torch.equal(g[k].cpu(), c[k])]
        if differ:
            _fail(f"merge_tile_features at cap {cap}: {differ} differ between the card and the CPU")
    print(f"[tiled] cut_tiles ({len(origins)} tiles of {hw}) and merge_tile_features (caps 2048, "
          f"8192; {int(out['mask'].sum())} tile keypoints, {int(g['mask'].sum())} merged at "
          f"8192) bitwise equal on the card and the CPU [{card}]", flush=True)


def _tiled_kernel_masks(out_dir: Path, jobs: list, card) -> None:
    """Kernels 1 and 3 against their plain versions on a batch of tile-pair
    jobs gathered from the tiled store (masks scattered by tile over the
    capacity, not prefixes), within their kernel checks' tolerances."""
    import torch

    from deep_image_matching_tpu_torch.matchers.matcher_base import _PaddedFeatureStore
    from deep_image_matching_tpu_torch.ops.attention import attention_reference, fused_attention

    dev = torch.device("cuda", 0)
    names = sorted({n for line in (out_dir / "pairs.txt").read_text().splitlines()
                    for n in line.split()})
    pairs = [tuple(line.split()) for line in (out_dir / "pairs.txt").read_text().splitlines()]
    store = _PaddedFeatureStore(out_dir / "features.h5", names, dev)
    flat = [(pairs[p], t0, t1) for p, js in enumerate(jobs) for t0, t1 in js][:16]
    ind0 = torch.tensor([store.index[a] for (a, _), _, _ in flat], device=dev)
    ind1 = torch.tensor([store.index[b] for (_, b), _, _ in flat], device=dev)
    t0 = torch.tensor([float(t) for _, t, _ in flat], device=dev)
    t1 = torch.tensor([float(t) for _, _, t in flat], device=dev)
    m0 = store.gather_tiled(ind0, t0)["mask"]
    m1 = store.gather_tiled(ind1, t1)["mask"]
    B, K = m0.shape
    prefix = bool(((m0.cumsum(1) == torch.arange(1, K + 1, device=dev)) | ~m0).all()
                  and m0[:, 0].all())
    gen = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn(B, 4, K, 64, generator=gen).mul(s).to(dev, torch.bfloat16)
               for s in (2.0, 2.0, 1.0))
    a_err, a_tol, a = _attention_case(torch, fused_attention, attention_reference, q, k, v,
                                      m0, m1)
    s_err, ties, s = _assignment_case(torch, gen, B, K, 256, dev, masks=(m0, m1))
    print(f"[tiled] kernels on {B} tile-pair jobs from the tiled store (K = {K}, valid "
          f"{float(m0.float().mean()):.3f} / {float(m1.float().mean()):.3f} of the capacity, "
          f"prefix masks {prefix}): attention max err {a_err:.3e} (tol {a_tol:.1e}), kernel "
          f"{a['ms']:.3f} ms, plain {a['plain_ms']:.3f} ms; assignment max err {s_err:.3e} "
          f"(tol 1.0e-03), near-ties {ties}, kernel {s['ms']:.3f} ms, plain "
          f"{s['plain_ms']:.3f} ms [{card}]", flush=True)
    if not a_err <= a_tol or not s_err <= 1e-3:
        _fail("kernel 1 or 3 disagrees with its plain version on tile-masked batches")


def phase_tiled(card: str) -> dict:
    """Tiled extraction and matching: superpoint+lightglue --tiling
    preselection on 6 synthetic 24 MP views at 2048 and 8192 keypoints (a
    warm run of the first under torch.profiler), --tiling grid on the demo
    images with sift and with superpoint+lightglue, the card against the
    CPU on a 2-view 4800 x 3200 project, the tile cut and the merge bitwise,
    and kernels 1 and 3 on tile-masked batches. Returns the counted runs'
    launches."""
    import torch

    t_phase = time.perf_counter()
    root = WORK / "tiled"
    root.mkdir(parents=True, exist_ok=True)
    base = "general:\n  allow_random_weights: true\n  tpu:\n    device: {}\n"
    lg0 = "matcher:\n  filter_threshold: 0.0\n"
    demo_tiles = "  tile_size: [400, 300]\n  tile_overlap: 20\n"
    texts = {"card": base.format("cuda") + lg0, "cpu": base.format("cpu") + lg0,
             "card8192": base.format("cuda") + lg0 + "extractor:\n  max_keypoints: 8192\n",
             "demo_lg": base.format("cuda") + demo_tiles + lg0,
             "demo_sift": base.format("cuda") + demo_tiles}
    cfgs = {}
    for name, text in texts.items():
        cfgs[name] = root / f"{name}.yaml"
        cfgs[name].write_text(text)
    t0 = time.perf_counter()
    p24 = _synthetic_project(root / "p24", n=6, size=(6000, 4000), shifts=TILED_SHIFTS)
    p15 = _synthetic_project(root / "p15", n=2, size=(4800, 3200), shifts={-1: TILED_SHIFTS[-1]})
    demo = WORK / "demo5"
    print(f"[tiled] projects: 6 views of 6000 x 4000 (views 4 and 5 view 0 shifted by "
          f"{TILED_SHIFTS[-2]} and {TILED_SHIFTS[-1]} px), 2 of 4800 x 3200, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    timers = _TimerLog()
    lg = ("attention", "ffn", "assignment", "nullspace", "nn")
    launches = {}
    label = "superpoint+lightglue --tiling preselection (24 MP, 2048)"
    out2048, jobs2048, launches[label], _ = _tiled_run(
        label, "superpoint+lightglue", p24, cfgs["card"], root / "out" / "p24_2048",
        "preselection", lg, timers, card, shifts=TILED_SHIFTS)

    # the same run warm, under torch.profiler (not counted)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall, (busy, n_events, events) = _profiled(lambda: _run(
        "superpoint+lightglue", p24, "bruteforce", cfgs["card"], root / "out" / "p24_prof",
        "preselection"))
    if busy is None:
        _fail("the profiler recorded no device event in the tiled run")
    stages = timers.lines[-1].split("] ", 2)[-1] if timers.lines else "no timer line"
    top = "; ".join(f"{ms:.1f} ms x{n} {key[:60]}" for ms, n, key in events[:6])
    print(f"[tiled] warm profiled run (24 MP, 2048): wall {wall * 1e3:.1f} ms, device busy "
          f"{busy:.1f} ms in {n_events} device events, idle {100 * (1 - busy / (wall * 1e3)):.1f} "
          f"%, peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; stages {stages}; top: "
          f"{top} [{card}]", flush=True)

    label = "superpoint+lightglue --tiling preselection (24 MP, 8192)"
    _, _, launches[label], _ = _tiled_run(
        label, "superpoint+lightglue", p24, cfgs["card8192"], root / "out" / "p24_8192",
        "preselection", lg, timers, card, shifts=TILED_SHIFTS)
    for pipeline, cfg, needed, dim in (
            ("sift+kornia_matcher", "demo_sift", ("nn", "nullspace"), 128),
            ("superpoint+lightglue", "demo_lg", ("attention", "ffn", "assignment", "nullspace"),
             256)):
        label = f"{pipeline} --tiling grid (demo5, tiles 400 x 300)"
        _, _, launches[label], _ = _tiled_run(
            label, pipeline, demo, cfgs[cfg], root / "out" / f"demo_{pipeline}", "grid", needed,
            timers, card, dim=dim)
    launches["superpoint+lightglue --tiling preselection (4800 x 3200)"] = _tiled_card_vs_cpu(
        p15, cfgs["card"], cfgs["cpu"], timers, card)
    _tiled_steps_bitwise(p24, card)
    _tiled_kernel_masks(out2048, jobs2048, card)
    print(f"[tiled] phase wall {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return launches


# ---------------------------------------------------------------------------
# reconstruction (main-path stage 5)
# ---------------------------------------------------------------------------

# the bundle-adjustment size that the JAX package's sfm/ba.py names: 64 poses,
# 8192 points, about 262k observations; 0.4 px of noise
BA_POSES, BA_POINTS, BA_OBS, BA_NOISE = 64, 8192, 262144, 0.4


def ba_scene(seed: int = 0, n_poses: int = BA_POSES, n_points: int = BA_POINTS,
             n_obs: int = BA_OBS, noise: float = BA_NOISE):
    """A bundle-adjustment problem built with the port's ``sfm.geometry``:
    ``n_points`` points in a box seen by a grid of ``n_poses`` cameras (a
    SIMPLE_RADIAL camera as the mapper carries it, the OPENCV 8-vector: f =
    800, k1 = -0.05, 1024 x 768), each visible observation kept with the
    probability that leaves about ``n_obs``, with ``noise`` px of noise; then
    perturbed as ``tests/test_sfm.py`` perturbs its scene: poses by 0.02,
    points by 0.05, the focal by +5.5 %, k1 from 0, with the first pose and
    one translation of the second held, as the mapper's gauge holds them.
    Returns (``bundle_adjust``'s positional arguments, the observations'
    (pose, point, uv) arrays)."""
    import numpy as np

    from deep_image_matching_tpu_torch.sfm import geometry as G

    rng = np.random.default_rng(seed)
    W, H = 1024, 768
    intr = np.array([800.0, 800.0, W / 2, H / 2, -0.05, 0.0, 0.0, 0.0])
    X = rng.uniform([-4, -3, 8], [4, 3, 16], (n_points, 3))
    side = int(np.ceil(np.sqrt(n_poses)))
    poses = []
    for i in range(n_poses):
        rv = rng.normal(0, 0.05, 3)
        c = np.array([(i % side - (side - 1) / 2) * 0.5, (i // side - (side - 1) / 2) * 0.4,
                      rng.uniform(-1.0, 0.0)])
        poses.append(np.concatenate([rv, -G.rotvec_to_matrix(rv) @ c]))
    poses = np.stack(poses)
    cols = [[], [], []]
    for i, p in enumerate(poses):
        uv, z = G.project_points(intr, G.rotvec_to_matrix(p[:3]), p[3:], X)
        idx = np.nonzero((z > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < W)
                         & (uv[:, 1] >= 0) & (uv[:, 1] < H))[0]
        cols[0].append(np.full(len(idx), i))
        cols[1].append(idx)
        cols[2].append(uv[idx])
    obs_pose, obs_pt, uv = (np.concatenate(c) for c in cols)
    keep = rng.random(len(obs_pose)) < min(1.0, n_obs / len(obs_pose))
    obs_pose, obs_pt = obs_pose[keep], obs_pt[keep]
    uv = uv[keep] + rng.normal(0, noise, (int(keep.sum()), 2))
    poses0 = poses + rng.normal(0, 0.02, poses.shape)
    poses0[0] = poses[0]
    X0 = X + rng.normal(0, 0.05, X.shape)
    intr0 = intr.copy()
    intr0[0:2] *= 1.055
    intr0[4] = 0.0
    pose_free = np.ones((n_poses, 6))
    pose_free[0] = 0.0
    pose_free[1, 3] = 0.0
    intr_free = np.array([[1.0, 1.0, 0, 0, 1.0, 0, 0, 0]])
    args = (poses0, intr0[None], X0, obs_pose, np.zeros_like(obs_pose), obs_pt, uv,
            pose_free, intr_free)
    return args, (obs_pose, obs_pt, uv)


def reprojection_rms(poses, intr, points, obs) -> float:
    """RMS of the observations' 2D reprojection errors (px)."""
    import numpy as np

    from deep_image_matching_tpu_torch.sfm import geometry as G

    obs_pose, obs_pt, uv = obs
    sq = 0.0
    for i in range(len(poses)):
        sel = obs_pose == i
        proj, _ = G.project_points(intr, G.rotvec_to_matrix(poses[i, :3]), poses[i, 3:],
                                   points[obs_pt[sel]])
        sq += float(((proj - uv[sel]) ** 2).sum())
    return float(np.sqrt(sq / len(obs_pose)))


def mapper_scene(root: Path, n_imgs: int = 60, n_pts: int = 6000, window: int = 40,
                 seed: int = 0):
    """The JAX package's ``scripts/profile_mapper.py::build_scene`` on the
    port's modules: a ring of ``n_imgs`` cameras (SIMPLE_RADIAL, f = 1100,
    1024 x 768) around ``n_pts`` points, verified pairs within ``window``
    images of each other (70 % of their common points, pairs under 20
    dropped), 0.4 px of noise, written as a COLMAP database. Returns (the
    database, the camera's (f, cx, cy, k1), the ground-truth poses)."""
    import numpy as np

    from deep_image_matching_tpu_torch.io.colmap_db import COLMAPDatabase
    from deep_image_matching_tpu_torch.sfm import geometry as G

    rng = np.random.default_rng(seed)
    W, H, f = 1024, 768, 1100.0
    intr = np.array([f, W / 2, H / 2, -0.03])
    X = rng.uniform([-4, -3, 6], [4, 3, 14], (n_pts, 3))
    poses = []
    for i in range(n_imgs):
        ang = 0.7 * np.sin(2 * np.pi * i / n_imgs)
        R = G.rotvec_to_matrix(np.array([0.0, ang, 0.0]))
        C = np.array([6.0 * np.sin(ang), 0.3 * np.sin(3 * ang), -2.0 + 0.5 * np.cos(ang)])
        poses.append(np.concatenate([G.matrix_to_rotvec(R), -R @ C]))
    poses = np.stack(poses)
    kpts, vis_ids = [], []
    for p in poses:
        uv, z = G.project_points(intr, G.rotvec_to_matrix(p[:3]), p[3:], X)
        ids = np.where((z > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < W)
                       & (uv[:, 1] >= 0) & (uv[:, 1] < H))[0]
        ids = ids[rng.permutation(len(ids))]
        kpts.append(uv[ids] + rng.normal(0, 0.4, (len(ids), 2)))
        vis_ids.append(ids)
    root.mkdir(parents=True, exist_ok=True)
    db_path = root / "database.db"
    db_path.unlink(missing_ok=True)
    db = COLMAPDatabase.connect(db_path)
    db.create_tables()
    cam_id = db.add_camera(2, W, H, intr)
    img_ids = []
    for i in range(n_imgs):
        iid = db.add_image(f"img{i:03d}.jpg", cam_id)
        db.add_keypoints(iid, kpts[i].astype(np.float32))
        img_ids.append(iid)
    for i in range(n_imgs):
        for j in range(i + 1, min(i + 1 + window, n_imgs)):
            _, ia, ib = np.intersect1d(vis_ids[i], vis_ids[j], return_indices=True)
            m = np.stack([ia, ib], axis=1).astype(np.uint32)
            m = m[rng.random(len(m)) < 0.7]
            if len(m) < 20:
                continue
            db.add_matches(img_ids[i], img_ids[j], m)
            db.add_two_view_geometry(img_ids[i], img_ids[j], m)
    db.commit()
    db.close()
    return db_path, intr, poses


def check_mapper_model(images, cameras, intr, poses, min_registered: int, focal_tol: float,
                       rot_tol_deg: float) -> str:
    """A mapper's model against the scene's ground truth: images registered,
    focal error and the largest error of the pairwise relative rotations."""
    import numpy as np

    from deep_image_matching_tpu_torch.io.colmap_read_write_model import qvec2rotmat
    from deep_image_matching_tpu_torch.sfm import geometry as G

    if len(images) < min_registered:
        _fail(f"mapper registered {len(images)} images, fewer than {min_registered}")
    f = next(iter(cameras.values())).params[0]
    f_err = abs(f - intr[0]) / intr[0]
    R = {int(im.name[3:6]): qvec2rotmat(im.qvec) for im in images.values()}
    ids = sorted(R)
    rot = max(
        np.degrees(np.linalg.norm(G.matrix_to_rotvec(
            (R[j] @ R[i].T) @ (G.rotvec_to_matrix(poses[j, :3])
                               @ G.rotvec_to_matrix(poses[i, :3]).T).T)))
        for a, i in enumerate(ids) for j in ids[a + 1:])
    if f_err > focal_tol or rot > rot_tol_deg:
        _fail(f"mapper model: focal off by {100 * f_err:.3f} %, relative rotations by up to "
              f"{rot:.3f} deg (bounds {100 * focal_tol:.1f} %, {rot_tol_deg} deg)")
    return (f"{len(images)}/{len(poses)} registered, focal off by {100 * f_err:.4f} %, "
            f"relative rotations within {rot:.4f} deg")


def _reconstruction_ba(card: str) -> None:
    """BA alone at 64 poses / 8192 points / ~262k observations: the mapper's
    default solve (25 LM steps of 30 CG steps, float32) on the card, its
    error against the injected noise, ms a step between CUDA events, device
    time and launches a step under ``torch.profiler``, peak memory and the
    CPU's time for the same steps. Two solves on the card must agree bit for
    bit (the segment sums add in a fixed order). Card against CPU: the cost traces in
    float64 at 20 CG steps (CG amplifies rounding differences by about 1e6
    every ten steps, so the float32 traces of two summation orders part by
    up to a few 1e-3; their difference is printed, not held)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deep_image_matching_tpu_torch.sfm import ba
    from deep_image_matching_tpu_torch.utils.device import full_f32

    dev = torch.device("cuda", 0)
    args, obs = ba_scene()
    n_obs = len(obs[0])
    rms0 = reprojection_rms(args[0], args[1][0], args[2], obs)
    ba.bundle_adjust(*args, n_lm_iters=2, device=dev)  # warm-up: cuBLAS, the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = ba.bundle_adjust(*args, device=dev)  # MapperOptions' 25 LM, 30 CG steps
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    again = ba.bundle_adjust(*args, device=dev)
    if not all(np.array_equal(out[k], again[k]) for k in out):
        _fail("BA on the card: two solves of one problem differ")
    rms = reprojection_rms(out["poses"], out["intr"][0], out["points"], obs)
    poses_n, pts_n, _, _ = ba.normalize_scene(args[0], args[2])
    prob = ba.make_problem(poses_n, args[1], pts_n, *args[3:9], None, dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with full_f32():
        start.record()
        _, _, _, costs = ba.ba_solve(prob, 4.0, 25, 30)
        end.record()
        end.synchronize()
        ms_step = start.elapsed_time(end) / len(costs)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, _, _, c3 = ba.ba_solve(prob, 4.0, 3, 30)
            torch.cuda.synchronize()
    busy, launches, events = _device_busy(prof)
    if busy is None:
        dev_line = "device time and launches not measured (the profiler recorded no device event)"
    else:
        busy_step, per_step = busy / len(c3), launches / len(c3)
        dev_line = (f"device {busy_step:.3f} ms and {per_step:.0f} launches a step, idle "
                    f"{100 * (1 - busy_step / ms_step):.1f} % of {ms_step:.3f} ms")
    t0 = time.perf_counter()
    cpu = ba.bundle_adjust(*args, n_lm_iters=3, device="cpu")
    cpu_step = (time.perf_counter() - t0) / len(cpu["costs"])
    n = min(len(cpu["costs"]), len(out["costs"]))
    f32_rel = float(np.max(np.abs(out["costs"][:n] - cpu["costs"][:n]) / cpu["costs"][:n]))
    kw = dict(n_lm_iters=4, n_cg_iters=20, dtype=np.float64)
    g64, c64 = ba.bundle_adjust(*args, **kw, device=dev), ba.bundle_adjust(*args, **kw, device="cpu")
    n64 = min(len(g64["costs"]), len(c64["costs"]))
    rel64 = float(np.max(np.abs(g64["costs"][:n64] - c64["costs"][:n64]) / c64["costs"][:n64]))
    print(f"[stage5] BA alone: {len(args[0])} poses, {len(args[2])} points, {n_obs} observations; "
          f"{len(out['costs'])} LM steps, RMS {rms0:.3f} -> {rms:.4f} px (noise {BA_NOISE} px, "
          f"bound {1.5 * BA_NOISE:.2f}); bundle_adjust {wall:.3f} s; the solve {ms_step:.3f} ms "
          f"a step between CUDA events; {dev_line}; peak {peak:.3f} GiB; CPU "
          f"{1e3 * cpu_step:.1f} ms a step (3 steps) [{card}]", flush=True)
    for ms, count, name in events[:6]:
        print(f"[stage5] BA step's device time: {ms / len(c3):8.3f} ms, {count / len(c3):5.0f} "
              f"launches: {name[:100]}", flush=True)
    print(f"[stage5] BA card vs CPU: float64 cost traces (4 LM steps of 20 CG) within "
          f"{rel64:.2e} (rtol 1e-3); float32 (3 steps of 30 CG) within {f32_rel:.2e}; two "
          f"solves on the card bitwise equal", flush=True)
    if not np.isfinite(out["costs"]).all() or rms >= 1.5 * BA_NOISE:
        _fail(f"BA on the card ended at RMS {rms:.4f} px")
    if n64 < 2 or rel64 > 1e-3:
        _fail(f"BA card vs CPU: float64 cost traces differ by {rel64:.2e}")


class _LogLines:
    """Collects the messages of the port's logger inside the block."""

    def __init__(self):
        import logging

        self.lines = []
        self.handler = logging.Handler()
        self.handler.emit = lambda rec: self.lines.append(rec.getMessage())

    def __enter__(self):
        import logging

        logging.getLogger("dim_tpu_torch").addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        import logging

        logging.getLogger("dim_tpu_torch").removeHandler(self.handler)


def _reconstruction_mapper(card: str) -> None:
    """``native_incremental_mapping`` on the card at the JAX package's mapper
    profile size (``mapper_scene``: 60 images, 6000 points, window 40),
    against the ground truth: at least 58/60 registered, focal within 1 %,
    pairwise relative rotations within 0.5 deg; the phase table and the
    wall."""
    from deep_image_matching_tpu_torch.sfm.incremental import native_incremental_mapping

    root = WORK / "stage5" / "mapper60"
    db, intr, poses = mapper_scene(root)
    with _LogLines() as log:
        t0 = time.perf_counter()
        res = native_incremental_mapping(db, None, root, device="cuda")  # no images: no colors
        wall = time.perf_counter() - t0
    if res is None:
        _fail("the mapper gave no model on the 60-image scene")
    cameras, images, points = res
    summary = check_mapper_model(images, cameras, intr, poses, 58, 0.01, 0.5)
    start = next((i for i, m in enumerate(log.lines) if m.startswith("Mapper phase times")), None)
    table = [] if start is None else [log.lines[start]] + [
        m for m in log.lines[start + 1:start + 12] if m.startswith("  ")]
    for line in table:
        print(f"[stage5] mapper: {line.rstrip()}", flush=True)
    print(f"[stage5] mapper on {len(poses)} images: {summary}, {len(points)} points; wall "
          f"{wall:.2f} s [{card}]", flush=True)


def _run_stage5(pipeline: str, proj: Path, strategy: str, cfg: Path, outs: Path):
    """``run_matching`` without --skip_reconstruction; returns (its output
    directory, its model or None)."""
    from deep_image_matching_tpu_torch.__main__ import run_matching

    feature_path, _, model = run_matching({
        "dir": str(proj), "outs": str(outs), "pipeline": pipeline, "strategy": strategy,
        "force": True, "config_file": str(cfg),
    })
    return feature_path.parent, model


def _model_summary(model) -> tuple:
    """(registered image names or None without a model, point count)."""
    if model is None:
        return None, 0
    return sorted(im.name for im in model[1].values()), len(model[2])


def _verified(out_dir: Path) -> int:
    import sqlite3

    db = sqlite3.connect(str(out_dir / "database.db"))
    try:
        return int(db.execute("SELECT COALESCE(SUM(rows), 0) FROM two_view_geometries")
                   .fetchone()[0])
    finally:
        db.close()


def _same_model(a, b) -> bool:
    """Whether two mapper models are equal bit for bit: images, poses,
    cameras, point ids and coordinates."""
    import numpy as np

    (ca, ia, pa), (cb, ib, pb) = a, b
    return (ca.keys() == cb.keys() and ia.keys() == ib.keys() and pa.keys() == pb.keys()
            and all(np.array_equal(ca[k].params, cb[k].params) for k in ca)
            and all(np.array_equal(ia[k].qvec, ib[k].qvec) and np.array_equal(ia[k].tvec, ib[k].tvec)
                    for k in ia)
            and all(np.array_equal(pa[k].xyz, pb[k].xyz) for k in pa))


def _reconstruction_cli(card: str) -> dict:
    """The CLI through stage 5 on the demo images, launch counts set to 0
    before each card run and read after it:
    - sift+kornia_matcher (bruteforce) on the card and on the CPU must
      register the same images, the 5 demo images, and write the model's
      files. Their databases differ (the card verifies matches with the
      device RANSAC, kernel 4, the CPU with OpenCV's MAGSAC), so their point
      counts are printed, not held. Over the card run's database, stage 5
      again on the card must give the CLI's model bit for bit, and stage 5
      on the CPU the same registered images with a point count within 2 %;
    - superpoint+lightglue (the default matching_lowres; random weights, at
      match threshold 0 as in the main-path phase) must end on the card as
      on the CPU: the same registered images, or no model on both."""
    import torch

    from deep_image_matching_tpu_torch.io.colmap_read_write_model import read_model
    from deep_image_matching_tpu_torch.ops import _lib
    from deep_image_matching_tpu_torch.reconstruction import incremental_reconstruction

    root = WORK / "stage5"
    proj = root / "demo5"
    shutil.copytree(ROOT / "notebooks" / "demo_project" / "images", proj / "images",
                    dirs_exist_ok=True)
    base = "general:\n  allow_random_weights: true\n  tpu:\n    device: {}\n"
    launches = {}
    for pipeline, strategy, extra, needed in (
            ("sift+kornia_matcher", "bruteforce", "", ("nn", "nullspace")),
            ("superpoint+lightglue", "matching_lowres", "matcher:\n  filter_threshold: 0.0\n",
             ("attention", "ffn", "assignment", "nullspace"))):
        label = f"{pipeline} (stage 5)"
        cfg = {}
        for d in ("cuda", "cpu"):
            cfg[d] = root / f"{pipeline}_{d}.yaml"
            cfg[d].write_text(base.format(d) + extra)
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        out_dir, model = _run_stage5(pipeline, proj, strategy, cfg["cuda"],
                                     root / f"{pipeline}_cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[label] = dict(_lib.LAUNCHES)
        missing = [k for k in needed if launches[label][k] == 0]
        if missing:
            _fail(f"{label}: kernels {missing} of its path were never launched")
        names, n_pts = _model_summary(model)
        t0 = time.perf_counter()
        cpu_dir, cpu_model = _run_stage5(pipeline, proj, strategy, cfg["cpu"],
                                         root / f"{pipeline}_cpu")
        cpu_wall = time.perf_counter() - t0
        cpu_names, cpu_pts = _model_summary(cpu_model)
        if names != cpu_names:
            _fail(f"{label}: the card registered {names}, the CPU {cpu_names}")
        line = "no model on either" if names is None else (
            f"{len(names)}/5 registered, {n_pts} points from {_verified(out_dir)} verified "
            f"matches (CPU: the same images, {cpu_pts} points from {_verified(cpu_dir)})")
        if names is not None:
            rec = out_dir / "reconstruction"
            files = ("cameras.txt", "images.txt", "points3D.txt", "model.ply")
            if not all((rec / f).is_file() for f in files):
                _fail(f"{label}: reconstruction/ lacks one of {files}")
            _, imgs, pts = read_model(rec, ".txt")
            if len(imgs) != len(names) or len(pts) != n_pts:
                _fail(f"{label}: the written model holds {len(imgs)} images, {len(pts)} points")
            # stage 5 alone over the card run's database, on the card and on the CPU
            db = out_dir / "database.db"
            walls, again = {}, {}
            for d in ("cuda", "cpu"):
                t0 = time.perf_counter()
                again[d] = incremental_reconstruction(db, proj / "images",
                                                      root / f"{pipeline}_stage5_{d}", device=d)
                walls[d] = time.perf_counter() - t0
            if again["cuda"] is None or not _same_model(again["cuda"], model):
                _fail(f"{label}: stage 5 again on the card over its database gave another model")
            same_names, same_pts = _model_summary(again["cpu"])
            if same_names != names or abs(same_pts - n_pts) > 0.02 * n_pts:
                _fail(f"{label}: stage 5 over the card's database gave {same_names}, {same_pts} "
                      f"points on the CPU; {names}, {n_pts} on the card")
            line += (f"; stage 5 over the card's database: on the card the same model bit for "
                     f"bit in {walls['cuda']:.2f} s, on the CPU {same_pts} points in "
                     f"{walls['cpu']:.2f} s")
        if pipeline == "sift+kornia_matcher" and (names is None or len(names) != 5):
            _fail(f"{label}: registered {names}, expected the 5 demo images")
        print(f"[stage5] {label} on demo5 ({strategy}): {line}; run_matching card {wall:.2f} s, "
              f"CPU {cpu_wall:.2f} s; kernel launches "
              f"{ {k: v for k, v in launches[label].items() if v} } [{card}]", flush=True)
    return launches


def phase_reconstruction(card: str) -> dict:
    """Stage 5: BA alone, the mapper at profile size, the CLI through
    reconstruction. Returns the CLI runs' launch counts."""
    (WORK / "stage5").mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    _reconstruction_ba(card)
    _reconstruction_mapper(card)
    launches = _reconstruction_cli(card)
    print(f"[stage5] phase wall {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return launches


# ---------------------------------------------------------------------------
# retrieval pairs, the upright stage, the exports and the view graph
# ---------------------------------------------------------------------------

RETRIEVAL = ("netvlad", "openibl", "cosplace", "dir", "tiny")
# card against CPU, full f32 on both: descriptors are L2-normalised, so an
# absolute bound; pair ranks may differ only where two similarities tie
RETRIEVAL_TOL = 1e-4
NEAR_TIE = 1e-5


def _resnet_checkpoint(rng, stages, bottleneck: bool, proj: int, prefix: str, proj_key: str,
                       gem_key: str) -> dict:
    """A seeded torchvision-style ResNet checkpoint (BatchNorm with running
    statistics; each residual branch's last BatchNorm scaled down, the
    zero-init-residual practice, so 33 blocks keep activations finite), a
    projection and a GeM exponent, keys under ``prefix``."""
    import numpy as np
    import torch

    sd = {}

    def conv(name, co, ci, k):
        sd[f"{name}.weight"] = rng.standard_normal((co, ci, k, k), np.float32) * np.float32(
            (2.0 / (ci * k * k)) ** 0.5)

    def bn(name, n, scale=(0.5, 1.5)):
        sd[f"{name}.weight"] = rng.uniform(*scale, n).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(0, 0.1, n).astype(np.float32)
        sd[f"{name}.running_mean"] = rng.normal(0, 0.1, n).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for si, (n, cout, s) in enumerate(stages):
        for bi in range(n):
            p = f"layer{si + 1}.{bi}"
            shapes = ([(cout // 4, cin, 1), (cout // 4, cout // 4, 3), (cout, cout // 4, 1)]
                      if bottleneck else [(cout, cin, 3), (cout, cout, 3)])
            for k, (co, ci, ks) in enumerate(shapes, 1):
                conv(f"{p}.conv{k}", co, ci, ks)
                bn(f"{p}.bn{k}", co, (0.05, 0.15) if k == len(shapes) else (0.5, 1.5))
            if (s if bi == 0 else 1) != 1 or cin != cout:
                conv(f"{p}.downsample.0", cout, cin, 1)
                bn(f"{p}.downsample.1", cout)
            cin = cout
    sd[f"{proj_key}.weight"] = (rng.standard_normal((proj, cin), np.float32)
                                * np.float32(cin ** -0.5))
    sd[f"{proj_key}.bias"] = np.zeros(proj, np.float32)
    sd[gem_key] = np.array([3.0], np.float32)
    return {prefix + k: torch.from_numpy(v) for k, v in sd.items()}


def retrieval_weights(wdir: Path, seed: int = 0) -> None:
    """Seeded checkpoints of the four learned retrieval networks at their
    published widths, each in its file's own layout: ``netvlad.npz`` (the
    JAX package's arrays under flat names: VGG16 HWIO convolutions, 64
    clusters x 512, the (D, K) assignment, PCA 32768 -> 4096),
    ``vgg16_netvlad.pth`` (OpenIBL: ``base_model.*``, ``net_vlad.*`` with an
    assignment bias), ``cosplace.pth`` (ResNet-18, GeM, 512 -> 512) and
    ``Resnet101-AP-GeM-LM18.pt`` (DIR: ResNet-101 under ``module.``, GeM,
    whitening 2048 -> 2048)."""
    import numpy as np
    import torch

    from deep_image_matching_tpu_torch.models.retrieval import (
        R18_STAGES, R101_STAGES, VGG16_WIDTHS, vgg16_conv_indices)

    rng = np.random.default_rng(seed)
    K = 64

    def normal(shape, std):
        return rng.standard_normal(shape, np.float32) * np.float32(std)

    flat, openibl, cin = {}, {}, 3
    for i, (idx, c) in enumerate(zip(vgg16_conv_indices(), VGG16_WIDTHS)):
        w = normal((c, cin, 3, 3), (2.0 / (9 * cin)) ** 0.5)
        flat[f"backbone.convs.{i}.w"] = w.transpose(2, 3, 1, 0).copy()
        flat[f"backbone.convs.{i}.b"] = np.zeros(c, np.float32)
        openibl[f"base_model.{idx}.weight"] = torch.from_numpy(normal((c, cin, 3, 3),
                                                                      (2.0 / (9 * cin)) ** 0.5))
        openibl[f"base_model.{idx}.bias"] = torch.zeros(c)
        cin = c
    flat["centers"] = normal((K, cin), 0.05)
    flat["assign_w"] = normal((cin, K), 2.0)
    flat["pca_w"] = normal((K * cin, 4096), (K * cin) ** -0.5)
    flat["pca_b"] = np.zeros(4096, np.float32)
    np.savez(wdir / "netvlad.npz", **flat)
    openibl["net_vlad.centroids"] = torch.from_numpy(normal((K, cin), 0.05))
    openibl["net_vlad.conv.weight"] = torch.from_numpy(normal((K, cin, 1, 1), 2.0))
    openibl["net_vlad.conv.bias"] = torch.from_numpy(normal((K,), 0.1))
    torch.save({"state_dict": openibl}, wdir / "vgg16_netvlad.pth")
    torch.save(_resnet_checkpoint(rng, R18_STAGES, False, 512, "backbone.", "aggregation.3",
                                  "aggregation.1.p"), wdir / "cosplace.pth")
    torch.save({"state_dict": _resnet_checkpoint(rng, R101_STAGES, True, 2048, "module.", "fc",
                                                 "adpool.p")}, wdir / "Resnet101-AP-GeM-LM18.pt")


def _pairs_agree(names, pa, pb, descs, k: int, what: str) -> str:
    """Two top-k pair lists of the same images (``descs``' similarities):
    equal, or differing only in pairs whose similarity ties the k-th of one
    of its images within NEAR_TIE; returns a summary."""
    import numpy as np

    if pa == pb:
        return f"top-{k} pairs equal ({len(pa)})"
    sim = descs @ descs.T
    np.fill_diagonal(sim, -np.inf)
    kth = np.sort(sim, axis=1)[:, ::-1][:, k - 1]
    idx = {n: i for i, n in enumerate(names)}
    for x, y in set(pa) ^ set(pb):
        i, j = idx[x], idx[y]
        gap = min(abs(sim[i, j] - kth[i]), abs(sim[i, j] - kth[j]))
        if gap > NEAR_TIE:
            _fail(f"{what}: pair ({x}, {y}) differs, {gap:.2e} from the k-th similarity")
    return f"top-{k} pairs equal but for {len(set(pa) ^ set(pb))} near-ties"


def phase_retrieval(card: str) -> dict:
    """Retrieval pairs: the five global descriptors at full width (seeded
    checkpoints in a temporary DIM_TPU_WEIGHTS_DIR) on the 16 synthetic
    views, on the card (a warm call timed, one under torch.profiler) and on
    the CPU: descriptors within RETRIEVAL_TOL, top-10 pairs equal; then
    ``run_matching --strategy retrieval --global_feature netvlad`` with
    superpoint+lightglue, whose kernels 1-4 must launch. Returns that run's
    launches."""
    import numpy as np
    import torch

    from deep_image_matching_tpu_torch import image_retrieval as tir
    from deep_image_matching_tpu_torch.ops import _lib
    from deep_image_matching_tpu_torch.utils import weights
    from deep_image_matching_tpu_torch.utils.image import ImageList

    t_phase = time.perf_counter()
    root = WORK / "retrieval"
    wdir = root / "weights"
    wdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    retrieval_weights(wdir)
    size = sum(p.stat().st_size for p in wdir.iterdir()) / 2 ** 20
    print(f"[retrieval] seeded checkpoints ({size:.0f} MiB) written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    proj = WORK / "synthetic16"
    if not (proj / "images").is_dir():
        _synthetic_project(proj)
    il = ImageList(proj / "images")
    names = il.img_names
    descs = {}
    with _env({"DIM_TPU_WEIGHTS_DIR": str(wdir)}), weights.strict():
        for kind in RETRIEVAL:
            t0 = time.perf_counter()
            model = tir.load_model(kind)
            load = time.perf_counter() - t0
            if (model is None) != (kind == "tiny"):
                _fail(f"retrieval {kind}: the checkpoint did not load")
            tir.compute_global_descriptors(il, kind, device="cuda", model=model)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gpu = tir.compute_global_descriptors(il, kind, device="cuda", model=model)
            wall = time.perf_counter() - t0
            prof_wall, (busy, n_events, events) = _profiled(
                lambda: tir.compute_global_descriptors(il, kind, device="cuda", model=model))
            if busy is None:
                _fail(f"retrieval {kind}: the profiler recorded no device event")
            t0 = time.perf_counter()
            cpu = tir.compute_global_descriptors(il, kind, device="cpu", model=model)
            cpu_wall = time.perf_counter() - t0
            err = float(np.abs(gpu - cpu).max())
            if not np.isfinite(gpu).all() or err > RETRIEVAL_TOL:
                _fail(f"retrieval {kind}: card against CPU max abs err {err:.3e}")
            if not np.allclose(np.linalg.norm(gpu, axis=1), 1.0, atol=1e-5):
                _fail(f"retrieval {kind}: descriptors not L2-normalised")
            ranks = _pairs_agree(names, tir.pairs_from_descriptors(names, gpu, 10),
                                 tir.pairs_from_descriptors(names, cpu, 10), gpu, 10,
                                 f"retrieval {kind}")
            descs[kind] = gpu
            top = "; ".join(f"{ms:.1f} ms x{n} {key[:50]}" for ms, n, key in events[:3])
            print(f"[retrieval] {kind}: {gpu.shape[1]}-D on {len(names)} views of "
                  f"{il[0].width} x {il[0].height} (at 640 x 480, batches of 8): card "
                  f"{wall * 1e3:.1f} ms warm (load {load:.2f} s), CPU {cpu_wall * 1e3:.1f} ms; "
                  f"device busy {busy:.1f} ms in {n_events} events, idle {100 * (1 - busy / (prof_wall * 1e3)):.1f} % of "
                  f"{prof_wall * 1e3:.1f} ms; card vs CPU max abs err {err:.2e} (tol "
                  f"{RETRIEVAL_TOL:.0e}), {ranks}; top: {top} [{card}]", flush=True)
            del model
            torch.cuda.empty_cache()

    cfg = root / "retrieval.yaml"
    cfg.write_text("general:\n  allow_random_weights: true\n  tpu:\n    device: cuda\n"
                   "matcher:\n  filter_threshold: 0.0\n")
    label = "superpoint+lightglue --strategy retrieval --global_feature netvlad"
    timers = _TimerLog()
    _lib.reset_launch_counts()
    from deep_image_matching_tpu_torch.__main__ import run_matching

    t0 = time.perf_counter()
    with _env({"DIM_TPU_WEIGHTS_DIR": str(wdir)}):
        feature_path, _, _ = run_matching({
            "dir": str(proj), "outs": str(root / "out"), "pipeline": "superpoint+lightglue",
            "strategy": "retrieval", "global_feature": "netvlad", "skip_reconstruction": True,
            "force": True, "config_file": str(cfg)})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {label: dict(_lib.LAUNCHES)}
    missing = [k for k in ("attention", "ffn", "assignment", "nullspace") if not launches[label][k]]
    if missing:
        _fail(f"{label}: kernels {missing} of its path were never launched")
    out_dir = feature_path.parent
    pairs = [tuple(line.split()) for line in (out_dir / "pairs.txt").read_text().splitlines()]
    summary, _ = _check_outputs(out_dir, names, len(pairs), 256)
    ranks = _pairs_agree(names, sorted(pairs),
                         tir.pairs_from_descriptors(names, descs["netvlad"], 10),
                         descs["netvlad"], 10, label)
    stages = timers.lines[-1].split("] ", 2)[-1] if timers.lines else "no timer line"
    print(f"[retrieval] {label} on synthetic16: {len(pairs)} of "
          f"{len(names) * (len(names) - 1) // 2} pairs, against NetVLAD's on the card: {ranks}; "
          f"{summary}; run_matching {wall:.2f} s; stages {stages}; kernel launches "
          f"{ {k: v for k, v in launches[label].items() if v} } [{card}]", flush=True)
    print(f"[retrieval] phase wall {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return launches


# the upright project: the reference view (the first name) rotated by these
# degrees clockwise, lossless; the upright stage must undo each
UPRIGHT_PLANTED = (90, 180, 270)


def _upright_project(root: Path) -> dict:
    """The 5 demo images as PNG and three copies of the first, sacre_coeur_A,
    rotated by UPRIGHT_PLANTED (lossless PNG, so an exact rotation of its
    pixels), with rotations.txt naming the rotations that undo them. Returns
    {copy name: degrees that make it upright}."""
    import cv2

    from deep_image_matching_tpu_torch.upright import rotate_image

    images = root / "images"
    images.mkdir(parents=True, exist_ok=True)
    for p in sorted((ROOT / "notebooks" / "demo_project" / "images").iterdir()):
        cv2.imwrite(str(images / f"{p.stem}.png"), cv2.imread(str(p), cv2.IMREAD_COLOR))
    ref = cv2.imread(str(images / "sacre_coeur_A.png"), cv2.IMREAD_COLOR)
    planted = {}
    for deg in UPRIGHT_PLANTED:
        name = f"sacre_coeur_A_rot{deg:03d}.png"
        cv2.imwrite(str(images / name), rotate_image(ref, deg))
        planted[name] = (360 - deg) % 360
    (images / "rotations.txt").write_text("".join(f"{n} {d}\n" for n, d in planted.items()))
    return planted


def _probe_kernel_check(card: str) -> dict:
    """Kernel 5 at the upright probe's shapes, (4, 512, 256) (SuperPoint) and
    (4, 512, 128) (ALIKED), valid rows 30-100 % of the capacity as prefixes:
    ``nn_top2`` against its plain version (values within 1e-4, argmins equal
    away from near-ties) and ``nn_match_fused``'s matches against the dense
    plain route, with both times and both bounds."""
    import torch

    from deep_image_matching_tpu_torch.ops.nn import nn_match_fused, nn_top2, nn_top2_reference
    from deep_image_matching_tpu_torch.ops.nn_match import nn_match_batch

    F = torch.nn.functional
    dev = torch.device("cuda", 0)
    out = {}
    for D in (256, 128):
        gen = torch.Generator().manual_seed(30 + D)
        B, K = 4, 512
        d0 = F.normalize(torch.randn(B, K, D, generator=gen), dim=-1)
        d1 = F.normalize(torch.randn(B, K, D, generator=gen), dim=-1)
        perm = torch.randperm(K, generator=gen)[:K // 4]
        d1[:, perm] = F.normalize(d0[:, :K // 4] + 0.05 * torch.randn(B, K // 4, D, generator=gen),
                                  dim=-1)
        counts0 = torch.tensor([K, int(0.3 * K), int(0.6 * K), int(0.9 * K)])
        counts1 = torch.tensor([int(0.3 * K), K, int(0.8 * K), int(0.45 * K)])
        m0 = (torch.arange(K)[None] < counts0[:, None]).to(dev)
        m1 = (torch.arange(K)[None] < counts1[:, None]).to(dev)
        d0, d1 = (d0 * m0[..., None].cpu()).to(dev), (d1 * m1[..., None].cpu()).to(dev)
        sq1 = (d1 ** 2).sum(-1) + torch.where(m1, 0.0, 1e12)
        got, ref = nn_top2(d0, d1, sq1), nn_top2_reference(d0, d1, sq1)
        err = max(float((got[0] - ref[0]).abs().max()), float((got[1] - ref[1]).abs().max()))
        clear = (ref[1] - ref[0]) > 1e-3
        if err > 1e-4 or not bool((got[2] == ref[2])[clear].all()):
            _fail(f"kernel 5 at the probe's (4, 512, {D}): max abs err {err:.3e}")
        mg, _ = nn_match_fused(d0, d1, m0, m1)
        mr, _ = nn_match_batch(d0, d1, m0, m1)
        share = float((mg == mr).float().mean())
        if share < 0.995:
            _fail(f"kernel 5 at the probe's (4, 512, {D}): matches equal on {share:.4f}")
        ms = _time_ms(lambda: nn_top2(d0, d1, sq1))
        plain = _time_ms(lambda: nn_top2_reference(d0, d1, sq1))
        # at this size the host's dispatch of the split, the kernel and the
        # merge sets the time between CUDA events; the device's own time of
        # the three
        dev_ms = _device_ms(lambda: nn_top2(d0, d1, sq1),
                            ("nn_top2_sm90", "nn_split_kernel", "nn_merge_kernel"))
        row = out[f"4x512x{D}"] = {
            "max_abs_err": err, "matches_equal": share, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain, **_nn_bounds(_nbytes(d0, d1, sq1, *got), B, K, K, D)}
        print(f"[upright] kernel 5 at the probe's (4, 512, {D}): max_abs_err {err:.3e} (tol "
              f"1.0e-04), nn_match_fused's matches equal to the plain route on {share:.4f} "
              f"(>= 0.995); kernel {ms:.4f} ms (device alone "
              f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}), plain "
              f"{plain:.4f} ms, three-TF32 bound "
              f"{row['bound_ms']:.5f} ms ({100 * row['bound_ms'] / ms:.1f} %), FFMA bound "
              f"{row['ffma_bound_ms']:.5f} ms [{card}]", flush=True)
    return out


def phase_upright(card: str) -> tuple:
    """``--upright``: the 2clusters probe on the card (planted rotations
    recovered, the same rotations as on the CPU for the planted copies, its
    device time), kernel 5 at the probe's shapes, then ``run_matching
    --upright`` with superpoint+lightglue under ``upright_strategy: custom``
    (features.h5 holds each copy's keypoints in its own frame: the reference's
    keypoints rotated into it, with the copy's image_size) and under
    ``2clusters`` (kernel 5 must launch; the upright copies equal the
    reference). Returns (the counted runs' launches, kernel 5's report at the
    probe's shapes)."""
    import cv2
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deep_image_matching_tpu_torch import upright
    from deep_image_matching_tpu_torch.__main__ import run_matching
    from deep_image_matching_tpu_torch.io import hdf5
    from deep_image_matching_tpu_torch.ops import _lib
    from deep_image_matching_tpu_torch.utils.image import ImageList

    t_phase = time.perf_counter()
    root = WORK / "upright"
    planted = _upright_project(root)
    images = root / "images"
    names = ImageList(images).img_names
    ref_name = names[0]
    with _env({"DIM_TPU_ALLOW_RANDOM_WEIGHTS": "1"}):
        upright._probe_rotations(ImageList(images), device="cuda")  # warm
        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rot = upright._probe_rotations(ImageList(images), device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        n_nn = _lib.LAUNCHES["nn"]
        t0 = time.perf_counter()
        rot_cpu = upright._probe_rotations(ImageList(images), device="cpu")
        cpu_wall = time.perf_counter() - t0
    busy, n_events, _ = _device_busy(prof)
    wrong = {n: rot[n] for n in planted if rot[n] != planted[n]}
    if wrong or any(rot_cpu[n] != planted[n] for n in planted):
        _fail(f"upright 2clusters: planted {planted}, the card found {rot}, the CPU {rot_cpu}")
    if n_nn != 2 * (len(names) - 1):
        _fail(f"upright 2clusters: {n_nn} launches of kernel 5, expected {2 * (len(names) - 1)}")
    print(f"[upright] 2clusters probe on {len(names)} images (the 5 demo images + "
          f"{len(planted)} rotated copies of {ref_name}): card {wall * 1e3:.1f} ms warm, device "
          f"busy {busy or 0:.1f} ms in {n_events or 0} events, idle "
          f"{100 * (1 - (busy or 0) / (wall * 1e3)):.1f} %, kernel 5 launched {n_nn} times; CPU "
          f"{cpu_wall * 1e3:.1f} ms; planted {planted} recovered on both; card {rot}, CPU "
          f"{rot_cpu} [{card}]", flush=True)
    probe_report = _probe_kernel_check(card)

    launches = {}
    base = ("general:\n  allow_random_weights: true\n  upright_strategy: {}\n  tpu:\n"
            "    device: cuda\nmatcher:\n  filter_threshold: 0.0\n")
    timers = _TimerLog()
    for strategy, needed in (("custom", ("attention", "ffn", "assignment", "nullspace")),
                             ("2clusters", ("attention", "ffn", "assignment", "nullspace", "nn"))):
        label = f"superpoint+lightglue --upright ({strategy})"
        cfg = root / f"{strategy}.yaml"
        cfg.write_text(base.format(strategy))
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        feature_path, match_path, _ = run_matching({
            "dir": str(root), "outs": str(root / f"out_{strategy}"),
            "pipeline": "superpoint+lightglue", "strategy": "bruteforce", "upright": True,
            "skip_reconstruction": True, "force": True, "config_file": str(cfg)})
        torch.cuda.synchronize()
        run_wall = time.perf_counter() - t0
        launches[label] = dict(_lib.LAUNCHES)
        missing = [k for k in needed if not launches[label][k]]
        if missing:
            _fail(f"{label}: kernels {missing} of its path were never launched")
        out_dir = feature_path.parent
        up_dir = out_dir / "upright_images"
        ref_px = cv2.imread(str(images / ref_name), cv2.IMREAD_UNCHANGED)
        for name in planted:
            if not np.array_equal(cv2.imread(str(up_dir / name), cv2.IMREAD_UNCHANGED), ref_px):
                _fail(f"{label}: the upright copy of {name} is not the reference's pixels")
        summary, _ = _check_outputs(out_dir, names, len(names) * (len(names) - 1) // 2, 256)
        lines = []
        with hdf5.File(feature_path, "r") as f:
            k_ref = np.asarray(f[ref_name]["keypoints"])
            h, w = ref_px.shape[:2]
            for name, deg in planted.items():
                k = np.asarray(f[name]["keypoints"])
                size = tuple(int(v) for v in np.asarray(f[name]["image_size"]))
                ch, cw = cv2.imread(str(images / name), cv2.IMREAD_UNCHANGED).shape[:2]
                if size != (cw, ch):
                    _fail(f"{label}: image_size of {name} {size}, its frame ({cw}, {ch})")
                want = upright.rotate_keypoints_back(k_ref, deg, (w, h))
                if len(k) != len(k_ref):
                    _fail(f"{label}: {name} holds {len(k)} keypoints, the reference {len(k_ref)}")
                same = float((np.abs(k - want).max(axis=1) <= 1e-3).mean())
                if same < 0.99:
                    _fail(f"{label}: only {same:.3f} of {name}'s keypoints are the reference's "
                          f"rotated into its frame")
                lines.append(f"{name}: {len(k)} keypoints in its {cw} x {ch} frame, "
                             f"{same:.4f} equal to the reference's rotated by {(360 - deg) % 360}")
        for path, what in ((out_dir / "raw_matches.h5", "raw"), (match_path, "verified")):
            with hdf5.File(path, "r") as m:
                counts = []
                for name in planted:
                    a, b = sorted((ref_name, name))
                    counts.append(len(np.asarray(m[a][b])) if a in m and b in m[a] else 0)
            lines.append(f"{what} matches of the reference with its copies {counts}")
        stages = timers.lines[-1].split("] ", 2)[-1] if timers.lines else "no timer line"
        print(f"[upright] {label}: {summary}; {'; '.join(lines)}; run_matching {run_wall:.2f} s; "
              f"stages {stages}; kernel launches "
              f"{ {k: v for k, v in launches[label].items() if v} } [{card}]", flush=True)
    print(f"[upright] phase wall {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return launches, probe_report


def _read_putative(path: Path) -> dict:
    """OpenMVG's binary PairWiseMatches: {(view, view): match count}."""
    import numpy as np

    raw = path.read_bytes()
    n, off, out = int.from_bytes(raw[1:9], "little"), 9, {}
    for _ in range(n):
        i, j = np.frombuffer(raw, np.int32, 2, off)
        k = int.from_bytes(raw[off + 8:off + 16], "little")
        out[(int(i), int(j))] = k
        off += 16 + 8 * k
    if off != len(raw):
        _fail(f"{path}: {len(raw) - off} trailing bytes")
    return out


def phase_exports(card: str) -> dict:
    """The exports and the view graph, on the sift+kornia_matcher demo run
    through stage 5 of ``phase_reconstruction``: Bundler, Metashape, MicMac
    (and its import back to h5), OpenMVG, the view graph; each file must
    exist and the tie-point counts agree with matches.h5 and database.db;
    then a ``run_matching --openmvg`` run. All of it host work: the
    profiler must record no device event outside the CLI run. Returns the
    CLI run's launches."""
    import json
    import sqlite3

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deep_image_matching_tpu_torch.__main__ import run_matching
    from deep_image_matching_tpu_torch.graph import view_graph
    from deep_image_matching_tpu_torch.io import hdf5
    from deep_image_matching_tpu_torch.io.h5_to_bundler import export_to_bundler
    from deep_image_matching_tpu_torch.io.h5_to_metashape import export_to_metashape
    from deep_image_matching_tpu_torch.io.h5_to_micmac import export_to_micmac
    from deep_image_matching_tpu_torch.io.h5_to_openmvg import export_to_openmvg
    from deep_image_matching_tpu_torch.io.micmac_to_h5 import micmac_to_h5
    from deep_image_matching_tpu_torch.ops import _lib

    t_phase = time.perf_counter()
    src = WORK / "stage5" / "sift+kornia_matcher_cuda"
    images = WORK / "stage5" / "demo5" / "images"
    feats, matches, db = src / "features.h5", src / "matches.h5", src / "database.db"
    out = WORK / "exports"
    shutil.rmtree(out, ignore_errors=True)
    with hdf5.File(matches, "r") as m:
        per_pair = {(a, b): len(np.asarray(m[a][b])) for a in m for b in m[a]}
    total = sum(per_pair.values())
    con = sqlite3.connect(str(db))
    try:
        db_total = int(con.execute("SELECT COALESCE(SUM(rows), 0) FROM two_view_geometries")
                       .fetchone()[0])
        n_images = int(con.execute("SELECT COUNT(*) FROM images").fetchone()[0])
    finally:
        con.close()
    if not total or db_total != total:
        _fail(f"exports: matches.h5 holds {total} verified matches, database.db {db_total}")
    walls = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bundler = export_to_bundler(images, feats, matches, out / "bundler")
        walls["bundler"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        meta = export_to_metashape(images, feats, matches, out / "metashape")
        walls["metashape"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mm = export_to_micmac(images, feats, matches, out / "micmac")
        back_f, back_m = micmac_to_h5(mm / "Homol", out / "micmac_features.h5",
                                      out / "micmac_matches.h5")
        walls["micmac + import"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mvg = export_to_openmvg(images, feats, matches, out / "openmvg")
        walls["openmvg"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        view_graph(db, out / "graph", images)
        walls["view graph"] = time.perf_counter() - t0
        torch.cuda.synchronize()
    busy, _, _ = _device_busy(prof)
    if busy is not None:
        _fail(f"exports: {busy:.2f} ms of device work in host-only exports")

    # Bundler and Metashape: the same Bundler file; tracks of >= 2 images
    head = bundler.read_text().splitlines()
    n_cams, n_tracks = map(int, head[1].split())
    obs = [int(head[2 + 5 * n_cams + 3 * t + 2].split()[0]) for t in range(n_tracks)]
    if meta.read_bytes() != bundler.read_bytes() or n_cams != n_images or min(obs) < 2:
        _fail(f"exports: Bundler {n_cams} cameras, {n_tracks} tracks; Metashape "
              f"{'equal' if meta.read_bytes() == bundler.read_bytes() else 'different'}")
    if not (out / "metashape" / "README_metashape.txt").is_file():
        _fail("exports: the Metashape README is missing")
    # MicMac: one Homol line per verified match, both directions
    homol = {}
    for (a, b), n in per_pair.items():
        for x, y in ((a, b), (b, a)):
            f = mm / "Homol" / f"Pastis{x}" / f"{y}.txt"
            homol[(x, y)] = len(f.read_text().splitlines()) if f.is_file() else -1
            if homol[(x, y)] != max(n, 1):
                _fail(f"exports: Homol {x} -> {y} holds {homol[(x, y)]} lines, {n} matches")
    # the import keeps one tie point per keypoint position (1e-3 px) and
    # pair, the first: SIFT's keypoints repeat positions with other
    # orientations, so it holds fewer than the Homol lines
    with hdf5.File(back_m, "r") as m:
        back = {(a, b): len(np.asarray(m[a][b])) for a in m for b in m[a]}
    want = {}
    for (a, b), n in per_pair.items():
        if n:
            rows = [tuple(round(float(v) * 1000) for v in line.split()[:4]) for line in
                    (mm / "Homol" / f"Pastis{a}" / f"{b}.txt").read_text().splitlines()]
            seen, first = set(), []
            for r in rows:
                if r[:2] not in seen:
                    seen.add(r[:2])
                    first.append(r)
            want[(a, b)] = len({r[2:] for r in first})
    if back != want:
        _fail(f"exports: the MicMac import holds {sum(back.values())} tie points over "
              f"{len(back)} pairs, the Homol tree's distinct ones {sum(want.values())} over "
              f"{len(want)}")
    # OpenMVG: the putative matches are matches.h5's
    putative = _read_putative(mvg / "matches" / "matches.putative.bin")
    sfm = json.loads((mvg / "matches" / "sfm_data.json").read_text())
    feat_files = list((mvg / "matches").glob("*.feat"))
    if sum(putative.values()) != total or len(sfm["views"]) != n_images or \
            len(feat_files) != n_images or not (mvg / "matches" / "matches.f.bin").is_file():
        _fail(f"exports: OpenMVG {sum(putative.values())} putative matches, "
              f"{len(sfm['views'])} views, {len(feat_files)} .feat files")
    # the view graph: one edge per verified pair
    html = (out / "graph" / "graph.html").read_text()
    n_edges = html.count(" matches'}")
    csv_rows = len((out / "graph" / "communities.csv").read_text().splitlines()) - 1
    mst = len((out / "graph" / "mst_pairs.txt").read_text().splitlines())
    parent = {}

    def find(x):
        while parent.setdefault(x, x) != x:
            x = parent[x]
        return x

    for a, b in per_pair:
        parent[find(a)] = find(b)
    n_trees = len({find(x) for x in parent})
    if n_edges != len(per_pair) or csv_rows != len(parent) or mst != len(parent) - n_trees:
        _fail(f"exports: view graph {n_edges} edges, {csv_rows} community rows, {mst} tree "
              f"pairs; {len(per_pair)} verified pairs over {len(parent)} linked images")
    print(f"[exports] sift+kornia_matcher demo5 (stage 5's card run): {total} verified matches "
          f"over {len(per_pair)} pairs in matches.h5 and database.db; Bundler = Metashape: "
          f"{n_cams} cameras, {n_tracks} tracks, {sum(obs)} observations; MicMac "
          f"{sum(v for (x, y), v in homol.items() if (x, y) in per_pair)} Homol lines each way, "
          f"imported back {sum(back.values())} tie points; OpenMVG {sum(putative.values())} "
          f"putative matches, {len(feat_files)} .feat files; view graph {n_edges} edges, "
          f"{mst} tree pairs; no device event; walls "
          f"{ {k: round(v, 3) for k, v in walls.items()} } s [{card}]", flush=True)

    # the CLI: --openmvg (no OpenMVG binaries: the project is exported, the
    # reconstruction skipped with a warning) and the view graph on by default
    conf = out / "openmvg.yaml"
    conf.write_text("general:\n  path_to_binaries: null\n")
    cfg = out / "cuda.yaml"
    cfg.write_text("general:\n  tpu:\n    device: cuda\n")
    label = "sift+kornia_matcher --openmvg"
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    feature_path, match_path, _ = run_matching({
        "dir": str(WORK / "stage5" / "demo5"), "outs": str(out / "cli"),
        "pipeline": "sift+kornia_matcher", "strategy": "bruteforce",
        "skip_reconstruction": True, "force": True, "config_file": str(cfg),
        "openmvg": str(conf)})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {label: dict(_lib.LAUNCHES)}
    if not launches[label]["nn"] or not launches[label]["nullspace"]:
        _fail(f"{label}: kernels 5 and 4 of its path were not both launched")
    with hdf5.File(match_path, "r") as m:
        cli_total = sum(len(np.asarray(m[a][b])) for a in m for b in m[a])
    cli_out = feature_path.parent
    putative = _read_putative(cli_out / "openmvg" / "matches" / "matches.putative.bin")
    graph_files = [f for f in ("communities.csv", "mst_pairs.txt", "mst_expanded_pairs.txt",
                               "graph.html") if (cli_out / f).is_file()]
    if sum(putative.values()) != cli_total or len(graph_files) != 4:
        _fail(f"{label}: {sum(putative.values())} putative matches of {cli_total}; view graph "
              f"files {graph_files}")
    print(f"[exports] {label} on demo5: {cli_total} verified matches, the OpenMVG project holds "
          f"{sum(putative.values())}; the view graph's 4 files written; run_matching {wall:.2f} "
          f"s; kernel launches { {k: v for k, v in launches[label].items() if v} } [{card}]",
          flush=True)
    print(f"[exports] phase wall {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return launches


def main() -> None:
    if not PKG.is_dir():
        print("FAIL: the port package is missing next to chip_smoke.py", flush=True)
        sys.exit(2)
    sys.path.insert(0, str(SRC))
    import torch

    card = phase_environment()
    print(f"[env] {card}", flush=True)
    phase_build()
    report = phase_kernels(card)
    phase_reference(card)
    launches = phase_main_path(card)
    launches.update(phase_tiled(card))
    launches.update(phase_reconstruction(card))
    launches.update(phase_retrieval(card))
    upright_launches, report["nn"]["upright_probe"] = phase_upright(card)
    launches.update(upright_launches)
    launches.update(phase_exports(card))
    kernels = [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1],
         "launches": sum(counts[name] for counts in launches.values()),
         "launches_by_path": {path: counts[name] for path, counts in launches.items()
                              if counts[name]},
         **report[name], **({"note": NO_CALLER[name]} if name in NO_CALLER else {})}
        for name in KERNELS
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
