"""Device profile of warm ``run_matching`` runs of the port on one GPU.

    python3 profile_paths.py [--paths superpoint+superglue orb+kornia_matcher] [--warm 3]
                             [--dtype float32]

For each ported path: ``--warm`` untraced runs of ``run_matching`` (their
wall times; the first also builds the kernels and loads the libraries), then
one run under ``torch.profiler``, which gives
- the wall time of the profiled run (the profiler's own overhead included);
- device busy: the sum of the device-side events (kernels, copies, memsets);
- the idle share, 1 - busy / wall;
- the peak of allocated device memory;
- the device events that took the most time;
- each hand-written kernel's share of the device time.

Projects are ``chip_smoke.py``'s: 16 synthetic 1024x1024 views with
``bruteforce`` pairs (120) for the SuperPoint paths and for aliked+lightglue
(``chip_smoke.py``'s seeded ALIKED checkpoint, ``tpu.attn_impl: bidir`` and
``DIM_TPU_FUSED_PROLOGUE=1``, set for that path only), the 5 demo images with
``bruteforce`` pairs (10) for SIFT, ORB and RoMa (default settings: 560 /
864 px, 5000 samples per pair, DINOv2 at 2 blocks). Weights are random, and the
learned matchers run with match threshold 0 as in ``chip_smoke.py``, in
``general.tpu.dtype`` ``--dtype`` (bfloat16 by default; float32 runs the
float32 forms of kernels 1, 2, 6 and 10). The card's
name and power limit are printed first; the summary is also written to
``build/profile/profile_<dtype>.json``. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "profile"

BASE = "general:\n  allow_random_weights: true\n  tpu:\n    device: cuda\n"
# path -> (project, extra YAML)
PATHS = {
    "superpoint+lightglue": ("synthetic16", "matcher:\n  filter_threshold: 0.0\n"),
    "superpoint+superglue": ("synthetic16", "matcher:\n  match_threshold: 0.0\n"),
    "superpoint+kornia_matcher": ("synthetic16", ""),
    "sift+kornia_matcher": ("demo5", ""),
    "orb+kornia_matcher": ("demo5", ""),
    "roma": ("demo5", ""),
    "aliked+lightglue": ("synthetic16", "    attn_impl: bidir\nmatcher:\n  filter_threshold: 0.0\n"),
}

# the __global__ functions of csrc/*.cu -> the kernel they belong to; a name
# matches where no letter or underscore precedes it (attention_sm90 is not
# bidir_attention_sm90)
OUR_KERNELS = {
    "attention_sm90": "attention", "ffn_sm90": "ffn",
    "assignment_sm90": "assignment", "tf32_split_kernel": "assignment",
    "combine_cols_kernel": "assignment",
    "nullspace_kernel": "nullspace", "nn_top2_kernel": "nn",
    "sinkhorn_iter_kernel": "sinkhorn", "sinkhorn_cols_kernel": "sinkhorn",
    "lse_rows_kernel": "lse_rows",
    "refiner_block_kernel": "refiner", "bidir_attention_sm90": "bidir_attention", "qkv_sm90": "qkv",
    "attention_f32_sm90": "attention_f32", "ffn_f32_sm90": "ffn_f32",
    "bidir_attention_f32_sm90": "bidir_attention_f32", "qkv_f32_sm90": "qkv_f32",
    # the float32 attention kernels' per-call split of their operands
    "split_rows_kernel": "f32_split", "split_vt_kernel": "f32_split",
}


def _device_ms(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    if us is None:
        us = getattr(event, "self_cuda_time_total", 0)
    return us / 1e3


def profile_path(pipeline: str, project: Path, config: Path, warm: int, top: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deep_image_matching_tpu_torch.__main__ import run_matching

    args = {"dir": str(project), "outs": str(WORK / "out" / pipeline), "pipeline": pipeline,
            "strategy": "bruteforce", "skip_reconstruction": True, "force": True,
            "config_file": str(config)}

    def timed_run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_matching(args)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    walls = [timed_run() for _ in range(warm)]
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = timed_run()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    # device-side events only: a host op's device time repeats its kernels'
    events = [(_device_ms(e), e.count, e.key) for e in prof.key_averages()
              if _device_ms(e) > 0 and str(getattr(e, "device_type", "")).endswith("CUDA")]
    events.sort(reverse=True)
    busy = sum(ms for ms, _, _ in events)
    ours = {}
    for ms, n, key in events:
        for fn, kernel in OUR_KERNELS.items():
            if re.search(rf"(?<![A-Za-z_]){fn}", key):
                ms0, n0 = ours.get(kernel, (0.0, 0))
                ours[kernel] = (ms0 + ms, n0 + n)
    return {
        "pipeline": pipeline, "warm_walls_s": walls, "profiled_wall_ms": wall * 1e3,
        "device_busy_ms": busy, "idle_share": 1.0 - busy / (wall * 1e3),
        "peak_gib": peak_gib,
        "kernels": {k: {"ms": ms, "share": ms / busy, "count": n} for k, (ms, n) in ours.items()},
        "top": [{"ms": ms, "share": ms / busy, "count": n, "name": key}
                for ms, n, key in events[:top]],
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--paths", nargs="+", choices=list(PATHS), default=list(PATHS))
    parser.add_argument("--warm", type=int, default=3, help="untraced runs before the traced one")
    parser.add_argument("--top", type=int, default=14, help="device events to list per path")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                        help="general.tpu.dtype of the learned matchers")
    opts = parser.parse_args()
    base = BASE + (f"    dtype: {opts.dtype}\n" if opts.dtype != "bfloat16" else "")

    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", flush=True)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip()
    print(card, flush=True)

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    projects = {}
    for name in {PATHS[p][0] for p in opts.paths}:
        if name == "synthetic16":
            projects[name] = chip_smoke._synthetic_project(WORK / name)
        else:
            projects[name] = WORK / name
            shutil.copytree(ROOT / "notebooks" / "demo_project" / "images",
                            projects[name] / "images")

    results = []
    for pipeline in opts.paths:
        project, extra = PATHS[pipeline]
        config = WORK / f"{pipeline}.yaml"
        config.write_text(base + extra)
        with chip_smoke._env(chip_smoke._path_env(pipeline)):
            r = profile_path(pipeline, projects[project], config, opts.warm, opts.top)
        results.append(r)
        r["dtype"] = opts.dtype
        print(f"== {pipeline} ({opts.dtype}) on {project}: warm walls "
              f"{', '.join(f'{w:.3f}' for w in r['warm_walls_s'])} s; profiled wall "
              f"{r['profiled_wall_ms']:.1f} ms; device busy {r['device_busy_ms']:.1f} ms; idle "
              f"{100 * r['idle_share']:.1f} %; peak {r['peak_gib']:.2f} GiB [{card}]", flush=True)
        for k, e in r["kernels"].items():
            print(f"   kernel {k}: {e['ms']:.2f} ms, {100 * e['share']:.1f} % of device time, "
                  f"n={e['count']}", flush=True)
        for e in r["top"]:
            print(f"   {e['ms']:9.2f} ms {100 * e['share']:5.1f} % n={e['count']:5d} "
                  f"{e['name'][:110]}", flush=True)
    (WORK / f"profile_{opts.dtype}.json").write_text(
        json.dumps({"card": card, "dtype": opts.dtype, "paths": results}, indent=1))


if __name__ == "__main__":
    main()
