"""Device profile of warm ``run_matching`` runs of the port on one GPU.

    python3 profile_paths.py [--paths superpoint+superglue orb+kornia_matcher] [--warm 3]

For each ported path: ``--warm`` untraced runs of ``run_matching`` (their
wall times; the first also builds the kernels and loads the libraries), then
one run under ``torch.profiler``, which gives
- the wall time of the profiled run (the profiler's own overhead included);
- device busy: the sum of the device-side events (kernels, copies, memsets);
- the idle share, 1 - busy / wall;
- the peak of allocated device memory;
- the device events that took the most time.

Projects are ``chip_smoke.py``'s: 16 synthetic 1024x1024 views with
``bruteforce`` pairs (120) for the SuperPoint paths, the 5 demo images with
``bruteforce`` pairs (10) for SIFT and ORB. Weights are random, and the
learned matchers run with match threshold 0 as in ``chip_smoke.py``. The card's
name and power limit are printed first; the summary is also written to
``build/profile/profile.json``. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
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
    return {
        "pipeline": pipeline, "warm_walls_s": walls, "profiled_wall_ms": wall * 1e3,
        "device_busy_ms": busy, "idle_share": 1.0 - busy / (wall * 1e3),
        "peak_gib": peak_gib,
        "top": [{"ms": ms, "share": ms / busy, "count": n, "name": key}
                for ms, n, key in events[:top]],
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--paths", nargs="+", choices=list(PATHS), default=list(PATHS))
    parser.add_argument("--warm", type=int, default=3, help="untraced runs before the traced one")
    parser.add_argument("--top", type=int, default=14, help="device events to list per path")
    opts = parser.parse_args()

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
        config.write_text(BASE + extra)
        r = profile_path(pipeline, projects[project], config, opts.warm, opts.top)
        results.append(r)
        print(f"== {pipeline} on {project}: warm walls "
              f"{', '.join(f'{w:.3f}' for w in r['warm_walls_s'])} s; profiled wall "
              f"{r['profiled_wall_ms']:.1f} ms; device busy {r['device_busy_ms']:.1f} ms; idle "
              f"{100 * r['idle_share']:.1f} %; peak {r['peak_gib']:.2f} GiB [{card}]", flush=True)
        for e in r["top"]:
            print(f"   {e['ms']:9.2f} ms {100 * e['share']:5.1f} % n={e['count']:5d} "
                  f"{e['name'][:110]}", flush=True)
    (WORK / "profile.json").write_text(json.dumps({"card": card, "paths": results}, indent=1))


if __name__ == "__main__":
    main()
