"""Device profile of warm ``run_matching`` runs of the port on one GPU.

    python3 profile_paths.py [--paths superpoint+superglue orb+kornia_matcher] [--warm 3]
                             [--dtype float32] [--src build/parent/src]

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
``DIM_TPU_FUSED_PROLOGUE=1``, set for that path only), 6 views of 6000 x
4000 (``chip_smoke.TILED_SHIFTS``' shifted copies) for the two tiled paths
(``--tiling preselection``, 2048 and 8192 keypoints), the 5 demo images with
``bruteforce`` pairs (10) for SIFT, ORB and RoMa (default settings: 560 /
864 px, 5000 samples per pair, DINOv2 at 2 blocks). Weights are random, and the
learned matchers run with match threshold 0 as in ``chip_smoke.py``, in
``general.tpu.dtype`` ``--dtype`` (bfloat16 by default; float32 runs the
float32 forms of kernels 1, 2, 6 and 10). Two reconstruction rows (stage 5):
``sift+kornia_matcher+reconstruction``, the sift path on the demo images
without ``--skip_reconstruction`` (the mapper's bundle adjustment on the
card), and ``mapper60``, ``native_incremental_mapping`` alone on
``chip_smoke.mapper_scene``'s 60 images (the JAX package's mapper profile
size). disk+lightglue, xfeat+lighterglue and superpoint_open+kornia_matcher
run on the synthetic views as ``chip_smoke.py``'s rows do,
``keynetaffnethardnet+kornia_matcher@learned`` on the demo images with
``chip_smoke.keynet_weights``' seeded KeyNet / AffNet / OriNet,
ripe+kornia_matcher on the synthetic views with
``chip_smoke.dedode_liftfeat_ripe_weights``' seeded checkpoint, loftr and
se2loftr on the synthetic views with ``chip_smoke.loftr_weights``' seeded
checkpoints (match threshold 0), rdd_sparse+lightglue (random RDD and
LightGlue weights, threshold 0) and ``sift+kornia_matcher@alike`` (a YAML
that swaps the extractor for ALIKE, ``chip_smoke.alike_weights``' seeded
alike-n) on the synthetic views. ``--cpu`` also times ``--warm`` runs of
each path with the CPU as its device (walls only), the baseline the card's
walls are read against. ``--src`` takes the port package from another
checkout's ``src`` (e.g. the parent's, unpacked with ``git archive``), so
that two trees are profiled by the same paths in one call. The
card's name and power limit are printed first; the summary is also written
to ``build/profile/profile_<dtype>.json``. Exits non-zero without a CUDA
device.
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

BASE = "general:\n  allow_random_weights: true\n  tpu:\n    device: {device}\n"


def matching(project: str, extra: str = "", tiling: str = "none"):
    """A path of ``run_matching`` on ``project`` with ``extra`` YAML and
    ``--tiling``: a factory (path, project directory, base YAML, device) ->
    one run (with ``+reconstruction`` through stage 5, else with
    --skip_reconstruction). The pipeline is the path's name up to a
    ``+reconstruction`` or an ``@`` suffix."""

    def make(path: str, project_dir: Path, base: str, device: str):
        from deep_image_matching_tpu_torch.__main__ import run_matching

        config = WORK / f"{path}_{device}.yaml"
        config.write_text(base.format(device=device) + extra)
        pipeline = path.partition("@")[0].partition("+reconstruction")[0]
        args = {"dir": str(project_dir), "outs": str(WORK / "out" / f"{path}_{device}"),
                "pipeline": pipeline, "strategy": "bruteforce", "tiling": tiling,
                "skip_reconstruction": "+reconstruction" not in path, "force": True,
                "config_file": str(config)}
        return lambda: run_matching(args)

    return project, make, True


def mapper(path: str, project_dir: Path, base: str, device: str):
    """``native_incremental_mapping`` on ``device`` over
    ``chip_smoke.mapper_scene``'s database, written under the work
    directory once."""
    import chip_smoke
    from deep_image_matching_tpu_torch.sfm.incremental import native_incremental_mapping

    root = WORK / path
    db = root / "database.db"
    if not db.exists():
        chip_smoke.mapper_scene(root)
    return lambda: native_incremental_mapping(db, None, root / device, device=device)


# path -> (project, run factory, whether the profile also records the host's
# events: the mapper's millions of small launches are traced on the device
# side only)
PATHS = {
    "superpoint+lightglue": matching("synthetic16", "matcher:\n  filter_threshold: 0.0\n"),
    "superpoint+superglue": matching("synthetic16", "matcher:\n  match_threshold: 0.0\n"),
    "superpoint+kornia_matcher": matching("synthetic16"),
    "sift+kornia_matcher": matching("demo5"),
    "orb+kornia_matcher": matching("demo5"),
    "roma": matching("demo5"),
    "aliked+lightglue": matching(
        "synthetic16", "    attn_impl: bidir\nmatcher:\n  filter_threshold: 0.0\n"),
    "sift+kornia_matcher+reconstruction": matching("demo5"),
    # --tiling preselection on 6 views of 6000 x 4000 at the default tiles
    # (6 an image), at the preset's 2048 keypoints and at 8192
    "superpoint+lightglue@tiled2048": matching(
        "tiled24mp", "matcher:\n  filter_threshold: 0.0\n", "preselection"),
    "superpoint+lightglue@tiled8192": matching(
        "tiled24mp", "matcher:\n  filter_threshold: 0.0\nextractor:\n  max_keypoints: 8192\n",
        "preselection"),
    "mapper60": ("60 synthetic views", mapper, False),
    # DISK, XFeat and the open SuperPoint at their chip_smoke rows'
    # settings, the seeded KeyNet / AffNet / OriNet on the demo images, and
    # the LoFTR family with its seeded checkpoints (``PATH_WEIGHTS``)
    "disk+lightglue": matching("synthetic16", "matcher:\n  filter_threshold: 0.0\n"),
    "xfeat+lighterglue": matching("synthetic16", "matcher:\n  filter_threshold: 0.0\n"),
    "superpoint_open+kornia_matcher": matching("synthetic16"),
    "keynetaffnethardnet+kornia_matcher@learned": matching("demo5"),
    # RIPE with chip_smoke.py's seeded checkpoint: kernel 5 at D = 960
    "ripe+kornia_matcher": matching("synthetic16"),
    "loftr": matching("synthetic16", "matcher:\n  match_threshold: 0.0\n"),
    "se2loftr": matching("synthetic16", "matcher:\n  match_threshold: 0.0\n"),
    # RDD (full f32, 4096 keypoints) with LightGlue at K = 4096; ALIKE
    # (alike-n, 8192 keypoints) through sift+kornia_matcher's YAML
    "rdd_sparse+lightglue": matching("synthetic16", "matcher:\n  filter_threshold: 0.0\n"),
    "sift+kornia_matcher@alike": matching("synthetic16", "extractor:\n  name: alike\n"),
}
# paths that read seeded checkpoints: path -> ``chip_smoke.WEIGHT_SETS`` key
PATH_WEIGHTS = {"keynetaffnethardnet+kornia_matcher@learned": "keynet_weights",
                "ripe+kornia_matcher": "dedode_liftfeat_ripe_weights",
                "loftr": "loftr_weights", "se2loftr": "loftr_weights",
                "sift+kornia_matcher@alike": "alike_weights"}

# the __global__ functions of csrc/*.cu -> the kernel they belong to; a name
# matches where no letter or underscore precedes it (attention_sm90 is not
# bidir_attention_sm90)
OUR_KERNELS = {
    "attention_sm90": "attention", "ffn_sm90": "ffn",
    "assignment_sm90": "assignment", "tf32_split_kernel": "assignment",
    "combine_cols_kernel": "assignment",
    "nullspace_kernel": "nullspace", "nn_top2_sm90": "nn", "nn_split_kernel": "nn",
    "nn_merge_kernel": "nn",
    "sinkhorn_iter_kernel": "sinkhorn", "sinkhorn_cols_kernel": "sinkhorn",
    "lse_rows_kernel": "lse_rows",
    "refiner_block_kernel": "refiner", "bidir_attention_sm90": "bidir_attention", "qkv_sm90": "qkv",
    "attention_f32_sm90": "attention_f32", "ffn_f32_sm90": "ffn_f32",
    "bidir_attention_f32_sm90": "bidir_attention_f32", "qkv_f32_sm90": "qkv_f32",
    # the float32 attention kernels' split pass of older checkouts (for --src)
    "split_rows_kernel": "f32_split", "split_vt_kernel": "f32_split",
    # kernel 5's earlier f32 FMA kernel, for --src of older checkouts
    "nn_top2_kernel": "nn",
}


def timed(run) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_path(pipeline: str, run, warm: int, top: int, host_events: bool) -> dict:
    """``warm`` timed runs of ``run``, then one under ``torch.profiler``
    (with the host's events too where ``host_events``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    walls = [timed(run) for _ in range(warm)]
    torch.cuda.reset_peak_memory_stats()
    activities = [ProfilerActivity.CPU] if host_events else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        wall = timed(run)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    # device-side events only: a host op's device time repeats its kernels'
    busy, n_events, events = chip_smoke._device_busy(prof)
    if busy is None:
        raise RuntimeError(f"{pipeline}: the profiler recorded no device event")
    ours = {}
    for ms, n, key in events:
        for fn, kernel in OUR_KERNELS.items():
            if re.search(rf"(?<![A-Za-z_]){fn}", key):
                ms0, n0 = ours.get(kernel, (0.0, 0))
                ours[kernel] = (ms0 + ms, n0 + n)
    return {
        "pipeline": pipeline, "warm_walls_s": walls, "profiled_wall_ms": wall * 1e3,
        "device_busy_ms": busy, "device_events": n_events,
        "idle_share": 1.0 - busy / (wall * 1e3),
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
    parser.add_argument("--cpu", action="store_true",
                        help="also time --warm runs of each path on the CPU (walls only)")
    parser.add_argument("--src", default=str(ROOT / "src"),
                        help="the directory that holds the port package (another checkout's "
                             "src times that tree with this script's paths)")
    opts = parser.parse_args()
    base = BASE + (f"    dtype: {opts.dtype}\n" if opts.dtype != "bfloat16" else "")

    sys.path.insert(0, str(Path(opts.src).resolve()))
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", flush=True)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    print(f"port package from {opts.src}", flush=True)

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    projects = {}
    for name in {PATHS[p][0] for p in opts.paths}:
        if name == "synthetic16":
            projects[name] = chip_smoke._synthetic_project(WORK / name)
        elif name == "tiled24mp":
            projects[name] = chip_smoke._synthetic_project(
                WORK / name, n=6, size=(6000, 4000), shifts=chip_smoke.TILED_SHIFTS)
        elif name == "demo5":
            projects[name] = WORK / name
            shutil.copytree(ROOT / "notebooks" / "demo_project" / "images",
                            projects[name] / "images")

    results = []
    for pipeline in opts.paths:
        project, make, host_events = PATHS[pipeline]
        env = chip_smoke._path_env(pipeline)
        if pipeline in PATH_WEIGHTS:
            chip_smoke._reload_keynet_stages()
            env = chip_smoke._weights_env(PATH_WEIGHTS[pipeline])
        with chip_smoke._env(env):
            r = profile_path(pipeline, make(pipeline, projects.get(project), base, "cuda"),
                             opts.warm, opts.top, host_events)
            if opts.cpu:
                cpu_run = make(pipeline, projects.get(project), base, "cpu")
                r["cpu_walls_s"] = [timed(cpu_run) for _ in range(max(1, opts.warm))]
        results.append(r)
        r["dtype"] = opts.dtype
        print(f"== {pipeline} ({opts.dtype}) on {project}: warm walls "
              f"{', '.join(f'{w:.3f}' for w in r['warm_walls_s'])} s; profiled wall "
              f"{r['profiled_wall_ms']:.1f} ms; device busy {r['device_busy_ms']:.1f} ms in "
              f"{r['device_events']} device events; idle "
              f"{100 * r['idle_share']:.1f} %; peak {r['peak_gib']:.2f} GiB [{card}]", flush=True)
        if opts.cpu:
            print(f"   on the CPU: walls {', '.join(f'{w:.3f}' for w in r['cpu_walls_s'])} s",
                  flush=True)
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
