"""The h5 writes of two checkouts of the port, timed on one GPU host in turns.

    python3 compare_h5.py OTHER_ROOT [--views N]

OTHER_ROOT is another checkout of this repository (for example the parent
commit unpacked with ``git archive``). Each run is its own process, five of
each checkout in the order other, this, this, other, other, this, ..., with
that checkout's package first on the path:
``run_matching --pipeline superpoint+lightglue`` (random weights, match
threshold 0, ``bruteforce``, --skip_reconstruction) on ``chip_smoke.py``'s
synthetic views (16 of 1024 x 1024 by default, made once under
``build/compare_h5/``), after one warm-up run. Every call into the
checkout's ``io/hdf5.py`` (``File`` open and close, ``create_dataset``,
``create_group``, ``del``) is timed on the thread that makes it, including
the background feature writer's; a run reports the sum (``h5_s``: the h5
write wall), its calls, the run's wall and stage walls, the three files'
sizes and the process's peak resident memory. Prints one JSON line a run,
then as the last line each checkout's median, least and greatest of its
runs.
"""

from __future__ import annotations

import json
import resource
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "compare_h5"
RUNS = 5  # of each checkout: two runs a tree could not resolve the h5 wall


def measure(src: str, views: int) -> dict:
    sys.path.insert(0, src)
    import logging

    import torch

    from deep_image_matching_tpu_torch.__main__ import run_matching
    from deep_image_matching_tpu_torch.io import hdf5

    spent = {"s": 0.0, "calls": 0}
    lock = threading.Lock()
    depth = threading.local()

    def timed(fn):
        def wrapper(*args, **kwargs):
            outer = getattr(depth, "n", 0) == 0  # nested calls count once
            depth.n = getattr(depth, "n", 0) + 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                depth.n -= 1
                if outer:
                    with lock:
                        spent["s"] += time.perf_counter() - t0
                        spent["calls"] += 1
        return wrapper

    hdf5.File.__init__ = timed(hdf5.File.__init__)
    hdf5.File.close = timed(hdf5.File.close)
    for name in ("create_dataset", "create_group", "__delitem__"):
        setattr(hdf5.Group, name, timed(getattr(hdf5.Group, name)))
    stages = []
    handler = logging.Handler()
    handler.emit = lambda rec: (stages.append(rec.getMessage())
                                if "[Timer]" in rec.getMessage() else None)
    logging.getLogger("dim_tpu_torch").addHandler(handler)
    proj = OUT / f"synthetic{views}"
    cfg = OUT / "threshold0.yaml"
    tag = "other" if Path(src).resolve() != (ROOT / "src").resolve() else "this"
    outs = OUT / f"out_{tag}"
    args = {"dir": str(proj), "outs": str(outs), "pipeline": "superpoint+lightglue",
            "strategy": "bruteforce", "skip_reconstruction": True, "force": True,
            "config_file": str(cfg)}
    run_matching(args)  # warm-up: kernel build, cuDNN plans
    torch.cuda.synchronize()
    spent.update(s=0.0, calls=0)
    t0 = time.perf_counter()
    feature_path, _, _ = run_matching(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = feature_path.parent
    sizes = {p: (out / p).stat().st_size for p in ("features.h5", "raw_matches.h5", "matches.h5")
             if (out / p).exists()}
    return {"h5_s": spent["s"], "h5_calls": spent["calls"], "wall_s": wall,
            "stages": stages[-1].split("] ", 2)[-1] if stages else None, "bytes": sizes,
            "peak_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20}


def main() -> None:
    views = 16
    if "--views" in sys.argv:
        i = sys.argv.index("--views")
        views = int(sys.argv[i + 1])
        del sys.argv[i:i + 2]
    if sys.argv[1:2] == ["--measure"]:
        print(json.dumps(measure(sys.argv[2], views)), flush=True)
        return
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    other = Path(sys.argv[1]).resolve()
    OUT.mkdir(parents=True, exist_ok=True)
    proj = OUT / f"synthetic{views}"
    if not proj.exists():
        chip_smoke._synthetic_project(proj, n=views)
    (OUT / "threshold0.yaml").write_text(
        "general:\n  allow_random_weights: true\n  tpu:\n    device: cuda\n"
        "matcher:\n  filter_threshold: 0.0\n")
    runs = {"other": [], "this": []}
    order = [("other", "this", "this", "other")[i % 4] for i in range(2 * RUNS)]
    for who in order:
        src = (other if who == "other" else ROOT) / "src"
        res = subprocess.run([sys.executable, __file__, "--measure", str(src), "--views",
                              str(views)], capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit(f"{who} failed:\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": who, **line}), flush=True)
        runs[who].append(line)
    keys = ("h5_s", "h5_calls", "wall_s", "peak_rss_gib")
    print(json.dumps({who: {k: {"median": statistics.median(r[k] for r in rs),
                                "min": min(r[k] for r in rs), "max": max(r[k] for r in rs)}
                            for k in keys} for who, rs in runs.items()}), flush=True)


if __name__ == "__main__":
    main()
