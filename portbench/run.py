"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (``portbench/configs/<config>.json``)
and a traffic mix (``portbench/traffic/<traffic>.json``). Set-up
(``setup_s``): import the port, open the cards, write seeded checkpoints
where the port's loaders find them, write a pool of image projects, run one
warm-up job at the cell's shapes. The window: jobs of the port's CLI entry
``run_matching`` back to back, each on the pool's next project with a fresh
output directory, until ``--seconds`` have passed at the start of a job;
its time is the sum of the jobs' walls.
Then one job is drawn from the seed and what it wrote is judged against the
plain reference (``harness/check.py``), each number against its limit in
``portbench/limits/<cell>.json``. The last line of standard output is the
result as JSON; the numbers compared are the last lines of standard error.
With ``--trace 1`` the window runs under ``torch.profiler`` with spans and
call records, and the line carries the per-layer metrics instead of the
end-to-end ones. Everything the run writes goes under ``$TMPDIR`` and is
removed at its end; the port's kernel library is built once into the
checkout's ``build/torch_kernels/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
CHECKOUT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "deep_image_matching_tpu")
PROGRAM_ENV = ("DIM_TPU_PROFILE", "DIM_TPU_FUSED_PROLOGUE", "DIM_TPU_ALLOW_RANDOM_WEIGHTS",
               "DIM_TPU_WEIGHTS_DIR")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cell_of(name: str) -> dict:
    """The cell's entry, its configuration and traffic files, its limits
    and the metrics it reports, all found by name."""
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    config = json.loads((BENCH / "configs" / f"{cell['config']}.json").read_text())
    from harness.traffic import load

    def applies(m):
        return name in m.get("workloads", [name])

    return {"cell": cell, "config": config, "traffic": load(cell["traffic"]),
            "limits": json.loads((BENCH / "limits" / f"{name}.json").read_text()),
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def yaml_text(config: dict, traffic: dict, device: str) -> str:
    """The cell's YAML for the port: the configuration's extractor and
    matcher options over the preset, the traffic's keypoint budget and mesh,
    no random weights (a missing checkpoint fails the job)."""
    import yaml

    mesh = traffic.get("mesh_devices") if device == "cuda" else None
    tpu = {**config["general"]["tpu"], "device": device, "mesh_devices": mesh}
    general = {k: v for k, v in config["general"].items() if k != "tpu"}
    doc = {"general": {**general, "allow_random_weights": False, "tpu": tpu},
           "extractor": {**config["extractor"], "max_keypoints": traffic["max_keypoints"]},
           "matcher": dict(config["matcher"])}
    return yaml.safe_dump(doc, sort_keys=False)


def job_args(config: dict, traffic: dict, yaml_path: Path):
    def args_of(job) -> dict:
        a = {"dir": str(job.project["dir"]), "outs": str(job.out_dir),
             "pipeline": config["pipeline"], "strategy": traffic["strategy"],
             "config_file": str(yaml_path), "quality": "high", "tiling": "none",
             "skip_reconstruction": True, "graph": False, "force": True}
        if traffic.get("overlap") is not None:
            a["overlap"] = int(traffic["overlap"])
        return a
    return args_of


def run(argv=None, device: str = "cuda", spec: dict = None) -> int:
    """One run; returns the exit code. ``device`` and ``spec`` (a cell as
    ``cell_of`` gives it) are for the CPU tests, which drive a run at a
    small size without a card."""
    args = parse(argv)
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    spec = spec or cell_of(args.workload)
    cell, config, traffic = spec["cell"], spec["config"], spec["traffic"]
    for k in PROGRAM_ENV:
        os.environ.pop(k, None)
    os.environ.setdefault("TRITON_CACHE_DIR", str(CHECKOUT / "build" / "triton_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CHECKOUT / "build" / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"

    import numpy as np
    import torch

    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: the cell needs {cell['chips']} CUDA card(s); {n} visible",
                  file=sys.stderr)
            return 2
    if str(CHECKOUT / "src") not in sys.path:
        sys.path.insert(0, str(CHECKOUT / "src"))
    import deep_image_matching_tpu_torch  # noqa: F401

    from harness import check, layers, plugins, trace, traffic as gen, weights, window

    n_cards = int(cell["chips"]) if device == "cuda" else 1
    dev0 = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    scratch = Path(tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR")))
    try:
        os.environ["DIM_TPU_WEIGHTS_DIR"] = str(scratch / "weights")
        sds = weights.write(scratch / "weights", weights.models(config), args.seed, dev0)
        projects = [gen.make_project(scratch / "projects" / f"p{i}", traffic, args.seed, i)
                    for i in range(int(traffic["pool"]))]
        yaml_path = scratch / "cell.yaml"
        yaml_path.write_text(yaml_text(config, traffic, device))
        args_of = job_args(config, traffic, yaml_path)
        warm = window.run_jobs(args_of, projects[:1], scratch / "warm", 0.0)
        if warm[0].error:
            print(warm[0].error, file=sys.stderr)
            return 3
        shutil.rmtree(scratch / "warm", ignore_errors=True)
        cards = [torch.device("cuda", i) for i in range(n_cards)] if device == "cuda" else []
        for d in cards:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
        setup_s = time.perf_counter() - T_START

        from deep_image_matching_tpu_torch.ops import _lib

        launches0 = sum(_lib.LAUNCHES.values())
        rec = prof = None
        if args.trace:
            rec = window.Recorder()
            window.install_spans(rec)
            for name in plugins.kernel_names():
                k = plugins.kernel(name)
                rec.record(name, *k.WRAPS, k.note)
            if cards:
                prof, offset_probe = _start_profiler(torch, cards)
        rng = np.random.default_rng([int(args.seed) % 2**63, 7])
        counts = {}
        pick = window.Reservoir(rng, (lambda j: counts.update({j.index: _keypoints(j)}))
                                if args.trace else None)
        w0 = time.time_ns()
        jobs = window.run_jobs(args_of, projects, scratch / "out", args.seconds, rec, pick)
        for d in cards:
            torch.cuda.synchronize(d)
        w1 = time.time_ns()
        # the window's time is its jobs' walls: the harness's work between two
        # jobs (removing one's files, in traced runs reading its keypoints) is
        # not the program's
        window_s = sum(j.seconds for j in jobs)
        spans = [(j.start_ns, j.end_ns) for j in jobs]
        peak = max((torch.cuda.max_memory_allocated(d) for d in cards), default=0)
        launches = sum(_lib.LAUNCHES.values()) - launches0
        dtrace, shift = None, 0
        if rec is not None:
            rec.close()
            dtrace = trace.DeviceTrace()
        if prof is not None:
            prof.stop()
            dtrace = trace.from_profiler(prof)
            shift = _clock_offset(dtrace, offset_probe)
            dtrace.events = [(d, n, a - shift, b - shift) for d, n, a, b in dtrace.events]
            dtrace = dtrace.window(w0, w1)
            del prof

        pairs_of = {id(p): gen.expected_pairs(p["images"], traffic) for p in projects}
        attempted = sum(len(pairs_of[id(j.project)]) for j in jobs)
        failed = sum(len(pairs_of[id(j.project)]) for j in jobs if j.error)
        for j in jobs:
            if j.error:
                print(f"job {j.index} raised:\n{j.error}", file=sys.stderr)

        print(f"portbench: setup_s {setup_s:.3f} window_s {window_s:.3f} jobs {len(jobs)} "
              f"pairs {attempted} failed {failed} peak_bytes {peak}", file=sys.stderr)
        drawn = pick.kept
        model = None
        if args.trace:
            model = _model_least_s(plugins, config, traffic, jobs, pairs_of, counts)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        numbers = {}
        if not drawn.error:
            numbers = check.check_job(drawn.out_dir, drawn.project, traffic, config, sds,
                                      rng, dev0)
        print("portbench: readings " + json.dumps(numbers), file=sys.stderr)
        limits = spec["limits"]
        checks = {k: {"value": numbers.get(k, float("inf")), "limit": limits[k]}
                  for k in limits}
        correct = (not failed and bool(numbers)
                   and all(c["value"] <= c["limit"] for c in checks.values()))

        bad = forbidden_modules()
        if bad:
            print(f"portbench: modules of {', '.join(bad)} are loaded in this process",
                  file=sys.stderr)
            return 4

        done = attempted - failed
        metrics = {}
        device_info = {"platform": "gpu" if device == "cuda" else device,
                       "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
                       "count": n_cards, "memory_peak_bytes": int(peak)}
        if not args.trace:
            values = {"pairs_per_s": done / window_s, "peak_device_gib": peak / 2**30,
                      "setup_s": setup_s}
            for m in spec["end_to_end"]:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        else:
            busy = {d: ns / 1e9 for d, ns in dtrace.busy_ns(spans).items()}
            ctx = layers.Context(
                config=config, window_s=window_s, n_cards=n_cards,
                n_images=sum(len(j.project["images"]) for j in jobs if not j.error),
                n_pairs=done, spans=rec.spans, calls=rec.calls, launches=launches,
                trace=dtrace, busy_s=busy, model_least_s=model)
            for m in spec["per_layer"]:
                v = plugins.metric(m["name"]).read(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            device_info["busy_s"] = sum(busy.values()) / n_cards
            device_info["window_s"] = sum(b - a for a, b in spans) / 1e9
        result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
                  "metrics": metrics, "device": device_info}
        if args.trace:
            result["breakdown"] = {"device_ops": dtrace.top_ops(10),
                                   "idle_gaps": dtrace.idle_gaps(spans, rec.spans, 10)}
            result["window_check"] = {**_window_check(jobs, rec.spans), "clock_offset_ns": shift,
                                      "calls": {k: len(v) for k, v in rec.calls.items()}}
        result["jobs"] = [j.seconds for j in jobs]
        result["checks"] = checks
        for k, c in checks.items():
            print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
        print(json.dumps(result))
        return 0
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def _start_profiler(torch, cards):
    """A device-activity profiler, started, and a marker kernel launched at
    a known host time (for the clock offset between the two)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    torch.cuda.synchronize(cards[0])
    probe = time.time_ns()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize(cards[0])
    return prof, probe


def _clock_offset(dtrace, probe) -> int:
    """Device-trace time minus host time: the start of the marker kernel
    less the host time just before its launch (0 where it is not found)."""
    spins = [a for _, n, a, _ in dtrace.events if "spin" in n.lower()]
    if not spins:
        return 0
    return min(spins, key=lambda a: abs(a - probe)) - probe


def _keypoints(job) -> dict:
    """Keypoints per image in a job's features.h5 (the dataset headers only)."""
    from harness import h5read

    with h5read.File(job.out_dir / "features.h5", "r") as fd:
        return {name: int(fd[name]["keypoints"].shape[0]) for name in fd}


def _model_least_s(plugins, config, traffic, jobs, pairs_of, counts) -> float:
    """The least seconds of the window's model FLOPs: each finished job's
    images at the traffic's size and its pairs at the keypoints its
    features.h5 held."""
    flops = plugins.flops(config["name"])
    w, h = traffic["size"]
    total = 0.0
    for j in jobs:
        if j.error:
            continue
        n = counts[j.index]
        total += flops.least_seconds([(h, w)] * len(n),
                                     [(n[a], n[b]) for a, b in pairs_of[id(j.project)]], config)
    return total


def _window_check(jobs, spans) -> dict:
    """Job walls against the spans inside them: the residue is pair
    generation, the configuration's set-up and save, and the matcher's
    construction."""
    total = sum(b - a for n, a, b in spans if n == "job") / 1e9
    staged = sum(b - a for n, a, b in spans
                 if n in ("extract_features", "match_pairs", "export_to_colmap")) / 1e9
    return {"jobs_s": total, "spans_s": staged, "residue_s": total - staged}


if __name__ == "__main__":
    sys.exit(run())
