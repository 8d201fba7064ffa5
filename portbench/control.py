"""The control of a cell's correctness check: the plain reference computed
in the precision below the configuration's (float8 e4m3 products for the
bf16 it states), put in the program's place on the cell's own inputs, and
held to the same extraction and matching numbers as a run.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--precision fp8]

Each seed makes the run's checkpoints and first project and draws images
and pairs as a run draws them; one JSON line a seed. A limit is sound only
where this control fails one of the cell's numbers (PERF.md gives the
readings). Runs on the first CUDA card, or with ``--device cpu`` on the
CPU (the tests, at a small size).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def main(argv=None, spec=None) -> list:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--precision", default="fp8")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    import numpy as np
    import torch

    import run
    from harness import check, traffic as gen, weights

    spec = spec or run.cell_of(a.workload)
    config, traffic = spec["config"], spec["traffic"]
    dev = torch.device("cuda", 0) if a.device == "cuda" else torch.device("cpu")
    rows = []
    for seed in (int(s) for s in a.seeds.split(",")):
        tmp = Path(tempfile.mkdtemp(prefix="portbench-control-"))
        try:
            sds = weights.write(tmp / "weights", weights.models(config), seed, dev)
            project = gen.make_project(tmp / "p0", traffic, seed, 0)
            rng = np.random.default_rng([seed % 2**63, 7, 1])
            numbers = check.control_numbers(project, traffic, config, sds, rng, dev,
                                            a.precision)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        row = {"workload": a.workload, "seed": seed, "precision": a.precision,
               "numbers": numbers,
               "fails": sorted(k for k, v in numbers.items()
                               if k in spec["limits"] and v > spec["limits"][k])}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
