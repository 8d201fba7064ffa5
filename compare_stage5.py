"""Stage 5 alone over an existing COLMAP database, with either package's mapper.

    python3 compare_stage5.py DATABASE [--package torch|jax] [--device cuda|cpu]
                              [--dtype float32|float64] [--shuffle SEED ...]

Runs ``native_incremental_mapping`` over ``DATABASE`` once per entry of
``--shuffle`` and prints, for each run, the initial pair, the registrations
with their PnP inliers, the registered images, the point count and the wall.
A shuffle seed permutes the observations of every bundle-adjustment problem
before the solve ("none": the mapper's own order), which changes the order
in which BA sums and nothing else, so the spread of the results over seeds
is the mapper's sensitivity to BA's rounding.

``--package torch`` (the default) runs the port with BA on ``--device`` in
``--dtype``; ``--package jax`` runs the JAX package on the CPU, in float32
(the two packages are never imported together). Models are written under
``build/compare_stage5/``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


class _Log(logging.Handler):
    """Prints the mapper's initialisation and registration messages."""

    def emit(self, rec):
        msg = rec.getMessage()
        if msg.startswith(("Initialized from pair", "Registered ")):
            print(f"   {msg}", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("database", type=Path)
    parser.add_argument("--package", choices=("torch", "jax"), default="torch")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    parser.add_argument("--shuffle", nargs="+", default=["none"],
                        help="seeds of the observations' permutation, or none")
    opts = parser.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    if opts.package == "jax":
        if opts.dtype != "float32" or opts.device != "cpu":
            parser.error("--package jax runs on the CPU in float32")
        os.environ["JAX_PLATFORMS"] = "cpu"
        from deep_image_matching_tpu.sfm import incremental as inc

        logger, extra = "dim_tpu", {}
    else:
        from deep_image_matching_tpu_torch.sfm import incremental as inc

        logger, extra = "dim_tpu_torch", {"device": opts.device}
    log = logging.getLogger(logger)
    log.setLevel(logging.INFO)
    log.addHandler(_Log())
    dtype = np.dtype(opts.dtype).type
    solve = inc.bundle_adjust

    def ba(poses, intr, points, obs_pose, obs_cam, obs_pt, obs_uv, *args, seed=None, **kw):
        if seed is not None:
            p = np.random.default_rng(seed).permutation(len(obs_pose))
            obs_pose, obs_cam, obs_pt = obs_pose[p], obs_cam[p], obs_pt[p]
            obs_uv = np.asarray(obs_uv)[p]
        return solve(poses, intr, points, obs_pose, obs_cam, obs_pt, obs_uv, *args,
                     dtype=dtype, **kw)

    for s in opts.shuffle:
        seed = None if s == "none" else int(s)
        inc.bundle_adjust = lambda *a, **kw: ba(*a, seed=seed, **kw)
        label = f"{opts.package} {opts.device} {opts.dtype} shuffle {s}"
        print(f"== {label}", flush=True)
        out = ROOT / "build" / "compare_stage5" / label.replace(" ", "_")
        t0 = time.perf_counter()
        res = inc.native_incremental_mapping(opts.database, None, out, **extra)
        wall = time.perf_counter() - t0
        if res is None:
            print(f"   no model; {wall:.2f} s", flush=True)
            continue
        names = sorted(im.name for im in res[1].values())
        print(f"   {len(names)} registered {names}, {len(res[2])} points; {wall:.2f} s",
              flush=True)
    inc.bundle_adjust = solve


if __name__ == "__main__":
    main()
