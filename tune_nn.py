"""Kernel 5's column splits, timed on one GPU.

    python3 tune_nn.py [--shapes B,K0,K1,D ...] [--slices N ...]

For each shape (default: ``chip_smoke.check_nn``'s (16, 4096, 4096) at D =
64, 128, 256 and 960, and the upright probe's (4, 512, 512) at 256 and 128)
and each number of column slices (``ops/nn.py::column_slices``' pick, then
``--slices``, default 1 2 4 8 16, those the tiles allow), times the kernel
(and the merge) on TF32 halves split once (and, as ``with_split_ms``, a call
that splits them too at the pick), as ``chip_smoke.py`` times kernels: the median of 10 runs of back-to-back calls between CUDA events,
and where the query blocks do not fill the SMs also the device's own time
of the kernel and the merge under ``torch.profiler`` (``device_ms``). Each
configuration is first held to the plain version (min1 and min2 within 1e-4,
argmins equal on >= 0.999 of the rows and wherever min2 - min1 > 1e-3).
Inputs: unit-norm f32 from seed 0, half the queries with a near copy among
the references. Prints one JSON line per shape, the card's name and power
limit before the last, and the fastest split of each shape last.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = ((16, 4096, 4096, 64), (16, 4096, 4096, 128), (16, 4096, 4096, 256),
          (16, 4096, 4096, 960), (4, 512, 512, 256), (4, 512, 512, 128))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", nargs="*", default=None, help="B,K0,K1,D")
    ap.add_argument("--slices", nargs="*", type=int, default=[1, 2, 4, 8, 16])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tune_nn.py needs a CUDA device")
    import chip_smoke
    from deep_image_matching_tpu_torch.ops import nn as tnn

    shapes = ([tuple(int(v) for v in s.split(",")) for s in args.shapes] if args.shapes
              else SHAPES)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    F = torch.nn.functional
    best = {}
    for B, K0, K1, D in shapes:
        gen = torch.Generator().manual_seed(0)
        d0 = F.normalize(torch.randn(B, K0, D, generator=gen), dim=-1)
        d1 = F.normalize(torch.randn(B, K1, D, generator=gen), dim=-1)
        k = min(K0, K1) // 2
        d1[:, :k] = F.normalize(d0[:, :k] + 0.3 * torch.randn(B, k, D, generator=gen), dim=-1)
        d0, d1 = d0.to(dev), d1.to(dev)
        sq1 = (d1 ** 2).sum(-1)
        ref = tnn.nn_top2_reference(d0, d1, sq1)
        halves = tnn.tf32_halves(d0, d1)
        small = B * -(-K0 // tnn.ROWS) < sms
        auto = tnn.column_slices(B, K0, K1, D, sms)
        row = {"shape": [B, K0, K1, D], "auto": auto,
               "with_split_ms": chip_smoke._time_ms(
                   lambda: tnn.top2_launch(d0, d1, sq1, halves, fill=True)),
               "bound_ms": chip_smoke._nn_bounds(0, B, K0, K1, D)["bound_ms"], "ms": {},
               "device_ms": {}}
        for slices in dict.fromkeys([auto, *args.slices]):
            if slices > -(-K1 // tnn.COLS):
                continue
            got = tnn.top2_launch(d0, d1, sq1, halves, fill=False, slices=slices)
            err = max(float((got[0] - ref[0]).abs().max()), float((got[1] - ref[1]).abs().max()))
            same = got[2] == ref[2]
            if (err > 1e-4 or float(same.float().mean()) < 0.999
                    or not bool(same[(ref[1] - ref[0]) > 1e-3].all())):
                raise SystemExit(f"{slices} slices at {(B, K0, K1, D)} disagree with the plain "
                                 f"version (max err {err:.3e})")

            def run():
                return tnn.top2_launch(d0, d1, sq1, halves, fill=False, slices=slices)

            row["ms"][slices] = chip_smoke._time_ms(run)
            if small:  # the host's dispatch sets the time between events
                row["device_ms"][slices] = chip_smoke._device_ms(
                    run, ("nn_top2_sm90", "nn_merge_kernel"))
        print(json.dumps(row), flush=True)
        best[str((B, K0, K1, D))] = min(row["ms"].items(), key=lambda kv: kv[1])
        del d0, d1, sq1, ref, halves
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    print(json.dumps(best), flush=True)


if __name__ == "__main__":
    main()
