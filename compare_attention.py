"""Kernels 1 and 6 of two checkouts of the port, timed on one GPU in turns.

    python3 compare_attention.py OTHER_ROOT

OTHER_ROOT is another checkout of this repository (for example the parent
commit unpacked with ``git archive``). Each measurement runs in its own
process, in the order other, this, this, other, and calls ``chip_smoke.py``'s
``check_attention`` and ``check_bidir_attention`` with that checkout's
package first on the path: the same inputs, tolerances and timings as the
kernel phase of ``chip_smoke.py`` (runs of back-to-back calls).
Prints one JSON line per run, then the mean of each checkout's two runs as
the last line.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KEYS = ("ms", "library_ms")
SHAPES = {"attention": ("", "superglue_", "dinov2_"), "bidir_attention": ("", "aliked_")}


def measure(src: str) -> dict:
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = {"src": src, "card": card}
    for name, fn in (("attention", chip_smoke.check_attention),
                     ("bidir_attention", chip_smoke.check_bidir_attention)):
        err, tol, _, extra = fn(torch, dev, card)
        if not err <= tol:
            raise SystemExit(f"{name} from {src} disagrees with its plain version")
        out[name] = {p + k: extra[p + k] for p in SHAPES[name] for k in KEYS}
    return out


def main() -> None:
    if sys.argv[1:2] == ["--measure"]:
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return
    other = Path(sys.argv[1]).resolve()
    runs = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        src = (other if who == "other" else ROOT) / "src"
        res = subprocess.run([sys.executable, __file__, "--measure", str(src)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit(f"{who} failed:\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": who, **line}), flush=True)
        runs[who].append(line)
    # the mean of each checkout's two runs
    summary = {who: {name: {k: sum(r[name][k] for r in rs) / len(rs) for k in rs[0][name]}
                     for name in SHAPES} for who, rs in runs.items()}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
