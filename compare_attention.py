"""Kernels of two checkouts of the port, timed on one GPU in turns.

    python3 compare_attention.py OTHER_ROOT [KERNEL ...]

OTHER_ROOT is another checkout of this repository (for example the parent
commit unpacked with ``git archive``). KERNEL names checks of
``chip_smoke.py`` (``attention``, ``ffn``, ``sinkhorn``, ``bidir_attention``,
any key of its kernel phase); the default is the two attention kernels. Each
measurement runs in its own process, in the order other, this, this, other,
and calls each checkout's own ``chip_smoke.py`` check of each kernel with its
package first on the path: the inputs, tolerances and timings of that
checkout's kernel phase (runs of back-to-back calls), the same in both unless
a check changed its inputs with its path. Prints one JSON line per run with
every time the check reports (its keys ending in ``ms``), then the mean of
each checkout's two runs as the last line.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEFAULT = ("attention", "bidir_attention")


def measure(src: str, names: list) -> dict:
    sys.path.insert(0, src)
    sys.path.insert(1, str(Path(src).parent))
    import torch

    import chip_smoke

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = {"src": src, "card": card}
    for name in names:
        err, tol, _, extra = getattr(chip_smoke, f"check_{name}")(torch, dev, card)
        if not err <= tol:
            raise SystemExit(f"{name} from {src} disagrees with its plain version")
        out[name] = {k: v for k, v in extra.items()
                     if k.endswith("ms") and isinstance(v, (int, float))}
        torch.cuda.empty_cache()
    return out


def main() -> None:
    if sys.argv[1:2] == ["--measure"]:
        print(json.dumps(measure(sys.argv[2], sys.argv[3:])), flush=True)
        return
    other = Path(sys.argv[1]).resolve()
    names = sys.argv[2:] or list(DEFAULT)
    runs = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        src = (other if who == "other" else ROOT) / "src"
        res = subprocess.run([sys.executable, __file__, "--measure", str(src), *names],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit(f"{who} failed:\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": who, **line}), flush=True)
        runs[who].append(line)
    # the mean of each checkout's two runs
    summary = {who: {name: {k: sum(r[name][k] for r in rs) / len(rs) for k in rs[0][name]}
                     for name in names} for who, rs in runs.items()}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
