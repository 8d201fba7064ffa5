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
each checkout's two runs as the last line. Each run also writes kernel 1's
outputs at head dim 64 (bf16 and f32, three shapes, partial masks, from one
seed) under ``build/compare_attention/``, and a line before the last says
whether the two checkouts' outputs are equal bit for bit.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEFAULT = ("attention", "bidir_attention")


OUT = ROOT / "build" / "compare_attention"
# (B, H, Nq, Nk): LightGlue's, DINOv2's and a ragged one
OUTPUT_SHAPES = ((16, 4, 2048, 2048), (2, 16, 1601, 1601), (3, 4, 300, 131))


def _out_path(src: str) -> Path:
    return OUT / f"{hashlib.sha1(src.encode()).hexdigest()[:12]}.pt"


def attention_outputs(torch, path: Path) -> None:
    """Kernel 1's head-dim-64 outputs on seeded inputs with partial masks,
    both forms, saved to ``path``."""
    from deep_image_matching_tpu_torch.ops.attention import fused_attention

    gen = torch.Generator().manual_seed(5)
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        for B, H, N, M in OUTPUT_SHAPES:
            q, k, v = (torch.randn(B, H, n, 64, generator=gen).to("cuda", dt) for n in (N, M, M))
            qm, km = ((torch.arange(n)[None] < torch.randint(n // 2, n + 1, (B,), generator=gen)
                       [:, None]).cuda() for n in (N, M))
            out[f"{dt} {B} {H} {N} {M}"] = fused_attention(q, k, v, qm, km, 0.125).cpu()
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(out, path)


def measure(src: str, names: list) -> dict:
    sys.path.insert(0, src)
    sys.path.insert(1, str(Path(src).parent))
    import torch

    import chip_smoke

    attention_outputs(torch, _out_path(src))

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
    import torch

    a, b = (torch.load(_out_path(str(r / "src"))) for r in (other, ROOT))
    same = all(torch.equal(a[k], b[k]) for k in a)
    print(f"kernel 1 at head dim 64, bf16 and f32, {len(a)} cases: the two checkouts' outputs "
          f"{'are equal bit for bit' if same else 'DIFFER'}", flush=True)
    # the mean of each checkout's two runs
    summary = {who: {name: {k: sum(r[name][k] for r in rs) / len(rs) for k in rs[0][name]}
                     for name in names} for who, rs in runs.items()}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
