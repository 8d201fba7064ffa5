"""Kernels of two checkouts of the port, timed on one GPU in turns.

    python3 compare_attention.py OTHER_ROOT [KERNEL ...]

OTHER_ROOT is another checkout of this repository (for example the parent
commit unpacked with ``git archive``). KERNEL names checks of
``chip_smoke.py`` (``attention``, ``ffn``, ``sinkhorn``, ``bidir_attention``,
any key of its kernel phase, or ``nn_probe``: kernel 5 at the upright
probe's shapes); the default is the two attention kernels. Each
measurement runs in its own process, in the order other, this, this, other,
and calls each checkout's own ``chip_smoke.py`` check of each kernel with its
package first on the path: the inputs, tolerances and timings of that
checkout's kernel phase (runs of back-to-back calls), the same in both unless
a check changed its inputs with its path. Prints one JSON line per run with
every time the check reports (its keys ending in ``ms``, those of nested
reports as ``outer.inner``, e.g. kernel 5's ``widths.960.ms``), then the mean of
each checkout's two runs as the last line. Each run also writes, from one
seed with partial masks, the head-dim-64 outputs of kernel 1 (three shapes)
and of kernel 6 (two shapes), both in bf16 and f32, and kernel 1's
head-dim-96 outputs (two shapes, bf16 and f32) under
``build/compare_attention/``. Lines before the last say whether the two
checkouts' head-dim-64 outputs are equal bit for bit, in bf16 and in f32
apart (kernels 1 and 6 share the attention cores, so a change to a core
shows there), and the largest
difference of their head-dim-96 outputs over valid rows, absolute in bf16
and relative to max|out| in f32 (those are not expected to be bit-equal
across a change of the head-dim-96 kernel). The same file holds the outputs
of kernel 2 (both modes) and kernel 10 (both modes) on seeded inputs with
ragged row counts, in bf16 and f32, and a line says whether the two
checkouts' outputs of each form are equal bit for bit.
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
# kernel 1, (B, H, Nq, Nk): LightGlue's, DINOv2's and a ragged one
OUTPUT_SHAPES = ((16, 4, 2048, 2048), (2, 16, 1601, 1601), (3, 4, 300, 131))
# kernel 6, (B, H, M, N): LightGlue's and a ragged one
BIDIR_SHAPES = ((16, 4, 2048, 2048), (3, 4, 300, 131))
# kernel 1 at head dim 96, (B, H, Nq, Nk): LighterGlue's and a ragged one
HD96_SHAPES = ((16, 1, 4096, 4096), (3, 1, 300, 131))


# kernel 2, (B, K) in both modes; kernel 10, (B, N) in self and cross mode:
# ragged against the row tiles, and a LightGlue-sized batch
FFN_SHAPES = ((2, 1000), (16, 2048))
QKV_SHAPES = ((3, 700), (16, 2048))


def _out_path(src: str) -> Path:
    return OUT / f"{hashlib.sha1(src.encode()).hexdigest()[:12]}.pt"


def attention_outputs(torch, path: Path) -> None:
    """Kernels 1 and 6 on seeded inputs with partial masks, both forms, at
    head dim 64 (and kernel 1 at 96), saved to ``path`` as
    {case: (output, valid query rows (B, Nq))}."""
    from deep_image_matching_tpu_torch.ops.attention import fused_attention
    from deep_image_matching_tpu_torch.ops.bidir_attention import bidir_cross_attention

    gen = torch.Generator().manual_seed(5)

    def masks(B, *ns):
        return [(torch.arange(n)[None] < torch.randint(n // 2, n + 1, (B,), generator=gen)
                 [:, None]).cuda() for n in ns]

    out = {}
    for dt in (torch.bfloat16, torch.float32):
        for d, shapes in ((64, OUTPUT_SHAPES), (96, HD96_SHAPES)):
            for B, H, N, M in shapes:
                q, k, v = (torch.randn(B, H, n, d, generator=gen).to("cuda", dt)
                           for n in (N, M, M))
                qm, km = masks(B, N, M)
                key = f"{dt} {B} {H} {N} {M}" + (" hd96" if d == 96 else "")
                out[key] = (fused_attention(q, k, v, qm, km, d ** -0.5).cpu(), qm.cpu())
        for B, H, M, N in BIDIR_SHAPES:
            qk0, v0 = (torch.randn(B, H, M, 64, generator=gen).to("cuda", dt) for _ in range(2))
            qk1, v1 = (torch.randn(B, H, N, 64, generator=gen).to("cuda", dt) for _ in range(2))
            m0, m1 = masks(B, M, N)
            o0, o1 = bidir_cross_attention(qk0, qk1, v0, v1, m0, m1)
            out[f"{dt} bidir {B} {H} {M} {N}"] = (torch.cat([o0.flatten(), o1.flatten()]).cpu(),
                                                 None)
    out.update(projection_outputs(torch))
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(out, path)


def projection_outputs(torch) -> dict:
    """Kernels 2 and 10 on seeded inputs, both forms and both modes of each:
    {"proj <dtype> <kernel> ...": (output, None)}."""
    from deep_image_matching_tpu_torch.ops.ffn import ffn_fused
    from deep_image_matching_tpu_torch.ops.qkv import proj_rotary_fused

    gen = torch.Generator().manual_seed(6)
    D, out = 256, {}
    for dt in (torch.bfloat16, torch.float32):
        def rnd(*shape, s=1.0, mean=0.0):
            return (mean + s * torch.randn(*shape, generator=gen)).to("cuda", dt)

        w = (rnd(2 * D, 2 * D, s=(2 * D) ** -0.5), rnd(2 * D, s=0.1), rnd(2 * D, s=0.1, mean=1.0),
             rnd(2 * D, s=0.1), rnd(D, 2 * D, s=(2 * D) ** -0.5), rnd(D, s=0.1))
        for B, K in FFN_SHAPES:
            x, msg = rnd(B, K, D), rnd(B, K, D)
            for mode in ("ln_gelu", "relu"):
                out[f"proj {dt} ffn {mode} {B} {K}"] = (ffn_fused(x, msg, *w, mode=mode).cpu(),
                                                       None)
        for B, N in QKV_SHAPES:
            x = rnd(B, N, D)
            ang = torch.rand(B, N, 32, generator=gen) * 6.3
            cos = torch.repeat_interleave(torch.cos(ang), 2, -1).cuda()
            sin = torch.repeat_interleave(torch.sin(ang), 2, -1).cuda()
            for sections, rot in ((3, (0, 1)), (2, ())):
                wq, bq = rnd(sections * D, D, s=1 / 16), rnd(sections * D, s=0.1)
                outs = proj_rotary_fused(x, wq, bq, cos, sin, 4, sections, rot)
                out[f"proj {dt} qkv {sections} {B} {N}"] = (
                    torch.cat([o.flatten() for o in outs]).cpu(), None)
    return out


def _hd96_difference(torch, a, b):
    """The largest difference of two head-dim-96 outputs over valid rows:
    absolute in bf16, relative to max|out| in f32."""
    (x, rows), (y, _) = a, b
    rows = rows[:, None, :, None].expand_as(x)
    x, y = x.float()[rows], y.float()[rows]
    diff = (x - y).abs().max().item()
    return diff if a[0].dtype == torch.bfloat16 else diff / x.abs().max().item()


def _times(report: dict, prefix: str = "") -> dict:
    """The times of a check's report (keys ending in ``ms``), nested reports
    flattened as ``outer.inner``."""
    out = {}
    for k, v in report.items():
        if isinstance(v, dict):
            out.update(_times(v, f"{prefix}{k}."))
        elif str(k).endswith("ms") and isinstance(v, (int, float)):
            out[f"{prefix}{k}"] = v
    return out


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
        if name == "nn_probe":  # fails the run itself on a disagreement
            out[name] = _times(chip_smoke._probe_kernel_check(card))
            continue
        err, tol, _, extra = getattr(chip_smoke, f"check_{name}")(torch, dev, card)
        if not err <= tol:
            raise SystemExit(f"{name} from {src} disagrees with its plain version")
        out[name] = _times(extra)
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
    for dt in ("bfloat16", "float32"):
        for kernel in ("ffn", "qkv"):
            keys = [k for k in a if k.startswith(f"proj torch.{dt} {kernel} ")]
            same = all(torch.equal(a[k][0], b[k][0]) for k in keys)
            print(f"kernel {2 if kernel == 'ffn' else 10} ({kernel}) in {dt}, {len(keys)} cases: "
                  f"the two checkouts' outputs {'are equal bit for bit' if same else 'DIFFER'}",
                  flush=True)
        d64 = [k for k in a if not k.endswith("hd96") and not k.startswith("proj ")
               and dt in k]
        same = all(torch.equal(a[k][0], b[k][0]) for k in d64)
        print(f"kernels 1 and 6 at head dim 64 in {dt}, {len(d64)} cases: the two checkouts' "
              f"outputs {'are equal bit for bit' if same else 'DIFFER'}", flush=True)
    for k in a:
        if k.endswith("hd96") and k in b:
            print(f"kernel 1 at head dim 96, {k}: largest difference of the two checkouts over "
                  f"valid rows {_hd96_difference(torch, a[k], b[k]):.3e} "
                  f"({'absolute' if 'bfloat16' in k else 'relative to max|out|'})", flush=True)
    # the mean of each checkout's two runs
    summary = {who: {name: {k: sum(r[name][k] for r in rs) / len(rs) for k in rs[0][name]}
                     for name in names} for who, rs in runs.items()}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
