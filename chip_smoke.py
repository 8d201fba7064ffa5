"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
1. environment: torch and CUDA versions, the card's name and power limit;
2. kernel build: the four CUDA kernels of
   ``src/deep_image_matching_tpu_torch/csrc`` compiled for sm_90a, with
   ptxas' register and spill report;
3. each kernel against its plain PyTorch version on the card, at the
   main-path shapes (partial masks, degenerate hypotheses), with its
   tolerance and both times (CUDA events, median of 10);
4. LightGlue at full width on a small batch with planted matches: the
   kernels on the card against the plain versions on the CPU;
5. the main path through the port's CLI entry ``run_matching``
   (superpoint+lightglue, random weights, --skip_reconstruction): 16
   synthetic 1024x1024 views with ``bruteforce`` pairs (match threshold 0,
   since random weights never reach the default 0.1; two views are shifted
   copies of the first, whose verified matches must carry the shift), then
   the 5 demo images with the default ``matching_lowres`` strategy and
   default settings. It checks features.h5, raw_matches.h5 and
   database.db, prints the wall time per stage, and checks that every
   kernel was launched during this phase.

Exits non-zero without a CUDA device, without the package beside it, or on
any failure. The last three lines are the card, the kernel report and the
device report.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
PKG = SRC / "deep_image_matching_tpu_torch"
WORK = ROOT / "build" / "chip_smoke"

# the last two synthetic views are view 0 shifted by these pixels
SHIFTS = {-2: (48, -32), -1: (-64, 24)}

# kernel name -> (source, TPU kernel it replaces)
KERNELS = {
    "attention": ("src/deep_image_matching_tpu_torch/csrc/attention.cu",
                  "src/deep_image_matching_tpu/ops/attention.py:96"),
    "ffn": ("src/deep_image_matching_tpu_torch/csrc/ffn.cu",
            "src/deep_image_matching_tpu/ops/pallas_ffn.py:89"),
    "assignment": ("src/deep_image_matching_tpu_torch/csrc/assignment.cu",
                   "src/deep_image_matching_tpu/ops/pallas_assignment.py:101"),
    "nullspace": ("src/deep_image_matching_tpu_torch/csrc/nullspace.cu",
                  "src/deep_image_matching_tpu/ops/pallas_nullspace.py:140"),
}


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _time_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events), after
    one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def phase_environment() -> str:
    import torch

    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    if not card:
        _fail(f"nvidia-smi gave no card ({smi.stderr.strip()})")
    print(f"[env] device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    return card


def phase_build() -> None:
    from deep_image_matching_tpu_torch.ops import _lib

    t0 = time.perf_counter()
    so = _lib.build()
    _lib.lib()
    dt = time.perf_counter() - t0
    print(f"[build] {so.relative_to(ROOT)} for sm_90a in {dt:.1f} s "
          f"(sources: {', '.join(_lib.SOURCES)})", flush=True)
    log = (_lib.BUILD_DIR / "ptxas.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {line.strip()}", flush=True)


def _masks(torch, gen, B, N, dev):
    """Partial masks: pair b keeps a random prefix count; one pair is
    fully valid and one keeps only a few points (its tail query tiles are
    fully masked)."""
    counts = torch.randint(N // 2, N + 1, (B,), generator=gen)
    counts[0] = N
    counts[1] = 37
    return (torch.arange(N)[None] < counts[:, None]).to(dev)


def check_attention(torch, dev, card):
    from deep_image_matching_tpu_torch.ops.attention import (
        attention_reference, fused_attention)

    gen = torch.Generator().manual_seed(1)
    B, H, N, d = 16, 4, 2048, 64
    q, k, v = (torch.randn(B, H, N, d, generator=gen).mul(s).to(dev, torch.bfloat16)
               for s in (2.0, 2.0, 1.0))
    qm = _masks(torch, gen, B, N, dev)
    km = _masks(torch, gen, B, N, dev)
    scale = d ** -0.5
    got = fused_attention(q, k, v, qm, km, scale)
    ref = attention_reference(q, k, v, km, scale)
    torch.cuda.synchronize()
    rows = qm[:, None, :, None].expand_as(got)
    diff = (got.float() - ref.float()).abs()[rows]
    mag = ref.float().abs()[rows].clamp(min=1.0)
    err = diff.max().item()
    # two bf16 ulps of the output (2^-6 relative at |x| >= 1): the output's
    # own rounding plus the probabilities, which the kernel rounds to bf16
    # before normalising and the plain version after
    if bool((diff > (2.0 ** -6) * mag).any()):
        err = float("inf")
    tol = float((2.0 ** -6) * mag.max())
    ms = _time_ms(lambda: fused_attention(q, k, v, qm, km, scale))
    plain_ms = _time_ms(lambda: attention_reference(q, k, v, km, scale))
    return err, tol, ms, plain_ms, "valid query rows, 2 bf16 ulps elementwise"


def check_ffn(torch, dev, card):
    from deep_image_matching_tpu_torch.ops.ffn import ffn_fused, ffn_reference

    gen = torch.Generator().manual_seed(2)
    B, K, D = 16, 2048, 256
    bf = torch.bfloat16

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen) * s).to(dev, bf)

    x, msg = rnd(B, K, D), rnd(B, K, D)
    w1 = rnd(2 * D, 2 * D, s=(2 * D) ** -0.5)
    b1 = rnd(2 * D, s=0.1)
    g = (1.0 + 0.1 * torch.randn(2 * D, generator=gen)).to(dev, bf)
    beta = rnd(2 * D, s=0.1)
    w2 = rnd(D, 2 * D, s=(2 * D) ** -0.5)
    b2 = rnd(D, s=0.1)
    args = (x, msg, w1, b1, g, beta, w2, b2)
    got = ffn_fused(*args)
    ref = ffn_reference(*args)
    torch.cuda.synchronize()
    diff = (got.float() - ref.float()).abs()
    err = diff.max().item()
    # one bf16 ulp of the output (2^-7 relative at |x| >= 1), for rounding
    # ties the f32 sums (other order, erff vs erf) put on the other side
    ulp = (2.0 ** -7) * ref.float().abs().clamp(min=1.0)
    if bool((diff > ulp + 1e-6).any()):
        err = max(err, float("inf"))
    tol = float((2.0 ** -7) * ref.float().abs().max().clamp(min=1.0))
    ms = _time_ms(lambda: ffn_fused(*args))
    plain_ms = _time_ms(lambda: ffn_reference(*args))
    return err, tol, ms, plain_ms, "1 bf16 ulp elementwise"


def check_assignment(torch, dev, card):
    from deep_image_matching_tpu_torch.ops.assignment import (
        assignment_fused, assignment_reference, log_assignment_dense)

    gen = torch.Generator().manual_seed(3)
    B, N, D = 16, 2048, 256
    md0 = (torch.randn(B, N, D, generator=gen) * D ** -0.25).to(dev)
    md1 = (torch.randn(B, N, D, generator=gen) * D ** -0.25).to(dev)
    z0 = torch.randn(B, N, generator=gen).to(dev)
    z1 = torch.randn(B, N, generator=gen).to(dev)
    m0 = _masks(torch, gen, B, N, dev)
    m1 = _masks(torch, gen, B, N, dev)
    got = assignment_fused(md0, md1, z0, z1, m0, m1)
    ref = assignment_reference(md0, md1, z0, z1, m0, m1)
    scores = log_assignment_dense(md0, md1, z0, z1, m0, m1)
    torch.cuda.synchronize()
    err = max((got[0] - ref[0]).abs()[m0].max().item(),
              (got[2] - ref[2]).abs()[m1].max().item())
    # argmax: equal, or a near-tie whose dense score is within 1e-4 of the max
    s_at0 = torch.gather(scores, 2, got[1].long()[..., None])[..., 0]
    s_at1 = torch.gather(scores, 1, got[3].long()[:, None, :])[:, 0, :]
    far0 = ((got[1] != ref[1]) & m0 & ((ref[0] - s_at0).abs() > 1e-4)).sum().item()
    far1 = ((got[3] != ref[3]) & m1 & ((ref[2] - s_at1).abs() > 1e-4)).sum().item()
    ties = int(((got[1] != ref[1]) & m0).sum().item() + ((got[3] != ref[3]) & m1).sum().item())
    if far0 or far1:
        err = float("inf")
    tol = 1e-3  # f32 sums in another order over D = 256 and N = 2048
    ms = _time_ms(lambda: assignment_fused(md0, md1, z0, z1, m0, m1))
    plain_ms = _time_ms(lambda: assignment_reference(md0, md1, z0, z1, m0, m1))
    return err, tol, ms, plain_ms, f"valid rows; argmax near-ties {ties}"


def check_nullspace(torch, dev, card):
    from deep_image_matching_tpu_torch.ops.nullspace import (
        nullspace_planes, nullspace_reference)

    gen = torch.Generator().manual_seed(4)
    N = 16 * 2048
    p0 = torch.rand(N, 8, 2, generator=gen) * 2 - 1
    shift = torch.rand(N, 1, 2, generator=gen) - 0.5
    kind = torch.arange(N) % 4
    # 0, 1: generic; 2: pure translation (f33 = 0, degenerate); 3: all-zero
    p1 = torch.where((kind == 2)[:, None, None], p0 + shift,
                     torch.rand(N, 8, 2, generator=gen) * 2 - 1)
    x0, y0, x1, y1 = p0[..., 0], p0[..., 1], p1[..., 0], p1[..., 1]
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0,
                     torch.ones_like(x0)], dim=-1)          # (N, 8, 9)
    A[kind == 3] = 0.0
    A9 = A.permute(2, 1, 0).contiguous().to(dev)            # (9, 8, N)
    got = nullspace_planes(A9)
    ref = nullspace_reference(A9)
    torch.cuda.synchronize()
    gen_cols = (kind <= 1).to(dev)
    diff = torch.minimum((got - ref).abs().amax(0), (got + ref).abs().amax(0))
    err = diff[gen_cols].max().item()
    live = (kind <= 2).to(dev)
    res = torch.einsum("nrc,cn->nr", A.to(dev), got).abs().amax(1)
    norm_err = (got.norm(dim=0) - 1).abs()[live].max().item()
    if res[live].max().item() > 1e-4 or norm_err > 1e-5 or not torch.isfinite(got).all():
        err = float("inf")
    # generic systems, up to sign: f32 null directions of random 8x9 systems
    # move by ~eps / sigma_8 between two QR orderings; degenerate ones (a
    # >= 2-dim null space) are held to the residual |A f| < 1e-4 only
    tol = 1e-3
    ms = _time_ms(lambda: nullspace_planes(A9))
    plain_ms = _time_ms(lambda: nullspace_reference(A9))
    return err, tol, ms, plain_ms, "generic up to sign; residual < 1e-4 incl. f33 = 0"


def phase_kernels(card: str) -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    checks = {"attention": check_attention, "ffn": check_ffn,
              "assignment": check_assignment, "nullspace": check_nullspace}
    report = {}
    ok = True
    for name, fn in checks.items():
        err, tol, ms, plain_ms, what = fn(torch, dev, card)
        good = err <= tol
        ok &= good
        report[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        print(f"[kernel] {name}: max_abs_err {err:.3e} (tol {tol:.1e}, {what}) "
              f"{'OK' if good else 'FAIL'}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
              f"[{card}]", flush=True)
    if not ok:
        _fail("a kernel disagrees with its plain version")
    return report


def _synthetic_project(root: Path, n: int = 16, size: int = 1024, seed: int = 0) -> Path:
    """``n`` views of one textured plane, written as PNG: random homographies
    (small rotation, scale, shear and shift), except that the last two views
    are view 0 shifted by whole SuperPoint cells. Random weights give no
    confident matches between warped views, but shifted copies keep their
    descriptors, so those pairs do match and reach verification (a pure
    translation: the f33 = 0 case of the null-space solve)."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    big = 2 * size
    tex = rng.integers(0, 256, (big, big), dtype=np.uint8)
    tex = cv2.GaussianBlur(tex, (0, 0), 4)
    for _ in range(300):  # blobs and strokes for corners at several scales
        c = tuple(int(v) for v in rng.integers(0, big, 2))
        col = int(rng.integers(0, 256))
        if rng.random() < 0.5:
            cv2.circle(tex, c, int(rng.integers(4, 40)), col, -1)
        else:
            d = tuple(int(v) for v in rng.integers(0, big, 2))
            cv2.line(tex, c, d, col, int(rng.integers(1, 6)))
    tex = cv2.normalize(tex, None, 0, 255, cv2.NORM_MINMAX)
    img_dir = root / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    center = np.array([big / 2, big / 2])
    H0 = None
    for i in range(n):
        if i >= n - 2 and H0 is not None:
            shift = np.eye(3)
            shift[:2, 2] = SHIFTS[i - n]
            view = cv2.warpPerspective(tex, H0 @ shift, (size, size),
                                       flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
            cv2.imwrite(str(img_dir / f"view_{i:02d}.png"), view)
            continue
        ang = rng.uniform(-0.2, 0.2)
        s = rng.uniform(0.8, 1.2)
        R = s * np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
        R = R + rng.normal(0, 0.03, (2, 2))
        t = center - R @ np.array([size / 2, size / 2]) + rng.uniform(-200, 200, 2)
        H = np.eye(3)
        H[:2, :2], H[:2, 2] = R, t
        H[2, :2] = rng.normal(0, 5e-5, 2)
        if i == 0:
            H[2, :2] = 0.0  # affine, so a shifted copy is an exact pixel shift
            H0 = H
        view = cv2.warpPerspective(tex, H, (size, size),
                                   flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
        cv2.imwrite(str(img_dir / f"view_{i:02d}.png"), view)
    return root


class _TimerLog:
    """Collects the port's '[Timer]' log lines (the per-stage wall times)."""

    def __init__(self):
        import logging

        self.lines = []
        self.handler = logging.Handler()
        self.handler.emit = lambda rec: (
            self.lines.append(rec.getMessage()) if "[Timer]" in rec.getMessage() else None)
        logging.getLogger("dim_tpu_torch").addHandler(self.handler)


def _check_outputs(out_dir: Path, names: list, n_pairs: int) -> str:
    import sqlite3

    import numpy as np

    from deep_image_matching_tpu_torch.io import hdf5

    feats, raw, ver = out_dir / "features.h5", out_dir / "raw_matches.h5", out_dir / "matches.h5"
    counts = {}
    with hdf5.File(feats, "r") as f:
        if sorted(f.keys()) != sorted(names):
            _fail(f"features.h5 holds {len(f.keys())} of {len(names)} images")
        for name in names:
            k = np.asarray(f[name]["keypoints"])
            d = np.asarray(f[name]["descriptors"])
            w, h = np.asarray(f[name]["image_size"])
            if not (np.isfinite(k).all() and np.isfinite(d).all()) or d.shape != (256, len(k)):
                _fail(f"features of {name}: bad values or shape {d.shape}")
            if len(k) and (k.min() < 0 or k[:, 0].max() >= w or k[:, 1].max() >= h):
                _fail(f"keypoints of {name} outside the image")
            counts[name] = len(k)

    def pairs_of(path):
        out = []
        if path.exists():
            with hdf5.File(path, "r") as f:
                for a in f:
                    for b in f[a]:
                        m = np.asarray(f[a][b])
                        if len(m) and (m.min() < 0 or m[:, 0].max() >= counts[a]
                                       or m[:, 1].max() >= counts[b]):
                            _fail(f"match indices of {a}-{b} out of range")
                        out.append((a, b, len(m)))
        return out

    raw_pairs, ver_pairs = pairs_of(raw), pairs_of(ver)
    if len(raw_pairs) != n_pairs:
        _fail(f"raw_matches.h5 holds {len(raw_pairs)} of {n_pairs} pairs")
    db = sqlite3.connect(str(out_dir / "database.db"))
    try:
        n_img = db.execute("SELECT COUNT(*) FROM images").fetchone()[0]
        n_kp = db.execute("SELECT COUNT(*) FROM keypoints").fetchone()[0]
        n_m = db.execute("SELECT COUNT(*) FROM matches").fetchone()[0]
        n_tv = db.execute("SELECT COUNT(*) FROM two_view_geometries").fetchone()[0]
    finally:
        db.close()
    if n_img != len(names) or n_m != len(raw_pairs) or n_tv != len(ver_pairs):
        _fail(f"database.db: {n_img} images, {n_m} match rows, {n_tv} two-view rows; "
              f"expected {len(names)}, {len(raw_pairs)}, {len(ver_pairs)}")
    if n_kp != sum(1 for c in counts.values() if c):
        _fail(f"database.db: {n_kp} keypoint rows")
    n_raw = sum(n for _, _, n in raw_pairs)
    n_ver = sum(n for _, _, n in ver_pairs)
    return (f"{len(names)} images, {sum(counts.values())} keypoints, {len(raw_pairs)} pairs "
            f"({n_raw} raw matches), {len(ver_pairs)} verified pairs ({n_ver} inliers)")


def _check_shifted(out_dir: Path, names: list) -> str:
    """Verified matches between view 0 and its shifted copies must carry
    the planted shift, and at least one such pair must verify."""
    import numpy as np

    from deep_image_matching_tpu_torch.io import hdf5

    shift = {names[0]: np.zeros(2)}
    shift.update({names[k]: np.asarray(v, float) for k, v in SHIFTS.items()})
    done = []
    with hdf5.File(out_dir / "features.h5", "r") as f, \
            hdf5.File(out_dir / "matches.h5", "r") as m:
        for a in m:
            for b in m[a]:
                if a not in shift or b not in shift:
                    continue
                mt = np.asarray(m[a][b])
                d = (np.asarray(f[a]["keypoints"])[mt[:, 0]]
                     - np.asarray(f[b]["keypoints"])[mt[:, 1]])
                err = np.median(np.abs(d - (shift[b] - shift[a])).max(1))
                if err > 1.0:
                    _fail(f"verified matches {a}-{b} are off the planted shift by {err:.2f} px")
                done.append(f"{a}-{b} {len(mt)}")
    if not done:
        _fail("no pair of view 0 and its shifted copies verified")
    return "shifted pairs verified: " + ", ".join(done)


def phase_reference(card: str) -> None:
    """LightGlue at full width (9 layers, D = 256, adaptive depth and width
    pruning) on a small batch: the kernels on the card against the plain
    versions on the CPU, both in bf16. Image 1 holds image 0's keypoints
    permuted and shifted with the same descriptors, so matches exist."""
    import torch

    from deep_image_matching_tpu_torch.models.lightglue import LightGlue, forward

    gen = torch.Generator().manual_seed(7)
    B, K = 2, 512
    model = LightGlue().reset_random(gen).eval()
    kpts0 = torch.rand(B, K, 2, generator=gen) * torch.tensor([640.0, 480.0])
    perm = torch.stack([torch.randperm(K, generator=gen) for _ in range(B)])
    kpts1 = torch.gather(kpts0, 1, perm[..., None].expand(-1, -1, 2)) + torch.tensor([24.0, -16.0])
    desc0 = torch.nn.functional.normalize(torch.randn(B, K, 256, generator=gen), dim=-1)
    desc1 = torch.gather(desc0, 1, perm[..., None].expand(-1, -1, 256))
    mask = torch.ones(B, K, dtype=torch.bool)
    mask[1, 400:] = False
    size = torch.tensor([[640.0, 480.0]]).expand(B, 2)
    kw = dict(filter_threshold=0.0, depth_confidence=0.95, width_confidence=0.99,
              pruning_min_kpts=128, compute_dtype=torch.bfloat16)
    args = (kpts0, kpts1, desc0, desc1, mask, torch.gather(mask, 1, perm), size, size)
    cpu = forward(model, *args, **kw)
    dev = torch.device("cuda", 0)
    gpu = forward(model.to(dev), *(a.to(dev) for a in args), **kw)
    model.cpu()
    both = cpu["valid0"] & gpu["valid0"].cpu()
    agree = (cpu["matches0"] == gpu["matches0"].cpu())[both].float().mean().item()
    inv = torch.argsort(perm, dim=1)
    truth = (gpu["matches0"].cpu() == inv) & gpu["valid0"].cpu()
    print(f"[ref] LightGlue B={B} K={K}: layers_run cpu {cpu['layers_run']} gpu "
          f"{gpu['layers_run']}; mutual matches cpu {int(cpu['valid0'].sum())} gpu "
          f"{int(gpu['valid0'].sum())}; agreement on rows matched by both {agree:.4f}; "
          f"gpu matches at the planted correspondence {int(truth.sum())} [{card}]", flush=True)
    # bf16 on both sides, sums in another order: rare flips of near-ties
    # only, and the exit layer must agree
    planted_cpu = int(((cpu["matches0"] == inv) & cpu["valid0"]).sum())
    if cpu["layers_run"] != gpu["layers_run"] or agree < 0.99 or truth.sum() < 0.95 * planted_cpu:
        _fail("LightGlue on the card disagrees with the plain versions on the CPU")


def phase_main_path(card: str) -> dict:
    import torch

    from deep_image_matching_tpu_torch.__main__ import run_matching
    from deep_image_matching_tpu_torch.ops import _lib

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    base = "general:\n  allow_random_weights: true\n  tpu:\n    device: cuda\n"
    configs = {"default": WORK / "default.yaml", "threshold0": WORK / "threshold0.yaml"}
    configs["default"].write_text(base)
    # random weights never reach the default 0.1 match score, so the
    # synthetic run keeps every mutual nearest neighbour for verification
    configs["threshold0"].write_text(base + "matcher:\n  filter_threshold: 0.0\n")
    synth = _synthetic_project(WORK / "synthetic16")
    demo = WORK / "demo5"
    shutil.copytree(ROOT / "notebooks" / "demo_project" / "images", demo / "images")
    timers = _TimerLog()

    _lib.reset_launch_counts()
    for proj, strategy, cfg in ((synth, "bruteforce", configs["threshold0"]),
                                (demo, "matching_lowres", configs["default"])):
        names = sorted(p.name for p in (proj / "images").iterdir())
        t0 = time.perf_counter()
        feature_path, _, _ = run_matching({
            "dir": str(proj), "pipeline": "superpoint+lightglue", "strategy": strategy,
            "skip_reconstruction": True, "force": True, "config_file": str(cfg),
        })
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out_dir = feature_path.parent
        n_pairs = len((out_dir / "pairs.txt").read_text().splitlines())
        if strategy == "bruteforce" and n_pairs != len(names) * (len(names) - 1) // 2:
            _fail(f"bruteforce gave {n_pairs} pairs")
        summary = _check_outputs(out_dir, names, n_pairs)
        if proj is synth:
            summary += "; " + _check_shifted(out_dir, names)
        stages = timers.lines[-1].split("] ", 2)[-1] if timers.lines else "no timer line"
        print(f"[main] {proj.name} ({strategy}): {summary}; run_matching {wall:.2f} s; "
              f"stages {stages} [{card}]", flush=True)
    launches = dict(_lib.LAUNCHES)
    print(f"[main] kernel launches during the main path: {launches}", flush=True)
    if not all(launches[k] > 0 for k in KERNELS):
        _fail("a kernel of the main path was never launched")
    return launches


def main() -> None:
    if not PKG.is_dir():
        print("FAIL: the port package is missing next to chip_smoke.py", flush=True)
        sys.exit(2)
    sys.path.insert(0, str(SRC))
    import torch

    card = phase_environment()
    print(f"[env] {card}", flush=True)
    phase_build()
    report = phase_kernels(card)
    phase_reference(card)
    launches = phase_main_path(card)
    kernels = [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name], **report[name]}
        for name in KERNELS
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
