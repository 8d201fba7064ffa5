"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
1. environment: torch and CUDA versions, the card's name and power limit;
2. kernel build: the CUDA sources of ``src/deep_image_matching_tpu_torch/csrc``
   compiled for sm_90a (one nvcc per source, all started together), with
   ptxas' register and spill report;
3. each kernel against its plain PyTorch version on the card, at the
   main-path shapes (partial masks, degenerate hypotheses, integer
   descriptors with ties), with its tolerance and both times (CUDA events,
   median of 10): attention (LightGlue's and SuperGlue's shapes), the FFN
   in both modes (ln_gelu at LightGlue's shape, relu at SuperGlue's),
   assignment, null space, nearest neighbours, the Sinkhorn iteration and
   the row logsumexp;
4. LightGlue and SuperGlue at full width on small batches with planted
   matches: the kernels on the card against the plain versions on the CPU;
5. the main paths through the port's CLI entry ``run_matching`` (random
   weights, --skip_reconstruction), each with the launch counts set to 0
   just before it and read just after:
   - superpoint+lightglue: 16 synthetic 1024x1024 views with ``bruteforce``
     pairs (match threshold 0, since random weights never reach the default
     0.1; two views are shifted copies of the first, whose verified matches
     must carry the shift), then the 5 demo images with the default
     ``matching_lowres`` strategy and default settings;
   - superpoint+superglue on the synthetic views (``bruteforce``, match
     threshold 0);
   - superpoint+kornia_matcher on the synthetic views (the shifted copies
     keep their descriptors, so their verified matches carry the shift);
   - sift+kornia_matcher and orb+kornia_matcher on the 5 demo images
     (``bruteforce``), on the card and again on the CPU: the raw matches must
     be equal pair by pair, since the arithmetic on integer descriptors is
     exact.
   Each run checks features.h5, raw_matches.h5 and database.db and prints
   the wall time per stage; each path checks that its kernels launched.

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
    "nn": ("src/deep_image_matching_tpu_torch/csrc/nn.cu",
           "src/deep_image_matching_tpu/ops/pallas_nn.py:122"),
    "sinkhorn": ("src/deep_image_matching_tpu_torch/csrc/sinkhorn.cu",
                 "src/deep_image_matching_tpu/ops/pallas_sinkhorn.py:140"),
    "lse_rows": ("src/deep_image_matching_tpu_torch/csrc/sinkhorn.cu",
                 "src/deep_image_matching_tpu/ops/pallas_sinkhorn.py:64"),
}

# no path of the JAX package calls logsumexp_rows: it is held against its
# plain version only and exempt from the launch check
NO_CALLER = {"lse_rows": "no caller on any path of the JAX package; held against its "
                         "plain version only"}


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


def _attention_case(torch, fused_attention, attention_reference, q, k, v, qm, km):
    """One attention shape: the error held to two bf16 ulps elementwise over
    valid query rows (inf if any element exceeds it), the bound, both times."""
    scale = q.shape[-1] ** -0.5
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
    del got, ref, diff, rows, mag
    ms = _time_ms(lambda: fused_attention(q, k, v, qm, km, scale))
    plain_ms = _time_ms(lambda: attention_reference(q, k, v, km, scale))
    return err, tol, ms, plain_ms


def check_attention(torch, dev, card):
    from deep_image_matching_tpu_torch.ops.attention import (
        attention_reference, fused_attention)

    gen = torch.Generator().manual_seed(1)
    # LightGlue's shape: (B, H, T, 64) heads split from contiguous channels
    B, H, N, d = 16, 4, 2048, 64
    q, k, v = (torch.randn(B, H, N, d, generator=gen).mul(s).to(dev, torch.bfloat16)
               for s in (2.0, 2.0, 1.0))
    qm = _masks(torch, gen, B, N, dev)
    km = _masks(torch, gen, B, N, dev)
    err, tol, ms, plain_ms = _attention_case(
        torch, fused_attention, attention_reference, q, k, v, qm, km)
    del q, k, v
    torch.cuda.empty_cache()
    # SuperGlue's shape: T = 4096, heads interleaved across the 256 channels
    # (viewed as (head_dim, heads)), made contiguous as models/superglue.py's
    # _mha makes them
    T = 4096

    def heads(t):
        return t.reshape(B, T, d, H).permute(0, 3, 1, 2).contiguous()

    q, k, v = (heads(torch.randn(B, T, H * d, generator=gen).mul(s).to(dev, torch.bfloat16))
               for s in (2.0, 2.0, 1.0))
    qm = _masks(torch, gen, B, T, dev)
    km = _masks(torch, gen, B, T, dev)
    sg_err, sg_tol, sg_ms, sg_plain_ms = _attention_case(
        torch, fused_attention, attention_reference, q, k, v, qm, km)
    what = (f"valid query rows, 2 bf16 ulps elementwise; (16, 4, 2048, 64) reported; "
            f"SuperGlue's (16, 4, 4096, 64) interleaved heads: max err {sg_err:.3e}, kernel "
            f"{sg_ms:.3f} ms, plain {sg_plain_ms:.3f} ms")
    extra = {"superglue_shape": [B, H, T, d], "superglue_max_abs_err": sg_err,
             "superglue_ms": sg_ms, "superglue_plain_ms": sg_plain_ms}
    # each shape is held to its own elementwise bound (inf on failure)
    return max(err, sg_err), max(tol, sg_tol), ms, plain_ms, what, extra


def check_ffn(torch, dev, card):
    from deep_image_matching_tpu_torch.ops.ffn import ffn_fused, ffn_reference

    gen = torch.Generator().manual_seed(2)
    D = 256
    bf = torch.bfloat16

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen) * s).to(dev, bf)

    w1 = rnd(2 * D, 2 * D, s=(2 * D) ** -0.5)
    b1 = rnd(2 * D, s=0.1)
    g = (1.0 + 0.1 * torch.randn(2 * D, generator=gen)).to(dev, bf)
    beta = rnd(2 * D, s=0.1)
    w2 = rnd(D, 2 * D, s=(2 * D) ** -0.5)
    b2 = rnd(D, s=0.1)
    errs, times = {}, {}
    # each mode at its path's shape: LightGlue's ln_gelu at K = 2048,
    # SuperGlue's relu at K = 4096
    for mode, K in (("ln_gelu", 2048), ("relu", 4096)):
        args = (rnd(16, K, D), rnd(16, K, D), w1, b1, g, beta, w2, b2)
        got = ffn_fused(*args, mode=mode)
        ref = ffn_reference(*args, mode=mode)
        torch.cuda.synchronize()
        diff = (got.float() - ref.float()).abs()
        err = diff.max().item()
        # one bf16 ulp of the output (2^-7 relative at |x| >= 1), for rounding
        # ties the f32 sums (other order, erff vs erf) put on the other side
        ulp = (2.0 ** -7) * ref.float().abs().clamp(min=1.0)
        if bool((diff > ulp + 1e-6).any()):
            err = float("inf")
        errs[mode] = (err, float((2.0 ** -7) * ref.float().abs().max().clamp(min=1.0)))
        times[mode] = (_time_ms(lambda: ffn_fused(*args, mode=mode)),
                       _time_ms(lambda: ffn_reference(*args, mode=mode)))
    # each mode is held to its own elementwise bound above (inf on failure);
    # the report carries the larger error and the larger bound
    err = max(e for e, _ in errs.values())
    tol = max(t for _, t in errs.values())
    what = ("1 bf16 ulp elementwise; ln_gelu (16, 2048, 256) (reported times) max err "
            f"{errs['ln_gelu'][0]:.3e}; relu (16, 4096, 256) max err {errs['relu'][0]:.3e}, "
            f"kernel {times['relu'][0]:.3f} ms, plain {times['relu'][1]:.3f} ms")
    extra = {"relu_shape": [16, 4096, D], "relu_max_abs_err": errs["relu"][0],
             "relu_ms": times["relu"][0], "relu_plain_ms": times["relu"][1]}
    return err, tol, times["ln_gelu"][0], times["ln_gelu"][1], what, extra


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


def check_nn(torch, dev, card):
    from deep_image_matching_tpu_torch.ops.nn import nn_top2, nn_top2_reference

    gen = torch.Generator().manual_seed(5)
    F = torch.nn.functional
    # SuperPoint's shape: unit-norm f32, K = 4096, half the queries with a
    # near copy among the references, partial masks (invalid references carry
    # the 1e12 squared-norm offset, as nn_match_fused gives them)
    B, K, D = 16, 4096, 256
    d0 = F.normalize(torch.randn(B, K, D, generator=gen), dim=-1)
    d1 = F.normalize(torch.randn(B, K, D, generator=gen), dim=-1)
    d1[:, : K // 2] = F.normalize(d0[:, : K // 2] + 0.3 * torch.randn(B, K // 2, D, generator=gen),
                                  dim=-1)
    m0 = _masks(torch, gen, B, K, "cpu")
    m1 = _masks(torch, gen, B, K, "cpu")
    d0 = (d0 * m0[..., None]).to(dev)
    d1 = (d1 * m1[..., None]).to(dev)
    sq1 = (d1 ** 2).sum(-1) + torch.where(m1.to(dev), 0.0, 1e12)
    got = nn_top2(d0, d1, sq1)
    ref = nn_top2_reference(d0, d1, sq1)
    torch.cuda.synchronize()
    err = max((got[0] - ref[0]).abs().max().item(), (got[1] - ref[1]).abs().max().item())
    gap = ref[1] - ref[0]
    same = got[2] == ref[2]
    equal_share = same.float().mean().item()
    far = int((~same & (gap > 1e-3)).sum().item())
    if far or equal_share < 0.999:
        err = float("inf")
    tol = 1e-4  # f32 FMA sums over D = 256 in another order
    ms = _time_ms(lambda: nn_top2(d0, d1, sq1))
    plain_ms = _time_ms(lambda: nn_top2_reference(d0, d1, sq1))
    # SIFT (128) and ORB (32) widths: byte-valued descriptors at capacity
    # 4000 with exact neighbours, double minima and duplicated columns; the
    # f32 arithmetic is exact, so every output must be bitwise equal
    exact = []
    for Dw in (128, 32):
        Bi, Ki = 4, 4000
        q = torch.randint(0, 256, (Bi, Ki, Dw), generator=gen).float()
        r = torch.randint(0, 256, (Bi, Ki, Dw), generator=gen).float()
        r[:, 10:1010] = q[:, :1000]
        r[:, 1010:1510] = q[:, :500]      # queries 0-499 reach their minimum twice
        r[:, 2000:3000] = r[:, 1000:2000]  # duplicated columns
        q, r = q.to(dev), r.to(dev)
        sq = (r ** 2).sum(-1)
        g, rf = nn_top2(q, r, sq), nn_top2_reference(q, r, sq)
        ok = all(torch.equal(a, b) for a, b in zip(g, rf))
        ok &= bool((g[0][:, :500] == g[1][:, :500]).all())
        exact.append(f"D={Dw} {'bitwise equal' if ok else 'DIFFERENT'}")
        if not ok:
            err = float("inf")
    what = (f"D=256 min1/min2 abs; argmin equal {equal_share:.5f}, none differs where the "
            f"gap > 1e-3; {', '.join(exact)}")
    return err, tol, ms, plain_ms, what


def _couplings(torch, gen, B, M, N, dev):
    """SuperGlue-shaped log couplings with dustbins: masked rows and columns
    at -1e30, the marginals of masked entries at -1e30, the last row and
    column (the dustbins) valid."""
    m0 = _masks(torch, gen, B, M, "cpu")
    m1 = _masks(torch, gen, B, N, "cpu")
    m0[:, -1] = True
    m1[:, -1] = True
    z = torch.randn(B, M, N, generator=gen) * 3.0
    z = torch.where(m0[:, :, None] & m1[:, None, :], z, torch.tensor(-1e30))
    norm = -torch.log((m0.sum(1) + m1.sum(1)).float())[:, None]
    log_mu = torch.where(m0, norm, torch.tensor(-1e30))
    log_nu = torch.where(m1, norm, torch.tensor(-1e30))
    return z.to(dev), log_mu.to(dev), log_nu.to(dev), m0.to(dev), m1.to(dev)


def check_sinkhorn(torch, dev, card):
    from deep_image_matching_tpu_torch.models.superglue import _filter
    from deep_image_matching_tpu_torch.ops.sinkhorn import (
        sinkhorn_fused, sinkhorn_iteration, sinkhorn_iteration_reference)

    gen = torch.Generator().manual_seed(6)
    # SuperGlue at 4096 keypoints: (4097, 4097) couplings; the kernel masks
    # the ragged edge, so nothing is padded
    B, M, N = 16, 4097, 4097
    z, log_mu, log_nu, m0, m1 = _couplings(torch, gen, B, M, N, dev)
    v0 = torch.zeros_like(log_nu)
    u1, v1 = sinkhorn_iteration(z, v0, log_mu, log_nu)
    ru, rv = sinkhorn_iteration_reference(z, v0, log_mu, log_nu)
    torch.cuda.synchronize()
    err1 = max((u1 - ru).abs()[m0].max().item(), (v1 - rv).abs()[m1].max().item())
    u, v = sinkhorn_fused(z, log_mu, log_nu, 100)
    ru, rv = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(100):
        ru, rv = sinkhorn_iteration_reference(z, rv, log_mu, log_nu)
    torch.cuda.synchronize()
    err100 = max((u - ru).abs()[m0].max().item(), (v - rv).abs()[m1].max().item())
    # the matches SuperGlue's _filter reads from each (threshold 0)
    got_m, _, got_v = _filter(z + u[:, :, None] + v[:, None, :], m0[:, :-1], m1[:, :-1], 0.0)
    ref_m, _, ref_v = _filter(z + ru[:, :, None] + rv[:, None, :], m0[:, :-1], m1[:, :-1], 0.0)
    rows = got_v | ref_v
    agree = ((got_m == ref_m) & (got_v == ref_v))[rows].float().mean().item()
    # 1e-4 after one iteration, 1e-3 after 100 (f32 logsumexps over 4097
    # terms summed in another order, compounded over the iterations)
    err = err1 if err100 <= 1e-3 and agree >= 0.999 else float("inf")
    tol = 1e-4
    ms = _time_ms(lambda: sinkhorn_iteration(z, v0, log_mu, log_nu))
    plain_ms = _time_ms(lambda: sinkhorn_iteration_reference(z, v0, log_mu, log_nu))
    what = (f"valid u, v after 1 iteration; after 100: {err100:.3e} (tol 1e-3), _filter "
            f"matches equal {agree:.5f} of {int(rows.sum())}; times per iteration")
    return err, tol, ms, plain_ms, what, {"max_abs_err_100_iterations": err100}


def check_lse_rows(torch, dev, card):
    from deep_image_matching_tpu_torch.ops.sinkhorn import (
        logsumexp_rows, logsumexp_rows_reference)

    gen = torch.Generator().manual_seed(8)
    B, M, N = 16, 4097, 4097
    z, log_mu, _, _, _ = _couplings(torch, gen, B, M, N, dev)
    v = torch.randn(B, N, generator=gen).to(dev)
    got = logsumexp_rows(z, v, log_mu)
    ref = logsumexp_rows_reference(z, v, log_mu)
    torch.cuda.synchronize()
    # relative 1e-5 (the -1e30 rows compare relatively too)
    rel = ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    ms = _time_ms(lambda: logsumexp_rows(z, v, log_mu))
    plain_ms = _time_ms(lambda: logsumexp_rows_reference(z, v, log_mu))
    return rel, 1e-5, ms, plain_ms, "relative to max(|u|, 1), every row"


def phase_kernels(card: str) -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    checks = {"attention": check_attention, "ffn": check_ffn,
              "assignment": check_assignment, "nullspace": check_nullspace,
              "nn": check_nn, "sinkhorn": check_sinkhorn, "lse_rows": check_lse_rows}
    report = {}
    ok = True
    for name, fn in checks.items():
        err, tol, ms, plain_ms, what, *extra = fn(torch, dev, card)
        good = err <= tol
        ok &= good
        report[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **(extra or [{}])[0]}
        torch.cuda.empty_cache()
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


def _check_outputs(out_dir: Path, names: list, n_pairs: int, dim: int):
    """Check a run's files; returns a summary line and the number of
    verified pairs."""
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
            if not (np.isfinite(k).all() and np.isfinite(d).all()) or d.shape != (dim, len(k)):
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
            f"({n_raw} raw matches), {len(ver_pairs)} verified pairs ({n_ver} inliers)",
            len(ver_pairs))


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
    _reference_lightglue(card)
    _reference_superglue(card)


def _reference_lightglue(card: str) -> None:
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


def _reference_superglue(card: str) -> None:
    """SuperGlue at full width (9 blocks, D = 256, 4 heads, 100 Sinkhorn
    iterations) on a small batch: the kernels on the card (attention, the
    FFN's relu mode, Sinkhorn) against the plain versions on the CPU, both in
    bf16. Image 1 holds image 0's keypoints permuted, with the same
    descriptors and scores, so every valid keypoint has a planted match."""
    import torch

    from deep_image_matching_tpu_torch.models.superglue import SuperGlue, forward

    gen = torch.Generator().manual_seed(9)
    B, K = 2, 1024
    model = SuperGlue().reset_random(gen).eval()
    kpts0 = torch.rand(B, K, 2, generator=gen) * torch.tensor([640.0, 480.0])
    perm = torch.stack([torch.randperm(K, generator=gen) for _ in range(B)])
    kpts1 = torch.gather(kpts0, 1, perm[..., None].expand(-1, -1, 2))
    desc0 = torch.nn.functional.normalize(torch.randn(B, K, 256, generator=gen), dim=-1)
    desc1 = torch.gather(desc0, 1, perm[..., None].expand(-1, -1, 256))
    sc0 = torch.rand(B, K, generator=gen)
    mask = torch.ones(B, K, dtype=torch.bool)
    mask[1, 800:] = False
    size = torch.tensor([[640.0, 480.0]]).expand(B, 2)
    args = (kpts0, kpts1, sc0, torch.gather(sc0, 1, perm), desc0, desc1, mask,
            torch.gather(mask, 1, perm), size, size)
    kw = dict(sinkhorn_iterations=100, match_threshold=0.0, compute_dtype=torch.bfloat16)
    cpu = forward(model, *args, **kw)
    dev = torch.device("cuda", 0)
    gpu = forward(model.to(dev), *(a.to(dev) for a in args), **kw)
    model.cpu()
    both = cpu["valid0"] & gpu["valid0"].cpu()
    agree = (cpu["matches0"] == gpu["matches0"].cpu())[both].float().mean().item()
    inv = torch.argsort(perm, dim=1)
    truth = (gpu["matches0"].cpu() == inv) & gpu["valid0"].cpu()
    planted_cpu = int(((cpu["matches0"] == inv) & cpu["valid0"]).sum())
    print(f"[ref] SuperGlue B={B} K={K}: mutual matches cpu {int(cpu['valid0'].sum())} gpu "
          f"{int(gpu['valid0'].sum())}; agreement on rows matched by both {agree:.4f}; "
          f"planted matches found cpu {planted_cpu} gpu {int(truth.sum())} of "
          f"{int(mask.sum())} [{card}]", flush=True)
    # bf16 on both sides, sums in another order: the LightGlue phase's bar
    if agree < 0.99 or truth.sum() < 0.95 * planted_cpu:
        _fail("SuperGlue on the card disagrees with the plain versions on the CPU")


# path -> (kernels it must launch, its runs: (project, strategy, config,
# descriptor width, CPU comparison)). Each path starts with the launch
# counts at 0 and reads them when its runs are done.
PATHS = {
    "superpoint+lightglue": (("attention", "ffn", "assignment", "nullspace"), (
        ("synthetic16", "bruteforce", "threshold0", 256, False),
        ("demo5", "matching_lowres", "default", 256, False))),
    "superpoint+superglue": (("attention", "ffn", "sinkhorn", "nullspace"), (
        ("synthetic16", "bruteforce", "superglue0", 256, False),)),
    "superpoint+kornia_matcher": (("nn", "nullspace"), (
        ("synthetic16", "bruteforce", "default", 256, False),)),
    "sift+kornia_matcher": (("nn", "nullspace"), (
        ("demo5", "bruteforce", "default", 128, True),)),
    "orb+kornia_matcher": (("nn", "nullspace"), (
        ("demo5", "bruteforce", "default", 32, True),)),
}


def _raw_match_sets(out_dir: Path) -> dict:
    """Raw matches per pair as sets of keypoint-coordinate pairs."""
    import numpy as np

    from deep_image_matching_tpu_torch.io import hdf5

    out = {}
    with hdf5.File(out_dir / "features.h5", "r") as f, \
            hdf5.File(out_dir / "raw_matches.h5", "r") as m:
        for a in m:
            for b in m[a]:
                mt = np.asarray(m[a][b])
                ka, kb = np.asarray(f[a]["keypoints"]), np.asarray(f[b]["keypoints"])
                out[(a, b)] = {tuple(ka[i]) + tuple(kb[j]) for i, j in mt}
    return out


def _run(pipeline: str, proj: Path, strategy: str, cfg: Path, outs: Path):
    from deep_image_matching_tpu_torch.__main__ import run_matching

    feature_path, _, _ = run_matching({
        "dir": str(proj), "outs": str(outs), "pipeline": pipeline, "strategy": strategy,
        "skip_reconstruction": True, "force": True, "config_file": str(cfg),
    })
    return feature_path.parent


def phase_main_path(card: str) -> dict:
    import torch

    from deep_image_matching_tpu_torch.ops import _lib

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    base = "general:\n  allow_random_weights: true\n  tpu:\n    device: {}\n"
    configs = {name: WORK / f"{name}.yaml"
               for name in ("default", "threshold0", "superglue0", "cpu")}
    configs["default"].write_text(base.format("cuda"))
    # random weights never reach LightGlue's 0.1 or SuperGlue's 0.3 match
    # score, so the synthetic runs keep every mutual nearest neighbour
    configs["threshold0"].write_text(base.format("cuda") + "matcher:\n  filter_threshold: 0.0\n")
    configs["superglue0"].write_text(base.format("cuda") + "matcher:\n  match_threshold: 0.0\n")
    configs["cpu"].write_text(base.format("cpu"))
    projects = {"synthetic16": _synthetic_project(WORK / "synthetic16"), "demo5": WORK / "demo5"}
    shutil.copytree(ROOT / "notebooks" / "demo_project" / "images", projects["demo5"] / "images")
    timers = _TimerLog()

    launches = {name: {} for name in PATHS}
    for pipeline, (needed, runs) in PATHS.items():
        _lib.reset_launch_counts()
        cpu_checks = []
        for proj_name, strategy, cfg, dim, compare_cpu in runs:
            proj = projects[proj_name]
            names = sorted(p.name for p in (proj / "images").iterdir())
            outs = WORK / "out" / f"{pipeline}_{proj_name}"
            t0 = time.perf_counter()
            out_dir = _run(pipeline, proj, strategy, configs[cfg], outs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_pairs = len((out_dir / "pairs.txt").read_text().splitlines())
            if strategy == "bruteforce" and n_pairs != len(names) * (len(names) - 1) // 2:
                _fail(f"bruteforce gave {n_pairs} pairs")
            summary, n_verified = _check_outputs(out_dir, names, n_pairs, dim)
            if proj_name == "synthetic16" and pipeline != "superpoint+superglue":
                # random SuperGlue weights mix the keypoint positions into the
                # descriptors, so only the other matchers find the shift
                summary += "; " + _check_shifted(out_dir, names)
            if pipeline == "sift+kornia_matcher" and n_verified == 0:
                _fail("sift+kornia_matcher verified no pair of the demo images")
            stages = timers.lines[-1].split("] ", 2)[-1] if timers.lines else "no timer line"
            print(f"[main] {pipeline} on {proj_name} ({strategy}): {summary}; run_matching "
                  f"{wall:.2f} s; stages {stages} [{card}]", flush=True)
            if compare_cpu:
                cpu_checks.append((proj, strategy, out_dir, outs))
        launches[pipeline] = dict(_lib.LAUNCHES)
        print(f"[main] {pipeline}: kernel launches {launches[pipeline]}", flush=True)
        missing = [k for k in needed if launches[pipeline][k] == 0]
        if missing:
            _fail(f"{pipeline}: kernels {missing} of its path were never launched")
        for proj, strategy, out_dir, outs in cpu_checks:
            # the same run on the CPU: integer descriptors make the
            # nearest-neighbour arithmetic exact, so the raw matches of the
            # kernel route and of the dense CPU route are equal
            cpu_dir = _run(pipeline, proj, strategy, configs["cpu"], outs.with_name(outs.name + "_cpu"))
            gpu_sets, cpu_sets = _raw_match_sets(out_dir), _raw_match_sets(cpu_dir)
            if gpu_sets.keys() != cpu_sets.keys():
                _fail(f"{pipeline}: the card and the CPU matched other pairs")
            differ = [p for p in gpu_sets if gpu_sets[p] != cpu_sets[p]]
            if differ:
                _fail(f"{pipeline}: raw matches of {differ[:3]} differ between the card and the CPU")
            counts = sorted(len(v) for v in gpu_sets.values())
            print(f"[main] {pipeline}: raw matches equal on the card and the CPU for all "
                  f"{len(gpu_sets)} pairs ({counts[0]}-{counts[-1]} per pair) [{card}]", flush=True)
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
         "replaces": KERNELS[name][1],
         "launches": sum(counts[name] for counts in launches.values()),
         "launches_by_path": {path: counts[name] for path, counts in launches.items()
                              if counts[name]},
         **report[name], **({"note": NO_CALLER[name]} if name in NO_CALLER else {})}
        for name in KERNELS
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
