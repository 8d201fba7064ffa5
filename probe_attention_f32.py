"""Where the time of the float32 attention kernels goes, on one GPU.

    python3 probe_attention_f32.py TREE [VARIANT ...]

TREE is a checkout of this repository (this one, or another commit unpacked
with ``git archive``). Each VARIANT is a copy of TREE's ``src`` under
``build/probe_attention_f32/<variant>/`` with one change to the float32
attention core (``csrc/attention_f32_sm90.cuh``), built and measured in a
process of its own:

- ``plain``: the core as it is;
- ``no_pv``: the P V products left out (S, the softmax and P's TF32 split
  stay);
- ``no_s``: the S = Q K^T products left out (S is zero; the softmax, the
  split and P V stay);
- ``no_softmax``: the softmax left out (S's accumulator is split as it is and
  no rescale happens; both products stay);
- ``no_split`` (a core that splits its operands in the block): the split of
  each raw K and V tile into the operand slots left out;
- ``cycles`` (the same core): SM clocks (``clock64``) by step of the tile
  loop, summed over one block (block 264, a block of the third wave, of the
  sixth launch of a source's kernels) and printed by the producer's thread 0
  and each consumer warpgroup's first thread, one line each.

The default is all of them that apply to TREE's core. Only ``plain`` gives
right outputs (its error against the plain PyTorch version is printed); the
others time parts of the work. Each cut variant patches the lines of the
serial core (a split pass of separate launches; consumers that wait for S,
run the softmax, then P V) or of the overlapped one (the split in the
block; S issued beside P V of the tile before); where neither is found it
stops with an error.

For each variant and each shape of ``chip_smoke.py``'s float32 attention
checks (kernel 1 at LightGlue's (16, 4, 2048, 64) and SuperGlue's
(16, 4, 4096, 64), kernel 6 at (16, 4, 2048 / 4096, 64), kernel 1 at
LighterGlue's (16, 1, 4096, 96), the same seeded inputs and partial masks)
it prints one JSON line: the wrapper's time (``chip_smoke._time_ms``: runs of
back-to-back calls between CUDA events), the device time of each
``__global__`` function the call launches (``torch.profiler`` over 20 calls,
per call), and ptxas' registers and spills of the float32 attention entries.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "probe_attention_f32"
CORE = Path("deep_image_matching_tpu_torch") / "csrc" / "attention_f32_sm90.cuh"

# variant -> its patch for each form of the core, tried in turn: the serial
# core (a split pass before the kernel; S, then the softmax, then P V) and the
# overlapped one (the split in the block; S issued beside P V of the tile
# before); a patch is a list of (text, its replacement)
PATCHES = {
    "plain": [[]],
    "no_pv": [
        [("      mma_o(o, pl + 4 * j, dvh);\n      mma_o(o, ph + 4 * j, dvl);\n"
          "      mma_o(o, ph + 4 * j, dvh);\n", "      (void)dvh;\n      (void)dvl;\n")],
        [("    mma_o(o, pl + 4 * j, dvh);\n    mma_o(o, ph + 4 * j, dvl);\n"
          "    mma_o(o, ph + 4 * j, dvh);\n", "    (void)dvh;\n    (void)dvl;\n")]],
    "no_s": [
        [("    float s[BK / 2];\n", "    float s[BK / 2] = {};\n"),
         ("      mma_s(s, dql[h] + off, dkh, kk);\n      mma_s(s, dqh[h] + off, dkl, 1);\n"
          "      mma_s(s, dqh[h] + off, dkh, 1);\n", "      (void)dkh;\n      (void)dkl;\n")],
        [("  float s[BK / 2];  ", "  float s[BK / 2] = {};  "),
         ("    mma_s(s, ql + 4 * kk, dkh, kk);\n    mma_s(s, qh + 4 * kk, dkl, 1);\n"
          "    mma_s(s, qh + 4 * kk, dkh, 1);\n", "    (void)dkh;\n    (void)dkl;\n")]],
    "no_softmax": [
        [("    softmax_tile<BIDIR>(s, sbias + stage * BK, info > 0, c, qb, C, m, l, corr);\n",
          "    corr[0] = corr[1] = 1.f;\n")]],
    # the overlapped core only: the producer's split of each raw tile left out
    "no_split": [
        [("    split_k<D>(sm, raw, stage, ptid);\n", ""),
         ("    split_v<D>(sm, raw, vs, ptid);\n", "")]],
    # the overlapped core only: SM clocks (clock64) summed over the tile loop by
    # step, printed by block 264 (a block of the third wave) of the sixth launch
    # of a source's kernels for the producer's thread 0 and each consumer
    # warpgroup's first thread
    "cycles": [[
        ("namespace attn_f32 {\n",
         "#include <cstdio>\nnamespace attn_f32 {\n"
         "static __device__ int probe_prints, probe_launches;\n"
         "#define PROBE_T(k) { const long long n_ = clock64(); pc[k] += n_ - pt; pt = n_; }\n"
         "#define PROBE_PRINT(who, n) if (blockIdx.x == 264 && "
         "atomicAdd(&probe_launches, 0) == 6 && atomicAdd(&probe_prints, 1) < 3) "
         "printf(\"cycles %s tiles %lld steps %lld %lld %lld %lld %lld %lld %lld %lld\\n\", who, "
         "pc[8], pc[0], pc[1], pc[2], pc[3], pc[4], pc[5], pc[6], pc[7]);\n"),
        ("  for (int i = 0; t < ntiles; ++i) {\n    const int tn = tiles.next(t + 1);\n",
         "  long long pc[9] = {}, pt = clock64();\n"
         "  for (int i = 0; t < ntiles; ++i) {\n    ++pc[8];\n"
         "    const int tn = tiles.next(t + 1);\n"),
        ("    mbar_wait(bar.raw + 8 * raw, raw_phase);\n"
         "    mbar_wait(bar.kempty + 8 * stage, phase ^ 1);\n"
         "    split_k<D>(sm, raw, stage, ptid);\n",
         "    PROBE_T(0);\n"
         "    mbar_wait(bar.raw + 8 * raw, raw_phase);\n"
         "    PROBE_T(1);\n"
         "    mbar_wait(bar.kempty + 8 * stage, phase ^ 1);\n"
         "    PROBE_T(2);\n"
         "    split_k<D>(sm, raw, stage, ptid);\n"
         "    PROBE_T(3);\n"),
        ("    mbar_wait(bar.vempty + 8 * vs, vphase ^ 1);\n"
         "    split_v<D>(sm, raw, vs, ptid);\n",
         "    PROBE_T(4);\n"
         "    mbar_wait(bar.vempty + 8 * vs, vphase ^ 1);\n"
         "    PROBE_T(5);\n"
         "    split_v<D>(sm, raw, vs, ptid);\n"
         "    PROBE_T(6);\n"),
        ("    asm volatile(\"bar.sync 1, %0;\" ::\"n\"(PRODUCERS) : \"memory\");"
         "  // raw slot read through\n",
         "    asm volatile(\"bar.sync 1, %0;\" ::\"n\"(PRODUCERS) : \"memory\");\n"
         "    PROBE_T(7);\n"),
        ("  // a query tile whose rows are all masked: zeros, nothing else\n",
         "  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&probe_launches, 1);\n"
         "  // a query tile whose rows are all masked: zeros, nothing else\n"),
        ("  // the end marker\n",
         "  if (ptid == 0) PROBE_PRINT(\"producer: lookup raw_wait kempty_wait split_k k_rest "
         "vempty_wait split_v v_rest\", 0);\n  // the end marker\n"),
        ("  while (true) {\n    mbar_wait(bar.kfull + 8 * stage, phase);\n",
         "  long long pc[9] = {}, pt = clock64();\n"
         "  while (true) {\n    ++pc[8];\n    mbar_wait(bar.kfull + 8 * stage, phase);\n"
         "    PROBE_T(0);\n"),
        ("    mbar_wait(bar.vfull + 8 * vs, vphase);\n    wg_fence();\n",
         "    mbar_wait(bar.vfull + 8 * vs, vphase);\n    PROBE_T(1);\n    wg_fence();\n"),
        ("    wg_wait<1>();  // S(t) is done, P V(t - 1) may still run\n",
         "    PROBE_T(2);\n    wg_wait<1>();  // S(t) is done, P V(t - 1) may still run\n"
         "    PROBE_T(3);\n"),
        ("    mbar_arrive(bar.kempty + 8 * stage);\n    wg_wait<0>();\n",
         "    mbar_arrive(bar.kempty + 8 * stage);\n    PROBE_T(4);\n    wg_wait<0>();\n"
         "    PROBE_T(5);\n"),
        ("    split_p(s, ph, pl);\n    if (++stage == KSTAGES) {\n",
         "    split_p(s, ph, pl);\n    PROBE_T(6);\n    if (++stage == KSTAGES) {\n"),
        ("  mbar_wait(bar.vfull + 8 * vs, vphase);\n  wg_fence();\n",
         "  if ((threadIdx.x & 127) == 0) PROBE_PRINT(\"consumer: kfull_wait vfull_wait issue "
         "s_wait softmax pv_wait rescale_split_p -\", 0);\n"
         "  mbar_wait(bar.vfull + 8 * vs, vphase);\n  wg_fence();\n"),
    ]],
}
ENTRIES = ("attention_f32_sm90", "bidir_attention_f32_sm90", "attention_hd96_f32_sm90")


def make_variant(tree: Path, variant: str) -> Path:
    """A copy of ``tree``'s src with ``variant``'s patch applied; its root."""
    dst = OUT / variant
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(tree / "src", dst / "src",
                    ignore=shutil.ignore_patterns("__pycache__", "*.egg-info"))
    core = dst / "src" / CORE
    text = core.read_text()
    for patch in PATCHES[variant]:
        if all(text.count(old) == 1 for old, _ in patch):
            for old, new in patch:
                text = text.replace(old, new)
            break
    else:
        raise SystemExit(f"variant {variant}: no patch applies to {tree / 'src' / CORE}")
    core.write_text(text)
    return dst


def _short(key: str) -> str:
    """A kernel's name without its namespace, return type and arguments."""
    key = key.replace("(anonymous namespace)::", "").replace("void ", "")
    return re.split(r"[(<]", key, maxsplit=1)[0].strip()


def _device(torch, fn, reps: int = 20) -> dict:
    """Device milliseconds per call of ``fn`` by ``__global__`` function."""
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ms, _, key in chip_smoke._device_busy(prof)[2]:
        out[_short(key)] = out.get(_short(key), 0.0) + ms / reps
    return out


def cases(torch, dev):
    """(name, call, plain call, valid-row masks) of each shape, on the inputs
    of chip_smoke.py's float32 attention checks."""
    import chip_smoke
    from deep_image_matching_tpu_torch.ops.attention import attention_reference, fused_attention
    from deep_image_matching_tpu_torch.ops.bidir_attention import (
        bidir_cross_attention, bidir_cross_attention_reference)

    gen = torch.Generator().manual_seed(21)
    B, H, d = 16, 4, 64
    for T in (2048, 4096):
        if T == 2048:
            q, k, v = (torch.randn(B, H, T, d, generator=gen).mul(s).to(dev)
                       for s in (2.0, 2.0, 1.0))
        else:
            q, k, v = (torch.randn(B, T, H * d, generator=gen).mul(s).reshape(B, T, d, H)
                       .permute(0, 3, 1, 2).contiguous().to(dev) for s in (2.0, 2.0, 1.0))
        qm, km = chip_smoke._masks(torch, gen, B, T, dev), chip_smoke._masks(torch, gen, B, T, dev)
        yield (f"attention_f32 {T}", lambda: fused_attention(q, k, v, qm, km, d ** -0.5),
               lambda: attention_reference(q, k, v, km, d ** -0.5), [qm])
    gen = torch.Generator().manual_seed(22)
    for N in (2048, 4096):
        qk0, qk1 = (torch.randn(B, H, N, d, generator=gen).mul(2.0).to(dev) for _ in range(2))
        v0, v1 = (torch.randn(B, H, N, d, generator=gen).to(dev) for _ in range(2))
        m0, m1 = chip_smoke._masks(torch, gen, B, N, dev), chip_smoke._masks(torch, gen, B, N, dev)
        args = (qk0, qk1, v0, v1, m0, m1)
        yield (f"bidir_attention_f32 {N}", lambda: bidir_cross_attention(*args),
               lambda: bidir_cross_attention_reference(*args), [m0, m1])
    gen = torch.Generator().manual_seed(24)
    B, H, N, d = 16, 1, 4096, 96
    q, k, v = (torch.randn(B, H, N, d, generator=gen).mul(s).to(dev) for s in (2.0, 2.0, 1.0))
    qm, km = chip_smoke._masks(torch, gen, B, N, dev), chip_smoke._masks(torch, gen, B, N, dev)
    yield ("attention_hd96_f32 4096", lambda: fused_attention(q, k, v, qm, km, d ** -0.5),
           lambda: attention_reference(q, k, v, km, d ** -0.5), [qm])


def measure(src: str) -> dict:
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = {"src": src, "card": card}
    for name, call, plain, masks in cases(torch, dev):
        got, ref = call(), plain()
        got, ref = (got,) if torch.is_tensor(got) else got, (ref,) if torch.is_tensor(ref) else ref
        err = max(chip_smoke._rel_err(g, r, m[:, None, :, None].expand_as(g))
                  for g, r, m in zip(got, ref, masks))
        del got, ref
        out[name] = {"err": err, "call_ms": chip_smoke._time_ms(call),
                     "device_ms": _device(torch, call)}
        torch.cuda.empty_cache()
    from deep_image_matching_tpu_torch.ops import _lib

    out["ptxas"] = {e: chip_smoke._ptxas(e) for e in ENTRIES}
    log = _lib.BUILD_DIR / "ptxas.log"
    out["ptxas_warnings"] = [line.strip() for line in log.read_text().splitlines()
                             if "warning" in line.lower()] if log.exists() else []
    return out


def main() -> None:
    if sys.argv[1:2] == ["--measure"]:
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return
    tree = Path(sys.argv[1]).resolve()
    variants = sys.argv[2:] or list(PATCHES)
    if not sys.argv[2:] and "split_k<D>" not in (tree / "src" / CORE).read_text():
        variants = [v for v in variants if v not in ("no_split", "cycles")]
    for variant in variants:
        src = make_variant(tree, variant) / "src"
        res = subprocess.run([sys.executable, __file__, "--measure", str(src)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit(f"{variant} failed:\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        *lines, last = res.stdout.strip().splitlines()
        for line in lines:
            print(f"{variant}: {line}", flush=True)
        print(json.dumps({"variant": variant, **json.loads(last)}), flush=True)


if __name__ == "__main__":
    main()
