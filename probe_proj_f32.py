"""Where the time of the float32 projection kernels goes, on one GPU.

    python3 probe_proj_f32.py TREE [TREE ...] [--variants VARIANT ...]

Each TREE is a checkout of this repository (this one, or another commit
unpacked with ``git archive``). For each tree and VARIANT the probe copies
the tree's ``csrc/ffn.cu``, ``csrc/qkv.cu`` and ``csrc/sm90_common.cuh``
under ``build/probe_proj_f32/<tree>-<variant>/``, wraps the variant's cut
in ``#ifdef PROBE_<VARIANT>``, and builds the two sources with its own
``nvcc`` and ``-DPROBE_<VARIANT>`` into a library of its own (all builds
started together), which it loads with ``ctypes`` and calls through the C
entries ``dim_ffn_f32`` and ``dim_qkv_rotary_f32``. The package's own build
(``ops/_lib.py``) never sees these flags. The variants:

- ``plain``: the kernels as they are;
- ``w_once`` (kernel 2): the producer loads each ring stage's weight chunk
  only on the ring's first round, then re-arms the stage's full barrier
  without a load: the weights' L2 reads left out;
- ``no_drain`` (kernels 2 and 10): one ``wgmma.wait_group 0`` a product
  instead of one a 32-deep stage, each stage released one stage late
  (race-prone: timing only);
- ``no_epilogue`` (kernel 10): the accumulators are not stored; their sum is
  written where it equals an impossible value, so they stay live;
- ``split_once`` (kernel 10): each x fragment is read and split on the hi
  stage only and reused on the lo stage;
- of the redesigned kernels: ``hi_only`` (kernel 2: one TF32 product, hi.hi,
  a step instead of three), ``no_split`` (kernel 2: the A fragments loaded
  but not split), ``no_act`` (kernel 2: h written as the activation, no
  LayerNorm, GELU or relu arithmetic), ``no_p2`` (kernel 2: the second
  product's tensor-core work left out) and ``no_store`` (kernel 10: the
  outputs computed but not stored).

The default is all of them. A variant whose cut is not found in a tree's
sources (a redesigned kernel) is skipped for that tree, with a line that
says so. Only ``plain`` gives right outputs; the others time parts of the
work.

Each (tree, variant) is measured in a process of its own, trees in turn for
each variant, at the shapes of ``chip_smoke.py``'s float32 checks (kernel 2
at (16, 2048, 256) ln_gelu and (16, 4096, 256) relu; kernel 10 at (65536,
256) self (3 sections, rotary) and cross (2 sections)), from the same seeded
inputs. Each prints one JSON line: per shape, the error against the plain
PyTorch version (|err| / max|out|), a digest of the output's bytes (equal
digests: equal outputs bit for bit), the time between CUDA events
(``chip_smoke._time_ms``: runs of back-to-back calls) and the kernel's
device time under ``torch.profiler`` (20 calls); and ptxas' registers,
spills, warnings (a serialized ``wgmma`` pipeline, for one) and notes of
``warpgroup.arrive`` it injected, of ``ffn_f32_sm90`` and
``qkv_f32_sm90``. The last line is a table
of the device times, tree by tree and variant by variant.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "probe_proj_f32"
CSRC = Path("src") / "deep_image_matching_tpu_torch" / "csrc"
FILES = ("ffn.cu", "qkv.cu", "sm90_common.cuh")
SOURCES = ("ffn.cu", "qkv.cu")
ENTRIES = ("ffn_f32_sm90", "qkv_f32_sm90")

# variant -> its cuts for each form of the sources, tried in turn (the
# first split-TF32 kernels, then the redesigned ones): lists of (file, text, its replacement),
# each text found once in the file; the replacement is compiled under
# #ifdef PROBE_<VARIANT>
PATCHES = {
    "plain": [[]],
    "w_once": [[
        ("ffn.cu",
         "          mbar_arrive_tx(full, W1_BYTES);\n"
         "          tma_load_2d(dst, &w1map, full, c * KC, part * D2);\n"
         "          tma_load_2d(dst + W1_BYTES / 2, &w1map, full, c * KC, part * D2 + D);\n",
         "          if (c == 0) {\n"
         "            mbar_arrive_tx(full, W1_BYTES);\n"
         "            tma_load_2d(dst, &w1map, full, c * KC, part * D2);\n"
         "            tma_load_2d(dst + W1_BYTES / 2, &w1map, full, c * KC, part * D2 + D);\n"
         "          } else {\n"
         "            mbar_arrive(full);\n"
         "          }\n"),
        ("ffn.cu",
         "        mbar_arrive_tx(v_full + 8 * vs, W2_BYTES);\n"
         "        tma_load_2d(base + OFF_W2 + vs * W2_BYTES, &w2map, v_full + 8 * vs, (t / 2) * KC,\n"
         "                    (t % 2) * D);\n",
         "        if (t < 2) {\n"
         "          mbar_arrive_tx(v_full + 8 * vs, W2_BYTES);\n"
         "          tma_load_2d(base + OFF_W2 + vs * W2_BYTES, &w2map, v_full + 8 * vs, (t / 2) * KC,\n"
         "                      (t % 2) * D);\n"
         "        } else {\n"
         "          mbar_arrive(v_full + 8 * vs);\n"
         "        }\n"),
    ], [
        ("ffn.cu",
         "          mbar_arrive_tx(full, W1_BYTES);\n"
         "          tma_load_2d(dst, &w1map, full, c * KC, part * D2);\n"
         "          tma_load_2d(dst + W1_BYTES / 2, &w1map, full, c * KC, part * D2 + D);\n",
         "          if (2 * c + part < W1_STAGES) {\n"
         "            mbar_arrive_tx(full, W1_BYTES);\n"
         "            tma_load_2d(dst, &w1map, full, c * KC, part * D2);\n"
         "            tma_load_2d(dst + W1_BYTES / 2, &w1map, full, c * KC, part * D2 + D);\n"
         "          } else {\n"
         "            mbar_arrive(full);\n"
         "          }\n"),
        ("ffn.cu",
         "        mbar_arrive_tx(v_full + 8 * v.stage, W2_BYTES);\n"
         "        tma_load_2d(base + OFF_W2 + v.stage * W2_BYTES, &w2map, v_full + 8 * v.stage,\n"
         "                    (t / 2) * KC, (t % 2) * D);\n",
         "        if (t < 2) {\n"
         "          mbar_arrive_tx(v_full + 8 * v.stage, W2_BYTES);\n"
         "          tma_load_2d(base + OFF_W2 + v.stage * W2_BYTES, &w2map, v_full + 8 * v.stage,\n"
         "                      (t / 2) * KC, (t % 2) * D);\n"
         "        } else {\n"
         "          mbar_arrive(v_full + 8 * v.stage);\n"
         "        }\n"),
    ]],
    "no_drain": [[
        # kernel 2, the first product
        ("ffn.cu",
         "  float h[128];\n  uint32_t fh[2][4], fl[2][4];\n",
         "  float h[128];\n  uint32_t fh[2][4], fl[2][4];\n  int wprev = -1;\n"),
        ("ffn.cu",
         "      wg_wait<0>();\n      fence_regs(h);\n      fence_regs(fh[1]);\n"
         "      fence_regs(fl[1]);\n      mbar_arrive(w_empty + 8 * ws);\n",
         "      if (wprev >= 0) mbar_arrive(w_empty + 8 * wprev);\n      wprev = ws;\n"),
        ("ffn.cu",
         "    mbar_arrive(a_empty + 8 * as);\n    if (++as == 2) {\n      as = 0;\n"
         "      aph ^= 1;\n    }\n  }\n",
         "    mbar_arrive(a_empty + 8 * as);\n    if (++as == 2) {\n      as = 0;\n"
         "      aph ^= 1;\n    }\n  }\n  wg_wait<0>();\n  fence_regs(h);\n"
         "  mbar_arrive(w_empty + 8 * wprev);\n"),
        # kernel 2, the second product
        ("ffn.cu",
         "  float o[64];\n  int vs = 0;\n",
         "  float o[64];\n  int vs = 0, vprev = -1;\n"),
        ("ffn.cu",
         "    wg_wait<0>();\n    fence_regs(o);\n    fence_regs(fh[1]);\n    fence_regs(fl[1]);\n"
         "    mbar_arrive(v_empty + 8 * vs);\n",
         "    if (vprev >= 0) mbar_arrive(v_empty + 8 * vprev);\n    vprev = vs;\n"),
        ("ffn.cu",
         "  // out = x + (o + b2), rows past the end not stored\n",
         "  wg_wait<0>();\n  fence_regs(o);\n  mbar_arrive(v_empty + 8 * vprev);\n"),
        # kernel 10
        ("qkv.cu",
         "    float acc[64];\n#pragma unroll 1\n    for (int t = 0; t < 2 * NCH; ++t) {\n",
         "    float acc[64];\n    int prev = -1;\n#pragma unroll 1\n"
         "    for (int t = 0; t < 2 * NCH; ++t) {\n"),
        ("qkv.cu",
         "      wg_wait<0>();\n      fence_regs(acc);\n      fence_regs(fh[1]);\n"
         "      fence_regs(fl[1]);\n      mbar_arrive(bar_empty + 8 * stage);\n",
         "      if (prev >= 0) mbar_arrive(bar_empty + 8 * prev);\n      prev = stage;\n"),
        ("qkv.cu",
         "    // + bias, the rotary, stored into the (B, H, N, 64) layout\n",
         "    wg_wait<0>();\n    fence_regs(acc);\n    mbar_arrive(bar_empty + 8 * prev);\n"),
    ]],
    "no_epilogue": [[
        ("qkv.cu",
         "    // + bias, the rotary, stored into the (B, H, N, 64) layout\n",
         "    {\n      float s_ = 0.f;\n#pragma unroll\n      for (int i = 0; i < 64; ++i) s_ += acc[i];\n"
         "      if (s_ == 1234.5f) out0[tid] = s_;\n    }\n    continue;\n"),
    ]],
    "split_once": [[
        ("qkv.cu",
         "#pragma unroll\n        for (int i = 0; i < 4; ++i) split_tf32(xv[i], fh[kk & 1][i], "
         "fl[kk & 1][i]);\n",
         "        if (part == 0) {\n#pragma unroll\n"
         "          for (int i = 0; i < 4; ++i) split_tf32(xv[i], fh[kk & 1][i], fl[kk & 1][i]);\n"
         "        }\n"),
    ]],
    # the redesigned kernel 2 only: one TF32 product (hi.hi) a step instead
    # of three
    "hi_only": [[
        ("ffn.cu",
         "        if (part == 0) {\n"
         "          wgmma_tf32_n256_rs(acc, fl[kk], db + 2 * kk, ch | kk);\n"
         "          wgmma_tf32_n256_rs(acc, fh[kk], db + 2 * kk, 1);\n"
         "        } else {\n"
         "          wgmma_tf32_n256_rs(acc, fh[kk], db + 2 * kk, 1);\n"
         "        }\n",
         "        if (part == 0) wgmma_tf32_n256_rs(acc, fh[kk], db + 2 * kk, ch | kk);\n"),
        ("ffn.cu",
         "        if (part == 0) {\n"
         "          wgmma_tf32_n128_rs(acc, fl[kk], db + 2 * kk, ch | kk);\n"
         "          wgmma_tf32_n128_rs(acc, fh[kk], db + 2 * kk, 1);\n"
         "        } else {\n"
         "          wgmma_tf32_n128_rs(acc, fh[kk], db + 2 * kk, 1);\n"
         "        }\n",
         "        if (part == 0) wgmma_tf32_n128_rs(acc, fh[kk], db + 2 * kk, ch | kk);\n"),
    ]],
    # the redesigned kernel 2 only: the A fragments loaded but not split
    "no_split": [[
        ("ffn.cu",
         "  for (int i = 0; i < 4; ++i) split_tf32(x[i], hi[i], lo[i]);\n",
         "  for (int i = 0; i < 4; ++i) hi[i] = lo[i] = __float_as_uint(x[i]);\n"),
    ]],
    # the redesigned kernel 2 only: the LayerNorm's and the GELU's (or the
    # relu's) arithmetic left out of the activation (h is written as it is)
    "no_act": [[
        ("ffn.cu",
         "        if (MODE == 0) {\n"
         "          const float hn = (hv - mu[r]) * rstd[r] * sg[col + e] + sbeta[col + e];\n",
         "        if (MODE == 2) {\n"
         "          const float hn = (hv - mu[r]) * rstd[r] * sg[col + e] + sbeta[col + e];\n"),
        ("ffn.cu",
         "          v[e] = fmaxf(hv, 0.f);\n",
         "          v[e] = hv;\n"),
    ]],
    # the redesigned kernel 2 only: the second product's tensor-core work
    # left out (its stages are still waited for and released)
    "no_p2": [[
        ("ffn.cu",
         "        if (part == 0) {\n"
         "          wgmma_tf32_n128_rs(acc, fl[kk], db + 2 * kk, ch | kk);\n"
         "          wgmma_tf32_n128_rs(acc, fh[kk], db + 2 * kk, 1);\n"
         "        } else {\n"
         "          wgmma_tf32_n128_rs(acc, fh[kk], db + 2 * kk, 1);\n"
         "        }\n",
         "        (void)db;\n"),
    ]],
    # the redesigned kernel 10 only: the outputs computed but not stored (one
    # element written where it equals an impossible value)
    "no_store": [[
        ("qkv.cu",
         "      __stcs(reinterpret_cast<float2*>(ep.o + cx.rowoff[r] + h * cx.head + d), v);\n",
         "      if (v.x == 1234.5f) ep.o[0] = v.y;\n"),
    ]],
    # the redesigned kernel 10 only: the x chunks loaded on the ring's first
    # round only (`x_once`), or the weight chunks (`w_once_qkv`): their L2
    # reads left out
    "x_once": [[
        ("qkv.cu",
         "        mbar_arrive_tx(full, STAGE_BYTES);\n"
         "        tma_load_2d(dst, &xmap, full, k0, row0);\n",
         "        mbar_arrive_tx(full, t < STAGES ? STAGE_BYTES : STAGE_BYTES - X_BYTES);\n"
         "        if (t < STAGES) tma_load_2d(dst, &xmap, full, k0, row0);\n"),
    ]],
    "w_once_qkv": [[
        ("qkv.cu",
         "        mbar_arrive_tx(full, STAGE_BYTES);\n"
         "        tma_load_2d(dst, &xmap, full, k0, row0);\n"
         "        tma_load_2d(dst + X_BYTES, &wmap, full, k0, w0);\n"
         "        tma_load_2d(dst + X_BYTES + W_BYTES, &wmap, full, k0, sections * D + w0);\n",
         "        mbar_arrive_tx(full, t < STAGES ? STAGE_BYTES : X_BYTES);\n"
         "        tma_load_2d(dst, &xmap, full, k0, row0);\n"
         "        if (t < STAGES) {\n"
         "          tma_load_2d(dst + X_BYTES, &wmap, full, k0, w0);\n"
         "          tma_load_2d(dst + X_BYTES + W_BYTES, &wmap, full, k0, sections * D + w0);\n"
         "        }\n"),
    ]],
    # the redesigned kernel 2 only: four steps in flight instead of three
    "inflight4": [[
        ("ffn.cu",
         "      wg_wait<2>();\n",
         "      wg_wait<3>();\n"),
        ("ffn.cu",
         "      if (kk == 1 && prev >= 0) release(prev);\n",
         "      if (kk == 2 && prev >= 0) release(prev);\n"),
    ]],
    # the redesigned kernel 2 only: the outputs computed but not stored
    "no_store_ffn": [[
        ("ffn.cu",
         "        __stcs(reinterpret_cast<float2*>(out + static_cast<size_t>(row) * D + col),\n"
         "               make_float2(xv.x + (o[4 * j + 2 * r] + sb2[col]),\n"
         "                           xv.y + (o[4 * j + 2 * r + 1] + sb2[col + 1])));\n",
         "        if (xv.x + o[4 * j + 2 * r] == 1234.5f) out[0] = xv.y + o[4 * j + 2 * r + 1];\n"),
    ]],
    # the redesigned kernel 10 only: every store kept, but into a 256 KB
    # window of each output (the rows' pattern wrapped), so that the writes
    # stay in L2
    "store_l2": [[
        ("qkv.cu",
         "      __stcs(reinterpret_cast<float2*>(ep.o + cx.rowoff[r] + h * cx.head + d), v);\n",
         "      __stcs(reinterpret_cast<float2*>(ep.o + (cx.rowoff[r] & 0xFFFF) + h * HD + d), v);\n"),
    ]],
}


def _flag(variant: str) -> str:
    return f"PROBE_{variant.upper()}"


def make_variant(tree: Path, variant: str, tag: str):
    """A patched copy of ``tree``'s three sources; its directory, or None
    where no form of the variant's cuts is found, each once in its file."""
    texts = {f: (tree / CSRC / f).read_text() for f in FILES}
    for cuts in PATCHES[variant]:
        if all(texts[f].count(old) == 1 for f, old, _ in cuts):
            break
    else:
        return None
    for f, old, new in cuts:
        texts[f] = texts[f].replace(old, f"#ifdef {_flag(variant)}\n{new}#else\n{old}#endif\n")
    dst = OUT / f"{tag}-{variant}"
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    for f, text in texts.items():
        (dst / f).write_text(text)
    return dst


def build_all(jobs) -> None:
    """Build every (directory, variant) of ``jobs`` into ``<dir>/libprobe.so``
    with one nvcc per source, all started together; ptxas' report in
    ``<dir>/ptxas.log``."""
    sys.path.insert(0, str(ROOT / "src"))
    from deep_image_matching_tpu_torch.ops import _lib

    nvcc = _lib._nvcc()
    flags = list(_lib.NVCC_FLAGS)
    procs = []
    for d, variant in jobs:
        for src in SOURCES:
            obj = d / f"{Path(src).stem}.o"
            cmd = [nvcc, *flags, f"-D{_flag(variant)}", "-c", "-o", str(obj), str(d / src)]
            procs.append((d, src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)))
    logs = {}
    for d, src, p in procs:
        out = p.communicate()[0]
        logs.setdefault(d, []).append(out)
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on {d / src}:\n{out[-4000:]}")
    for d, _ in jobs:
        (d / "ptxas.log").write_text("".join(logs[d]))
        res = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
                              str(d / "libprobe.so"), *(str(d / f"{Path(s).stem}.o")
                                                       for s in SOURCES)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit(f"link failed in {d}:\n{res.stderr[-4000:]}")


def ptxas(log: Path) -> dict:
    """Registers and spill bytes of the two float32 entries."""
    out, current = {}, None
    for line in log.read_text().splitlines():
        if "Compiling entry function '" in line:
            fn = line.split("'")[1]
            current = next((e for e in ENTRIES if e in fn), None)
            if current:
                current = f"{current}:{fn}"
                out[current] = {}
        elif current and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out[current].update(spill_bytes=nums[1] + nums[2])
        elif current and "Used " in line and " registers" in line:
            out[current]["registers"] = int(line.split("Used ")[1].split()[0])
    return out


def _digest(ts) -> str:
    """The first 16 hex digits of the SHA-1 of the tensors' bytes."""
    h = hashlib.sha1()
    for t in ts:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def cases(torch, lib, dev):
    """(name, kernel call, plain call, entry name) of each shape, on the
    inputs of chip_smoke.py's check_ffn_f32 and check_qkv_f32."""
    from deep_image_matching_tpu_torch.ops import _lib
    from deep_image_matching_tpu_torch.ops.ffn import ffn_reference
    from deep_image_matching_tpu_torch.ops.qkv import proj_rotary_reference

    P = ctypes.c_void_p
    stream = lambda: P(torch.cuda.current_stream().cuda_stream)  # noqa: E731
    gen = torch.Generator().manual_seed(23)
    D = 256

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen) * s).to(dev)

    w1, w2 = rnd(2 * D, 2 * D, s=(2 * D) ** -0.5), rnd(D, 2 * D, s=(2 * D) ** -0.5)
    b1, beta, b2 = rnd(2 * D, s=0.1), rnd(2 * D, s=0.1), rnd(D, s=0.1)
    g = (1.0 + 0.1 * torch.randn(2 * D, generator=gen)).to(dev)
    w1s, w2s = _lib.tf32_split(w1), _lib.tf32_split(w2)
    for mode, K in (("ln_gelu", 2048), ("relu", 4096)):
        x, msg = rnd(16, K, D), rnd(16, K, D)
        out = torch.empty_like(x)

        def call(x=x, msg=msg, out=out, m=int(mode == "relu")):
            rc = lib.dim_ffn_f32(0, x.data_ptr(), msg.data_ptr(), w1s.data_ptr(), b1.data_ptr(),
                                 g.data_ptr(), beta.data_ptr(), w2s.data_ptr(), b2.data_ptr(),
                                 out.data_ptr(), x.shape[0] * x.shape[1], m, stream())
            if rc:
                raise RuntimeError(f"dim_ffn_f32: CUDA error {rc}")
            return (out,)

        yield (f"ffn_f32 {mode} (16, {K}, 256)", call,
               lambda x=x, msg=msg, mode=mode: (ffn_reference(x, msg, w1, b1, g, beta, w2, b2,
                                                              mode),), "ffn_f32_sm90")
        del x, msg
    gen = torch.Generator().manual_seed(24)
    B, N, D, H = 16, 4096, 256, 4
    x = torch.randn(B, N, D, generator=gen).to(dev)
    ang = torch.rand(B, N, 32, generator=gen) * 6.3
    cos = torch.repeat_interleave(torch.cos(ang), 2, -1).to(dev)
    sin = torch.repeat_interleave(torch.sin(ang), 2, -1).to(dev)
    for sections, rot in ((3, (0, 1)), (2, ())):
        w = (torch.randn(sections * D, D, generator=gen) / 16).to(dev)
        b = (0.1 * torch.randn(sections * D, generator=gen)).to(dev)
        ws = _lib.tf32_split(w)
        outs = [torch.empty(B, H, N, 64, device=dev) for _ in range(sections)]

        def call(w=w, b=b, ws=ws, outs=outs, sections=sections, rot=rot):
            ptrs = [o.data_ptr() for o in outs] + [None] * (3 - sections)
            rc = lib.dim_qkv_rotary_f32(0, x.data_ptr(), ws.data_ptr(), b.data_ptr(),
                                        cos.data_ptr() if rot else None,
                                        sin.data_ptr() if rot else None, *ptrs, B * N, N,
                                        sections, sum(1 << s for s in rot), stream())
            if rc:
                raise RuntimeError(f"dim_qkv_rotary_f32: CUDA error {rc}")
            return tuple(outs)

        yield (f"qkv_f32 {'self' if rot else 'cross'} (65536, 256)", call,
               lambda w=w, b=b, sections=sections, rot=rot: proj_rotary_reference(
                   x, w, b, cos, sin, H, sections, rot), "qkv_f32_sm90")


def measure(d: str) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke
    from deep_image_matching_tpu_torch.ops import _lib
    from torch.profiler import ProfilerActivity, profile

    lib = ctypes.CDLL(str(Path(d) / "libprobe.so"))
    for name in ("dim_ffn_f32", "dim_qkv_rotary_f32"):
        getattr(lib, name).argtypes = _lib._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = {"card": card}
    for name, call, plain, entry in cases(torch, lib, dev):
        got, ref = call(), plain()
        torch.cuda.synchronize()
        err = max(chip_smoke._rel_err(g, r) for g, r in zip(got, ref))
        digest = _digest(got)
        del ref
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        dev_ms = sum(ms for ms, _, key in chip_smoke._device_busy(prof)[2] if entry in key) / 20
        out[name] = {"err": err, "digest": digest, "call_ms": chip_smoke._time_ms(call),
                     "device_ms": dev_ms}
        torch.cuda.empty_cache()
    out["ptxas"] = ptxas(Path(d) / "ptxas.log")
    out["ptxas_warnings"] = [line.strip() for line in (Path(d) / "ptxas.log").read_text()
                             .splitlines() if "warning" in line.lower() or "injected" in line]
    return out


def main() -> None:
    if sys.argv[1:2] == ["--measure"]:
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return
    args = sys.argv[1:]
    variants = list(PATCHES)
    if "--variants" in args:
        i = args.index("--variants")
        args, variants = args[:i], args[i + 1:]
    trees = [Path(a).resolve() for a in args] or [ROOT]
    tags = [re.sub(r"[^\w.-]", "_", str(t.relative_to(ROOT)) if t != ROOT and ROOT in t.parents
                   else t.name) or "this" for t in trees]
    tags = ["this" if t == ROOT else tag for t, tag in zip(trees, tags)]
    jobs, skipped = [], []
    for variant in variants:
        for tree, tag in zip(trees, tags):
            d = make_variant(tree, variant, tag)
            if d is None:
                skipped.append((tag, variant))
                print(f"{tag}: variant {variant}: its cut is not in these sources; skipped",
                      flush=True)
            else:
                jobs.append((d, variant, tag))
    build_all([(d, v) for d, v, _ in jobs])
    table = {}
    for d, variant, tag in jobs:
        res = subprocess.run([sys.executable, __file__, "--measure", str(d)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit(f"{tag} {variant} failed:\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tag, "variant": variant, **line}), flush=True)
        table.setdefault(tag, {})[variant] = {k: round(v["device_ms"], 4)
                                              for k, v in line.items() if isinstance(v, dict)
                                              and "device_ms" in v}
    print(json.dumps({"device_ms": table}), flush=True)


if __name__ == "__main__":
    main()
