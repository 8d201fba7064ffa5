"""LightGlue matcher (PyTorch port of ``deep_image_matching_tpu/models/lightglue.py``).

``LightGlue`` is an ``nn.Module`` whose parameters carry the original torch
state-dict keys (``posenc.Wr.weight``, ``transformers.{i}.self_attn.Wqkv``,
``log_assignment.{i}.final_proj``, ``token_confidence.{i}.token.0``, ...), so
published checkpoints load unchanged. ``forward`` is the JAX package's
``forward_impl`` with the split layout: batched pairs with fixed keypoint
capacity and validity masks, masked self and cross attention, and

- the fixed-depth path (``depth_confidence <= 0`` and
  ``width_confidence <= 0``);
- the adaptive path: the depth exit at batch level (a batch stops after the
  first layer where every pair is token-confident) and width pruning
  expressed as mask updates, exactly as the JAX package does it;
  ``forward_shards`` runs the row blocks of a device mesh's slots as one
  batch, the exit decided over all of them.

Attention, the FFN and the assignment go through the kernel wrappers of
``ops/`` (CUDA kernels on the GPU, their plain versions on the CPU). The FFN
and assignment routes are the JAX package's: ``ffn_impl`` "fused" (kernel 2,
at widths that are multiples of 128) or "xla" (its unfused arithmetic,
``ops/ffn.py::ffn_xla``, also taken by "fused" at other widths), "auto" resolved
from ``attn_impl`` as there; ``assignment_impl`` "fused" (kernel 3) or
"dense". A checkpoint deeper than the model gives its first ``n_layers``
layers. The JAX package's two opt-ins are honoured:

- ``attn_impl="bidir"`` (the matcher's ``tpu.attn_impl``) runs the cross
  block through the shared-score bidirectional kernel
  (``ops/bidir_attention.py``) instead of two attention calls; self
  attention stays on ``ops/attention.py``;
- ``DIM_TPU_FUSED_PROLOGUE=1`` (read per call) runs the QKV projection, the
  head unpack and the rotary embedding as one kernel (``ops/qkv.py``) where
  the width is a multiple of 128 and so is the number of rows; the cross
  block fuses only when both sides have one shape. Its weights are permuted
  once per model, dtype and device.

In float32 on CUDA the kernels run their float32 forms (split TF32 on the
tensor cores); the FFN's and the fused prologue's weights are split into
TF32 halves once per model and device (``LightGlue.tf32_weights``), and cos
and sin stay f32.
"""

from __future__ import annotations

import logging
import os
import re
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.assignment import filter_matches_fused, log_assignment_dense
from ..ops.attention import fused_attention
from ..ops.bidir_attention import bidir_cross_attention
from ..ops.ffn import ffn_fused, ffn_weights_tf32, ffn_xla
from ..ops.qkv import (qk_v_fused, qk_v_weights, qkv_rotary_fused, qkv_weights, rotate_half,
                       weights_tf32)

logger = logging.getLogger("dim_tpu_torch")

# "flash" and "xla" name the JAX package's two XLA-side routes; both run the
# attention kernel here. "bidir" runs the cross block on kernel 6.
ATTN_IMPLS = ("flash", "xla", "bidir")
# "fused" is kernel 2, "xla" the JAX package's unfused arithmetic
# (``ops/ffn.py::ffn_xla``); "auto" picks between them as the JAX package does
FFN_IMPLS = ("auto", "fused", "xla")
# "fused" is kernel 3, "dense" the (B, M, N) log assignment and its filter
ASSIGNMENT_IMPLS = ("fused", "dense")


def check_attn_impl(attn_impl: str) -> str:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r}; expected one of {ATTN_IMPLS}")
    return attn_impl


def resolve_ffn_impl(ffn_impl: str, attn_impl: str) -> str:
    """``tpu.ffn_impl`` as the JAX package reads it: "auto" is "fused"
    wherever the attention kernel route is "flash" or "bidir", else "xla"."""
    check_attn_impl(attn_impl)
    if ffn_impl not in FFN_IMPLS:
        raise ValueError(f"ffn_impl {ffn_impl!r}; expected one of {FFN_IMPLS}")
    if ffn_impl == "auto":
        return "fused" if attn_impl in ("flash", "bidir") else "xla"
    return ffn_impl


def check_assignment_impl(assignment_impl: str) -> str:
    if assignment_impl not in ASSIGNMENT_IMPLS:
        raise ValueError(
            f"assignment_impl {assignment_impl!r}; expected one of {ASSIGNMENT_IMPLS}")
    return assignment_impl


def truncate_layers(state_dict: dict, n_layers: int) -> dict:
    """The entries of the first ``n_layers`` layers of a deeper checkpoint
    (the JAX package's ``params_from_torch(sd, n_layers=...)``): those of
    ``transformers.{i}`` and ``log_assignment.{i}`` for i >= n_layers and of
    ``token_confidence.{i}`` for i >= n_layers - 1 are dropped."""
    out = {}
    for k, v in state_dict.items():
        m = re.match(r"(transformers|log_assignment|token_confidence)\.(\d+)\.", k)
        if m and int(m.group(2)) >= n_layers - (m.group(1) == "token_confidence"):
            continue
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# Modules (parameter containers with the torch LightGlue names)
# ---------------------------------------------------------------------------

def _ffn_seq(dim: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Linear(2 * dim, 2 * dim), nn.LayerNorm(2 * dim, elementwise_affine=True),
        nn.GELU(), nn.Linear(2 * dim, dim),
    )


class _PosEnc(nn.Module):
    def __init__(self, head_dim: int):
        super().__init__()
        self.Wr = nn.Linear(2, head_dim // 2, bias=False)


class _SelfBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.Wqkv = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)
        self.ffn = _ffn_seq(dim)


class _CrossBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.to_qk = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.to_out = nn.Linear(dim, dim)
        self.ffn = _ffn_seq(dim)


class _Layer(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.self_attn = _SelfBlock(dim)
        self.cross_attn = _CrossBlock(dim)


class _Assign(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.final_proj = nn.Linear(dim, dim)
        self.matchability = nn.Linear(dim, 1)


class _Token(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.token = nn.Sequential(nn.Linear(dim, 1), nn.Sigmoid())


class LightGlue(nn.Module):
    def __init__(self, n_layers: int = 9, dim: int = 256, num_heads: int = 4,
                 input_dim: int = 256):
        super().__init__()
        self.n_layers = n_layers
        self.num_heads = num_heads
        if input_dim != dim:
            self.input_proj = nn.Linear(input_dim, dim)
        self.posenc = _PosEnc(dim // num_heads)
        self.transformers = nn.ModuleList([_Layer(dim) for _ in range(n_layers)])
        self.log_assignment = nn.ModuleList([_Assign(dim) for _ in range(n_layers)])
        self.token_confidence = nn.ModuleList(
            [_Token(dim) for _ in range(n_layers - 1)]
        )
        # the fused prologue's permuted weights by (dtype, device), and the
        # f32 kernels' TF32 halves by ("tf32", dtype, device)
        self._prologue: Dict[tuple, list] = {}

    def load_state_dict(self, *args, **kwargs):
        self._prologue.clear()
        return super().load_state_dict(*args, **kwargs)

    def prologue_weights(self, p: Dict[str, torch.Tensor]) -> list:
        """Per layer, the self block's section-permuted ``Wqkv`` and the
        cross block's stacked ``to_qk`` / ``to_v``, built from ``p`` (the
        parameters in the compute dtype) once per dtype and device."""
        w = p["transformers.0.self_attn.Wqkv.weight"]
        key = (w.dtype, w.device)
        if key not in self._prologue:
            out = []
            for i in range(self.n_layers):
                t = f"transformers.{i}"
                c = f"{t}.cross_attn"
                out.append({
                    "self": qkv_weights(p[f"{t}.self_attn.Wqkv.weight"],
                                        p[f"{t}.self_attn.Wqkv.bias"], self.num_heads),
                    "cross": qk_v_weights(p[f"{c}.to_qk.weight"], p[f"{c}.to_qk.bias"],
                                          p[f"{c}.to_v.weight"], p[f"{c}.to_v.bias"]),
                })
            self._prologue[key] = out
        return self._prologue[key]

    def tf32_weights(self, p: Dict[str, torch.Tensor]) -> list:
        """Per layer, the TF32 halves that the float32 kernels read: each
        block's FFN weights (``ffn_weights_tf32``) and the fused prologue's
        permuted weights (``weights_tf32``), built from ``p`` (the parameters
        in f32) once per device."""
        w = p["transformers.0.self_attn.Wqkv.weight"]
        key = ("tf32", w.dtype, w.device)
        if key not in self._prologue:
            pro = self.prologue_weights(p)
            out = []
            for i in range(self.n_layers):
                t = f"transformers.{i}"
                layer = {blk: ffn_weights_tf32(p[f"{t}.{blk}.ffn.0.weight"],
                                               p[f"{t}.{blk}.ffn.3.weight"])
                         for blk in ("self_attn", "cross_attn")}
                layer["self"] = weights_tf32(pro[i]["self"][0])
                layer["cross"] = weights_tf32(pro[i]["cross"][0])
                out.append(layer)
            self._prologue[key] = out
        return self._prologue[key]

    @torch.no_grad()
    def reset_random(self, generator: torch.Generator) -> "LightGlue":
        """Linear weights ~ N(0, 1/fan_in), posenc ~ N(0, 1), zero biases,
        unit LayerNorm gains: the JAX package's ``init_params`` recipe,
        drawn from ``generator``."""
        self._prologue.clear()
        for name, p in self.named_parameters():
            if name == "posenc.Wr.weight":
                p.copy_(torch.randn(p.shape, generator=generator))
            elif ".ffn.1." in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("weight"):
                p.copy_(torch.randn(p.shape, generator=generator) / p.shape[1] ** 0.5)
            else:
                p.zero_()
        return self


# ---------------------------------------------------------------------------
# Building blocks (JAX layouts: (B, N, D) tokens, (B, H, N, hd) heads)
# ---------------------------------------------------------------------------

def normalize_keypoints(kpts: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """kpts (B, N, 2) pixels; size (B, 2) as (w, h) -> roughly [-1, 1]."""
    size = size.float()
    shift = size / 2.0
    scale = size.max(dim=-1, keepdim=True).values / 2.0
    return (kpts - shift[:, None, :]) / scale[:, None, :]


def rotary_encoding(kpts_n: torch.Tensor, wr: torch.Tensor):
    """Learnable Fourier features -> rotary (cos, sin), each (B, N, hd),
    frequencies repeated in adjacent pairs; always f32. ``wr`` is (2, hd/2)."""
    proj = torch.einsum("bnm,md->bnd", kpts_n.float(), wr.float())
    return (torch.repeat_interleave(torch.cos(proj), 2, dim=-1),
            torch.repeat_interleave(torch.sin(proj), 2, dim=-1))


def _apply_rotary(t, cos, sin):
    """t (B, H, N, hd); cos/sin (B, N, hd)."""
    cos = cos.to(t.dtype)[:, None]
    sin = sin.to(t.dtype)[:, None]
    return t * cos + rotate_half(t) * sin


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, N, D = x.shape
    return x.reshape(B, N, num_heads, D // num_heads).transpose(1, 2).contiguous()


def _merge(x: torch.Tensor) -> torch.Tensor:
    B, H, N, hd = x.shape
    return x.transpose(1, 2).reshape(B, N, H * hd)


def _ffn(x, msg, p, prefix, impl="fused", split=None):
    """The FFN of block ``prefix``: kernel 2 for "fused" at widths that are
    multiples of 128 (the JAX package's gate, but at any row count; on CUDA
    the kernel takes D = 256; ``split``: its weights' TF32 halves for the f32
    form); otherwise, or for "xla", the JAX package's unfused arithmetic
    ``ffn_xla``, which LighterGlue's width 96 takes as there."""
    args = (x, msg, p[f"{prefix}.ffn.0.weight"], p[f"{prefix}.ffn.0.bias"],
            p[f"{prefix}.ffn.1.weight"], p[f"{prefix}.ffn.1.bias"],
            p[f"{prefix}.ffn.3.weight"], p[f"{prefix}.ffn.3.bias"])
    if impl == "fused" and x.shape[-1] % 128 == 0:
        return ffn_fused(*args, split=split)
    return ffn_xla(*args)


def _lin(x, p, prefix):
    return F.linear(x, p[f"{prefix}.weight"], p.get(f"{prefix}.bias"))


def _prologue_fused_ok(x: torch.Tensor, ffn_impl: str = "fused") -> bool:
    """The fused prologue (kernel 10) when ``DIM_TPU_FUSED_PROLOGUE=1``,
    read on every call as the JAX package reads it, the FFN is the fused one
    and the width and the row count are multiples of 128 (the JAX package's
    gate)."""
    if os.environ.get("DIM_TPU_FUSED_PROLOGUE", "0") != "1":
        return False
    B, N, D = x.shape
    return ffn_impl == "fused" and D % 128 == 0 and (B * N) % 128 == 0


def self_prologue(x, p, t, cos, sin, num_heads):
    """The unfused self-attention prologue: the Wqkv projection of layer
    ``t``, the head split and the rotary encoding of q and k; (B, H, N, hd)
    each, contiguous (the layout kernel 10 writes)."""
    qkv = _lin(x, p, f"{t}.self_attn.Wqkv")                  # (B, N, 3D)
    B, N, D3 = qkv.shape
    # torch layout: last dim = (heads, head_dim, 3)
    qkv = qkv.reshape(B, N, num_heads, D3 // (3 * num_heads), 3).permute(0, 2, 1, 3, 4)
    q = _apply_rotary(qkv[..., 0], cos, sin).contiguous()
    k = _apply_rotary(qkv[..., 1], cos, sin).contiguous()
    return q, k, qkv[..., 2].contiguous()


def cross_prologue(x, p, c, num_heads):
    """The unfused cross-attention prologue of one side: the to_qk and to_v
    projections of block ``c`` split into (B, H, N, hd) heads."""
    return (_heads(_lin(x, p, f"{c}.to_qk"), num_heads),
            _heads(_lin(x, p, f"{c}.to_v"), num_heads))


def _self_block(x, enc, mask, p, t, num_heads, fused=None, ffn_impl="fused", split=None):
    """``fused``: the layer's prologue weights (``LightGlue.prologue_weights``),
    used when the fused prologue runs; ``split``: the layer's TF32 halves
    (``LightGlue.tf32_weights``) in float32, else None."""
    cos, sin = enc
    if fused is not None and _prologue_fused_ok(x, ffn_impl):
        q, k, v = qkv_rotary_fused(x, *fused["self"], cos, sin, num_heads,
                                   split=None if split is None else split["self"])
    else:
        q, k, v = self_prologue(x, p, t, cos, sin, num_heads)
    ctx = fused_attention(q, k, v, mask, mask, q.shape[-1] ** -0.5)
    msg = _lin(_merge(ctx), p, f"{t}.self_attn.out_proj")
    return _ffn(x, msg, p, f"{t}.self_attn", ffn_impl,
                None if split is None else split["self_attn"])


def _cross_block(x0, x1, mask0, mask1, p, t, num_heads, attn_impl="flash", fused=None,
                 ffn_impl="fused", split=None):
    c = f"{t}.cross_attn"
    if fused is not None and _prologue_fused_ok(x0, ffn_impl) and x0.shape == x1.shape:
        wsplit = None if split is None else split["cross"]
        qk0, v0 = qk_v_fused(x0, *fused["cross"], num_heads, split=wsplit)
        qk1, v1 = qk_v_fused(x1, *fused["cross"], num_heads, split=wsplit)
    else:
        qk0, v0 = cross_prologue(x0, p, c, num_heads)
        qk1, v1 = cross_prologue(x1, p, c, num_heads)
    if attn_impl == "bidir":
        # one kernel: both directions of the shared-score cross attention
        m0, m1 = bidir_cross_attention(qk0, qk1, v0, v1, mask0, mask1)
    else:
        # one attention per direction; the shared Q K^T is recomputed (the
        # JAX package's flash route)
        scale = qk0.shape[-1] ** -0.5
        m0 = fused_attention(qk0, qk1, v1, mask0, mask1, scale)
        m1 = fused_attention(qk1, qk0, v0, mask1, mask0, scale)
    m0 = _lin(_merge(m0), p, f"{c}.to_out")
    m1 = _lin(_merge(m1), p, f"{c}.to_out")
    fsplit = None if split is None else split["cross_attn"]
    return _ffn(x0, m0, p, c, ffn_impl, fsplit), _ffn(x1, m1, p, c, ffn_impl, fsplit)


def _assign_inputs(desc0, desc1, p, i):
    """Projected descriptors md (scaled by d^-1/4) and f32 matchability
    logits z for layer ``i``'s assignment head."""
    a = f"log_assignment.{i}"
    d = desc0.shape[-1]
    md0 = _lin(desc0, p, f"{a}.final_proj") / d ** 0.25
    md1 = _lin(desc1, p, f"{a}.final_proj") / d ** 0.25
    z0 = _lin(desc0, p, f"{a}.matchability")[..., 0].float()
    z1 = _lin(desc1, p, f"{a}.matchability")[..., 0].float()
    return md0, md1, z0, z1


def _log_assignment(desc0, desc1, mask0, mask1, p, i):
    """Dense (B, M, N) dual-softmax log assignment of layer ``i``'s head,
    -1e30 where either side is masked."""
    md0, md1, z0, z1 = _assign_inputs(desc0, desc1, p, i)
    return log_assignment_dense(md0, md1, z0, z1, mask0, mask1)


def filter_matches_static(scores, mask0, mask1, threshold: float):
    """Mutual-argmax + threshold filtering of dense scores. Returns matches0
    (B, M) int32 (-1 = no match), mscores0 (B, M), valid0 (B, M)."""
    max0, m0 = scores.max(dim=2)
    m1 = scores.argmax(dim=1)
    M = m0.shape[1]
    mutual0 = torch.arange(M, device=scores.device)[None] == torch.gather(m1, 1, m0)
    mscores0 = torch.where(mutual0, torch.exp(max0), max0.new_tensor(0.0))
    valid0 = mutual0 & (mscores0 > threshold) & mask0
    matches0 = torch.where(valid0, m0, m0.new_tensor(-1)).int()
    return matches0, mscores0, valid0


def _token_confidences(d0, d1, p, i):
    t = f"token_confidence.{i}.token.0"
    return (torch.sigmoid(_lin(d0, p, t)[..., 0].float()),
            torch.sigmoid(_lin(d1, p, t)[..., 0].float()))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward(
    model: LightGlue,
    kpts0: torch.Tensor,        # (B, M, 2) pixels
    kpts1: torch.Tensor,        # (B, N, 2)
    desc0: torch.Tensor,        # (B, M, D_in)
    desc1: torch.Tensor,        # (B, N, D_in)
    mask0: torch.Tensor,        # (B, M) bool
    mask1: torch.Tensor,        # (B, N) bool
    size0: torch.Tensor,        # (B, 2) (w, h)
    size1: torch.Tensor,
    filter_threshold: float = 0.1,
    depth: Optional[int] = None,
    depth_confidence: float = -1.0,
    width_confidence: float = -1.0,
    pruning_min_kpts: int = 1536,
    compute_dtype: torch.dtype = torch.float32,
    attn_impl: str = "flash",
    ffn_impl: str = "auto",
    assignment_impl: str = "fused",
) -> Dict[str, torch.Tensor]:
    """Batched LightGlue matching (the JAX package's ``forward_impl``).

    ``depth`` truncates the layer stack. ``depth_confidence > 0`` enables the
    adaptive-depth exit at batch level: after each layer the token-confidence
    heads score both point sets, and the loop stops once every pair's
    confident ratio exceeds the threshold; the assignment then uses the exit
    layer's head. ``width_confidence > 0`` masks confident-but-unmatchable
    points out of later layers and the assignment, per pair while it holds
    more than ``pruning_min_kpts`` points. ``compute_dtype`` bf16 runs the
    transformer in bf16 (f32 accumulation and softmax); f32 runs it in f32,
    through the kernels' float32 forms on CUDA; assignment scores stay
    f32. ``attn_impl`` "bidir" runs the cross attention on kernel 6
    (``ATTN_IMPLS``); ``ffn_impl`` and ``assignment_impl`` pick the FFN and
    assignment routes (``FFN_IMPLS``, ``ASSIGNMENT_IMPLS``). Returns
    matches0 (B, M) int32, matching_scores0, valid0 and layers_run (int).
    It is ``forward_shards`` over one shard."""
    return forward_shards(
        [(model, kpts0, kpts1, desc0, desc1, mask0, mask1, size0, size1)],
        filter_threshold=filter_threshold, depth=depth, depth_confidence=depth_confidence,
        width_confidence=width_confidence, pruning_min_kpts=pruning_min_kpts,
        compute_dtype=compute_dtype, attn_impl=attn_impl, ffn_impl=ffn_impl,
        assignment_impl=assignment_impl)[0]


@torch.no_grad()
def forward_shards(shards, n_real=None, filter_threshold: float = 0.1,
                   depth: Optional[int] = None, depth_confidence: float = -1.0,
                   width_confidence: float = -1.0, pruning_min_kpts: int = 1536,
                   compute_dtype: torch.dtype = torch.float32, attn_impl: str = "flash",
                   ffn_impl: str = "auto", assignment_impl: str = "fused") -> list:
    """``forward`` over the row blocks of one batch, each on its own device
    (the slots of a device mesh), as one batch: ``shards`` holds per block
    ``(model, kpts0, kpts1, desc0, desc1, mask0, mask1, size0, size1)`` with
    the model on the block's device, ``n_real`` per block the rows that
    count for the depth exit (the others are padding; all by default).

    The layers advance over every block in step: each layer is launched on
    every block, then every block's exit flag (``all`` over its real rows)
    is read in one host sync, and the batch stops at the first layer where
    every real row of every block is confident, as the JAX package's one
    program decides over the whole batch. Launches are asynchronous, so
    blocks on distinct devices run side by side. Width pruning is per row.
    Returns ``forward``'s outputs per block."""
    ffn_impl = resolve_ffn_impl(ffn_impl, attn_impl)
    check_assignment_impl(assignment_impl)
    n_real = n_real or [None] * len(shards)
    runs = [_Shard(*shard, real, compute_dtype, attn_impl, ffn_impl)
            for shard, real in zip(shards, n_real)]
    n_layers = runs[0].model.n_layers
    if depth is not None and depth < n_layers:
        n_layers = depth
    do_stop = depth_confidence is not None and depth_confidence > 0
    do_prune = width_confidence is not None and width_confidence > 0

    layers_run = n_layers
    for i in range(n_layers):
        for run in runs:
            run.layer(i)
        if not (do_stop or do_prune):
            continue
        last = i == n_layers - 1
        # the last layer has no confidence head; the loop bound exits there
        th = float(np.clip(0.8 + 0.1 * np.exp(np.float32(-4.0 * i) / np.float32(n_layers)),
                           0.0, 1.0))
        stop = False
        if do_stop and not last:
            flags = [run.confident(i, th, depth_confidence) for run in runs]
            dev = flags[0].device
            stop = bool(flags[0] if len(flags) == 1
                        else torch.stack([f.to(dev) for f in flags]).all())
        if do_prune and not last and not stop:
            for run in runs:
                run.prune(i, th, width_confidence, pruning_min_kpts, do_stop)
        if stop:
            layers_run = i + 1
            break
    return [run.result(layers_run, assignment_impl, filter_threshold) for run in runs]


class _Shard:
    """One row block's tensors through ``forward_shards``' layer loop."""

    def __init__(self, model, kpts0, kpts1, desc0, desc1, mask0, mask1, size0, size1,
                 n_real, compute_dtype, attn_impl, ffn_impl):
        self.model, self.n_real = model, n_real
        self.attn_impl, self.ffn_impl = attn_impl, ffn_impl
        self.mask0 = mask0.bool()
        self.mask1 = mask1.bool()
        # every parameter in the compute dtype, as the JAX package casts its
        # parameter tree (the rotary frequencies are rounded, then used in f32)
        p = {k: v.to(compute_dtype) for k, v in model.state_dict().items()}
        desc0 = desc0.to(compute_dtype)
        desc1 = desc1.to(compute_dtype)
        if "input_proj.weight" in p:
            desc0 = _lin(desc0, p, "input_proj")
            desc1 = _lin(desc1, p, "input_proj")
        self.p, self.desc0, self.desc1 = p, desc0, desc1
        self.fused = (model.prologue_weights(p)
                      if os.environ.get("DIM_TPU_FUSED_PROLOGUE", "0") == "1" else None)
        # the float32 kernels' TF32 halves of the weights, made once per model
        self.splits = model.tf32_weights(p) if compute_dtype == torch.float32 else None
        wr = p["posenc.Wr.weight"].T
        # every rotary use rounds cos and sin to the compute dtype: round them
        # once (in f32 they stay as they are)
        self.enc0 = tuple(e.to(compute_dtype)
                          for e in rotary_encoding(normalize_keypoints(kpts0, size0), wr))
        self.enc1 = tuple(e.to(compute_dtype)
                          for e in rotary_encoding(normalize_keypoints(kpts1, size1), wr))
        # the reference's stop check divides by the ORIGINAL m + n: pruned
        # points implicitly count as confident
        self.n_pts_orig = (self.mask0.sum(1) + self.mask1.sum(1)).float()
        self.c0 = self.c1 = None

    def layer(self, i: int) -> None:
        t = f"transformers.{i}"
        p, heads = self.p, self.model.num_heads
        fl = None if self.fused is None else self.fused[i]
        sl = None if self.splits is None else self.splits[i]
        self.desc0 = _self_block(self.desc0, self.enc0, self.mask0, p, t, heads, fl,
                                 self.ffn_impl, sl)
        self.desc1 = _self_block(self.desc1, self.enc1, self.mask1, p, t, heads, fl,
                                 self.ffn_impl, sl)
        self.desc0, self.desc1 = _cross_block(self.desc0, self.desc1, self.mask0, self.mask1,
                                              p, t, heads, self.attn_impl, fl, self.ffn_impl, sl)

    def confident(self, i: int, th: float, depth_confidence: float) -> torch.Tensor:
        """Layer ``i``'s exit flag on the device: every real row's confident
        ratio above ``depth_confidence``."""
        c0, c1 = self.c0, self.c1 = _token_confidences(self.desc0, self.desc1, self.p, i)
        n_unconf = (((c0 < th) & self.mask0).sum(1) + ((c1 < th) & self.mask1).sum(1)).float()
        ratio = 1.0 - n_unconf / self.n_pts_orig.clamp(min=1.0)
        if self.n_real is not None:
            ratio = ratio[:self.n_real]
        return (ratio > depth_confidence).all()

    def prune(self, i: int, th: float, width_confidence: float, pruning_min_kpts: int,
              do_stop: bool) -> None:
        a = f"log_assignment.{i}.matchability"
        keep0 = torch.sigmoid(_lin(self.desc0, self.p, a)[..., 0].float()) > 1.0 - width_confidence
        keep1 = torch.sigmoid(_lin(self.desc1, self.p, a)[..., 0].float()) > 1.0 - width_confidence
        if do_stop:
            # low-confidence points are never pruned while the confidence
            # head runs (reference get_pruning_mask)
            keep0 = keep0 | (self.c0 <= th)
            keep1 = keep1 | (self.c1 <= th)
        allow0 = self.mask0.sum(1, keepdim=True) > pruning_min_kpts
        allow1 = self.mask1.sum(1, keepdim=True) > pruning_min_kpts
        self.mask0 = self.mask0 & (keep0 | ~allow0)
        self.mask1 = self.mask1 & (keep1 | ~allow1)

    def result(self, layers_run: int, assignment_impl: str, filter_threshold: float) -> dict:
        desc0, desc1, mask0, mask1, p = self.desc0, self.desc1, self.mask0, self.mask1, self.p
        if assignment_impl == "fused":
            md0, md1, z0, z1 = _assign_inputs(desc0, desc1, p, layers_run - 1)
            matches0, mscores0, valid0 = filter_matches_fused(
                md0, md1, z0, z1, mask0, mask1, filter_threshold
            )
        else:
            scores = _log_assignment(desc0, desc1, mask0, mask1, p, layers_run - 1)
            matches0, mscores0, valid0 = filter_matches_static(scores, mask0, mask1,
                                                               filter_threshold)
        return {
            "matches0": matches0,
            "matching_scores0": mscores0,
            "valid0": valid0,
            "layers_run": layers_run,
        }


# ---------------------------------------------------------------------------
# Default weights and the host runner
# ---------------------------------------------------------------------------

_DEFAULT_MODELS: Dict[str, LightGlue] = {}
_DEFAULT_RANDOM: set = set()
_INPUT_DIMS = {"superpoint": 256, "disk": 128, "aliked": 128, "sift": 128, "rdd_sparse": 256}


def load_default_model(features: str = "superpoint", n_layers: int = 9) -> LightGlue:
    """Pretrained weights if a checkpoint exists (DIM_TPU_WEIGHTS_DIR or
    ~/.cache/dim_tpu, ``<features>_lightglue.pth``), else random weights
    from a seeded generator, subject to the weights policy. Cached random
    weights re-consult the policy, so a strict() probe never receives them."""
    from ..utils.weights import missing_weights, reject_cached_random

    names = [f"{features}_lightglue.pth", f"{features}_lightglue_v0-1_arxiv.pth"]
    key = f"{features}:{n_layers}"
    if key in _DEFAULT_MODELS:
        if key in _DEFAULT_RANDOM:
            reject_cached_random(f"LightGlue ({features})", names)
        return _DEFAULT_MODELS[key]
    model = LightGlue(n_layers=n_layers, input_dim=_INPUT_DIMS.get(features, 256))
    wdir = os.environ.get("DIM_TPU_WEIGHTS_DIR")
    for base in ([Path(wdir)] if wdir else []) + [Path.home() / ".cache/dim_tpu"]:
        for name in names:
            cand = base / name
            if cand.exists():
                # a deeper checkpoint (the published 9 layers for the
                # 7-layer preset) gives its first n_layers layers
                sd = torch.load(str(cand), map_location="cpu")
                model.load_state_dict(truncate_layers(sd, n_layers))
                logger.info(f"Loaded LightGlue weights from {cand}")
                _DEFAULT_MODELS[key] = model.eval()
                return _DEFAULT_MODELS[key]
    missing_weights(f"LightGlue ({features})", names)
    _DEFAULT_MODELS[key] = model.reset_random(torch.Generator().manual_seed(42)).eval()
    _DEFAULT_RANDOM.add(key)
    return _DEFAULT_MODELS[key]


class LightGlueRunner:
    """Host-side batched matching over per-image feature dicts on
    ``device``; each image's padded features upload once."""

    def __init__(
        self,
        model: Optional[LightGlue] = None,
        features: str = "superpoint",
        n_layers: int = 9,
        filter_threshold: float = 0.1,
        batch_size: int = 16,
        depth: Optional[int] = None,
        compute_dtype: Optional[torch.dtype] = None,
        depth_confidence: float = -1.0,
        width_confidence: float = -1.0,
        device: torch.device = torch.device("cpu"),
        attn_impl: str = "flash",
    ):
        self.device = torch.device(device)
        self.attn_impl = check_attn_impl(attn_impl)
        model = model if model is not None else load_default_model(features, n_layers)
        self.model = model.to(self.device)
        self.filter_threshold = filter_threshold
        self.batch_size = batch_size
        self.depth = depth
        self.depth_confidence = depth_confidence
        self.width_confidence = width_confidence
        # None = bf16 on the GPU, f32 on the CPU
        self.compute_dtype = compute_dtype or (
            torch.bfloat16 if self.device.type == "cuda" else torch.float32
        )

    def count_matches_pairs(self, feats: list, pairs: list) -> list:
        """Number of raw matches per (i, j) pair (the low-res probe)."""
        store = self._device_store(feats)
        counts = []
        for start in range(0, len(pairs), self.batch_size):
            out = self._run_chunk(pairs[start:start + self.batch_size], store)
            counts.extend(int(c) for c in out["valid0"].sum(1).cpu())
        return counts

    def match_pairs(self, feats: list, pairs: list) -> list:
        """(M, 2) int32 match indices per (i, j) pair."""
        store = self._device_store(feats)
        out_matches = []
        for start in range(0, len(pairs), self.batch_size):
            chunk = pairs[start:start + self.batch_size]
            out = self._run_chunk(chunk, store)
            matches0, valid0 = out["matches0"].cpu().numpy(), out["valid0"].cpu().numpy()
            for b in range(len(chunk)):
                rows = np.nonzero(valid0[b])[0]
                out_matches.append(np.stack([rows, matches0[b][rows]], 1).astype(np.int32))
        return out_matches

    def _device_store(self, feats: list) -> dict:
        """All images' features padded to one capacity (multiple of 128)."""
        cap = max((len(f["keypoints"]) for f in feats), default=1)
        cap = max(128, -(-cap // 128) * 128)
        dims = [f["descriptors"].shape[-1] for f in feats if len(f["keypoints"])]
        D = dims[0] if dims else 256
        n = len(feats)
        kpts = np.zeros((n, cap, 2), np.float32)
        desc = np.zeros((n, cap, D), np.float32)
        mask = np.zeros((n, cap), bool)
        size = np.zeros((n, 2), np.float32)
        for i, f in enumerate(feats):
            c = len(f["keypoints"])
            kpts[i, :c] = f["keypoints"]
            if c:
                desc[i, :c] = f["descriptors"]
            mask[i, :c] = True
            size[i] = f["image_size"]
        dev = self.device
        return {"kpts": torch.from_numpy(kpts).to(dev), "desc": torch.from_numpy(desc).to(dev),
                "mask": torch.from_numpy(mask).to(dev), "size": torch.from_numpy(size).to(dev)}

    def _run_chunk(self, chunk: list, store: dict) -> dict:
        i0 = torch.tensor([i for i, _ in chunk], device=self.device)
        i1 = torch.tensor([j for _, j in chunk], device=self.device)
        return forward(
            self.model,
            store["kpts"][i0], store["kpts"][i1], store["desc"][i0], store["desc"][i1],
            store["mask"][i0], store["mask"][i1], store["size"][i0], store["size"][i1],
            filter_threshold=self.filter_threshold, depth=self.depth,
            depth_confidence=self.depth_confidence,
            width_confidence=self.width_confidence,
            compute_dtype=self.compute_dtype, attn_impl=self.attn_impl,
        )
