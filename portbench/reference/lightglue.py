"""LightGlue (Lindenberger et al., ICCV 2023), as ``cvg/LightGlue``'s
``lightglue.py`` computes it for one pair, with its adaptive depth and
width: after each layer but the last, the token-confidence heads decide
whether the pair stops, and points that are confidently unmatchable leave
the later layers while more than ``pruning_min_kpts`` remain.

Parameters carry the state-dict keys of that file after its renaming of
old checkpoints (``transformers.{i}.self_attn.Wqkv``,
``log_assignment.{i}.final_proj``, ``token_confidence.{i}.token.0``, ...).
The cross block computes one similarity for both directions, as the
published non-flash path does. The benchmark's seeded checkpoint is
``FILE``, drawn by ``std`` and ``fixed``. Keypoint counts are the pair's own: no
padding, pruned points removed.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from .lowp import exact


def shapes(n_layers: int = 9, dim: int = 256, heads: int = 4) -> Dict[str, tuple]:
    """Every parameter's shape under its key (descriptors of width ``dim``)."""
    out = {"posenc.Wr.weight": (dim // heads // 2, 2)}

    def lin(name, n_in, n_out, bias=True):
        out[f"{name}.weight"] = (n_out, n_in)
        if bias:
            out[f"{name}.bias"] = (n_out,)

    def ffn(prefix):
        lin(f"{prefix}.ffn.0", 2 * dim, 2 * dim)
        out[f"{prefix}.ffn.1.weight"] = (2 * dim,)
        out[f"{prefix}.ffn.1.bias"] = (2 * dim,)
        lin(f"{prefix}.ffn.3", 2 * dim, dim)

    for i in range(n_layers):
        t = f"transformers.{i}"
        lin(f"{t}.self_attn.Wqkv", dim, 3 * dim)
        lin(f"{t}.self_attn.out_proj", dim, dim)
        ffn(f"{t}.self_attn")
        for name in ("to_qk", "to_v", "to_out"):
            lin(f"{t}.cross_attn.{name}", dim, dim)
        ffn(f"{t}.cross_attn")
        lin(f"log_assignment.{i}.final_proj", dim, dim)
        lin(f"log_assignment.{i}.matchability", dim, 1)
        if i < n_layers - 1:
            lin(f"token_confidence.{i}.token.0", dim, 1)
    return out


FILE = "superpoint_lightglue.pth"


def std(name: str, shape: tuple) -> float:
    """The seeded checkpoint's normal standard deviation of one entry, the
    port's ``reset_random`` recipe: linear weights N(0, 1/fan_in), the
    rotary frequencies N(0, 1); 0 where the entry is not drawn (biases,
    LayerNorm gains, the token-confidence heads: ``fixed``).

    The token-confidence heads stay at zero, an untrained head: every point
    reads a confidence of 0.5, below every layer's exit threshold (0.8 to
    0.9), so neither the depth exit nor the width pruning fires and every
    seed asks for the same work, all layers over every point. Drawn like
    the other layers, the heads stop a pair after 3, 6 or 9 layers by seed.
    The configuration lists ``token_confidence_heads`` under ``reduced``
    for this."""
    if name == "posenc.Wr.weight":
        return 1.0
    if ".ffn.1." in name or name.startswith("token_confidence") or not name.endswith("weight"):
        return 0.0
    return shape[1] ** -0.5


def fixed(name: str, shape: tuple) -> torch.Tensor:
    """An entry that is not drawn: unit LayerNorm gains, the rest zero."""
    return torch.ones(shape) if ".ffn.1.weight" in name else torch.zeros(shape)


def _lin(sd, name, x, rnd):
    return F.linear(rnd(x), rnd(sd[f"{name}.weight"]), sd.get(f"{name}.bias"))


def _ffn(sd, prefix, x, rnd):
    h = _lin(sd, f"{prefix}.ffn.0", x, rnd)
    h = F.layer_norm(h, h.shape[-1:], sd[f"{prefix}.ffn.1.weight"], sd[f"{prefix}.ffn.1.bias"])
    return _lin(sd, f"{prefix}.ffn.3", F.gelu(h), rnd)


def _rotate_half(x):
    x = x.unflatten(-1, (-1, 2))
    x1, x2 = x.unbind(-1)
    return torch.stack((-x2, x1), -1).flatten(-2)


def _attend(q, k, v, rnd):
    """softmax(q k^T / sqrt(d)) v over (H, N, d) heads."""
    sim = torch.einsum("hid,hjd->hij", rnd(q), rnd(k)) / q.shape[-1] ** 0.5
    return torch.einsum("hij,hjd->hid", rnd(sim.softmax(-1)), rnd(v))


def _self_block(sd, t, x, cos, sin, heads, rnd):
    n, dim = x.shape
    qkv = _lin(sd, f"{t}.self_attn.Wqkv", x, rnd)
    qkv = qkv.unflatten(-1, (heads, -1, 3)).transpose(0, 1)       # (H, N, d, 3)
    q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
    q = q * cos + _rotate_half(q) * sin
    k = k * cos + _rotate_half(k) * sin
    ctx = _attend(q, k, v, rnd).transpose(0, 1).reshape(n, dim)
    msg = _lin(sd, f"{t}.self_attn.out_proj", ctx, rnd)
    return x + _ffn(sd, f"{t}.self_attn", torch.cat([x, msg], -1), rnd)


def _cross_block(sd, t, x0, x1, heads, rnd):
    c = f"{t}.cross_attn"

    def split(x):
        return x.unflatten(-1, (heads, -1)).transpose(0, 1)           # (H, N, d)

    qk0, qk1 = split(_lin(sd, f"{c}.to_qk", x0, rnd)), split(_lin(sd, f"{c}.to_qk", x1, rnd))
    v0, v1 = split(_lin(sd, f"{c}.to_v", x0, rnd)), split(_lin(sd, f"{c}.to_v", x1, rnd))
    sim = torch.einsum("hid,hjd->hij", rnd(qk0), rnd(qk1)) / qk0.shape[-1] ** 0.5
    m0 = torch.einsum("hij,hjd->hid", rnd(sim.softmax(-1)), rnd(v1))
    m1 = torch.einsum("hji,hjd->hid", rnd(sim.softmax(-2)), rnd(v0))
    out = []
    for x, m in ((x0, m0), (x1, m1)):
        m = _lin(sd, f"{c}.to_out", m.transpose(0, 1).reshape(x.shape), rnd)
        out.append(x + _ffn(sd, c, torch.cat([x, m], -1), rnd))
    return out


def _log_assignment(sd, i, d0, d1, rnd):
    """(M, N) log assignment of layer ``i``'s head: the dual softmax of the
    projected similarity plus both sides' log matchability."""
    a = f"log_assignment.{i}"
    dim = d0.shape[-1]
    m0 = _lin(sd, f"{a}.final_proj", d0, rnd) / dim ** 0.25
    m1 = _lin(sd, f"{a}.final_proj", d1, rnd) / dim ** 0.25
    sim = rnd(m0) @ rnd(m1).T
    z0 = _lin(sd, f"{a}.matchability", d0, rnd)[:, 0]
    z1 = _lin(sd, f"{a}.matchability", d1, rnd)[:, 0]
    return (F.log_softmax(sim, 1) + F.log_softmax(sim, 0)
            + F.logsigmoid(z0)[:, None] + F.logsigmoid(z1)[None, :])


def _normalize(kpts, size):
    size = size.float()
    return (kpts - size / 2) / (size.max() / 2)


@torch.no_grad()
def match(sd: Dict[str, torch.Tensor], kpts0, kpts1, desc0, desc1, size0, size1,
          n_layers: int = 9, heads: int = 4, depth_confidence: float = 0.95,
          width_confidence: float = 0.99, pruning_min_kpts: int = 1536,
          filter_threshold: float = 0.0, rnd: Callable = exact) -> Dict[str, object]:
    """One pair: keypoints (M, 2) / (N, 2) in pixels, descriptors (M, D) /
    (N, D), sizes (w, h). Returns ``scores`` (M, N), the final layer's log
    assignment with the rows and columns of pruned points at -inf;
    ``matches`` (K, 2) mutual argmaxes above the threshold; ``layers`` run;
    ``pruned0`` / ``pruned1`` masks."""
    wr = sd["posenc.Wr.weight"]
    encs = []
    for kp, size in ((kpts0, size0), (kpts1, size1)):
        proj = _normalize(kp, size) @ wr.T                             # (N, d/2)
        encs.append((torch.repeat_interleave(torch.cos(proj), 2, -1)[None],
                     torch.repeat_interleave(torch.sin(proj), 2, -1)[None]))
    ind0 = torch.arange(len(kpts0), device=kpts0.device)
    ind1 = torch.arange(len(kpts1), device=kpts1.device)
    d0, d1 = desc0.float(), desc1.float()
    (c0, s0), (c1, s1) = encs
    n_all = len(kpts0) + len(kpts1)
    layers = n_layers
    for i in range(n_layers):
        d0 = _self_block(sd, f"transformers.{i}", d0, c0, s0, heads, rnd)
        d1 = _self_block(sd, f"transformers.{i}", d1, c1, s1, heads, rnd)
        d0, d1 = _cross_block(sd, f"transformers.{i}", d0, d1, heads, rnd)
        if i == n_layers - 1:
            continue
        th = min(max(0.8 + 0.1 * math.exp(-4.0 * i / n_layers), 0.0), 1.0)
        tok = f"token_confidence.{i}.token.0"
        t0 = torch.sigmoid(_lin(sd, tok, d0, rnd)[:, 0])
        t1 = torch.sigmoid(_lin(sd, tok, d1, rnd)[:, 0])
        if depth_confidence > 0:
            unconfident = (t0 < th).sum() + (t1 < th).sum()
            if 1.0 - unconfident.item() / n_all > depth_confidence:
                layers = i + 1
                break
        if width_confidence > 0:
            mb = f"log_assignment.{i}.matchability"
            for side in (0, 1):
                d, t, ind, c, s = ((d0, t0, ind0, c0, s0) if side == 0 else (d1, t1, ind1, c1, s1))
                if len(d) <= pruning_min_kpts:
                    continue
                keep = torch.sigmoid(_lin(sd, mb, d, rnd)[:, 0]) > 1.0 - width_confidence
                if depth_confidence > 0:
                    keep = keep | (t <= th)
                d, ind, c, s = d[keep], ind[keep], c[:, keep], s[:, keep]
                if side == 0:
                    d0, ind0, c0, s0 = d, ind, c, s
                else:
                    d1, ind1, c1, s1 = d, ind, c, s
    part = _log_assignment(sd, layers - 1, d0, d1, rnd)
    scores = part.new_full((len(kpts0), len(kpts1)), -math.inf)
    scores[ind0[:, None], ind1[None, :]] = part
    best0, arg0 = part.max(1)
    arg1 = part.argmax(0)
    mutual = arg1[arg0] == torch.arange(len(arg0), device=part.device)
    ok = mutual & (best0.exp() > filter_threshold)
    matches = torch.stack([ind0[ok], ind1[arg0[ok]]], -1)
    pruned0 = torch.ones(len(kpts0), dtype=torch.bool, device=kpts0.device)
    pruned1 = torch.ones(len(kpts1), dtype=torch.bool, device=kpts1.device)
    pruned0[ind0] = False
    pruned1[ind1] = False
    return {"scores": scores, "matches": matches, "layers": layers,
            "pruned0": pruned0, "pruned1": pruned1}



def match_pair(sd: Dict[str, torch.Tensor], conf: dict, f0: dict, f1: dict, size0, size1,
               rnd: Callable = exact) -> Dict[str, object]:
    """``match`` on two images' features (``keypoints``, ``descriptors``)
    with the configuration's matcher options ``conf``."""
    return match(sd, f0["keypoints"], f1["keypoints"], f0["descriptors"], f1["descriptors"],
                 size0, size1, n_layers=int(conf["n_layers"]),
                 depth_confidence=float(conf["depth_confidence"]),
                 width_confidence=float(conf["width_confidence"]),
                 pruning_min_kpts=int(conf.get("pruning_min_kpts", 1536)),
                 filter_threshold=float(conf["filter_threshold"]), rnd=rnd)
