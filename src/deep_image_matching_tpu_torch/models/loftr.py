"""LoFTR detector-free matcher (port of ``deep_image_matching_tpu/models/loftr.py``).

- ResNetFPN_8_2 backbone: a 7x7 stride-2 stem, three stages of two basic
  blocks (widths 128, 196, 256; BatchNorm folded at load), and the FPN back
  to 1/2 resolution through align-corners bilinear upsampling
  (``ops/deform.upsample_bilinear_align``, the JAX package's resize
  arithmetic) -> coarse features (B, H/8, W/8, 256) and fine features
  (B, H/2, W/2, 128);
- the 2D sine position encoding, with and without ``temp_bug_fix``;
- 4 x (self, cross) coarse layers of elu+1 linear attention at d = 256 with
  8 heads;
- the dual-softmax coarse matching (temperature 0.1, border removal, mutual
  nearest neighbours, threshold), dense (``coarse_match``) or streamed over
  row blocks without the (L, S) confidence (``coarse_match_blocked``); the
  top ``max_matches`` rows by confidence with ``jax.lax.top_k``'s tie rule
  (a stable sort: lower index first);
- 5 x 5 fine windows gathered at the matched cells with the coarse feature
  merged in, 1 x (self, cross) fine layer at d = 128, and the soft-argmax
  offset of image 1's window (``fine_refine``).

Activations are NHWC and batch-first, as in the JAX package. Parameters are
dicts of tensors in torch layouts (convolutions OIHW, linear layers (out,
in)) with the JAX package's tree structure, filled by
``convert.loftr_params_from_jax`` or ``convert.loftr_params_from_torch``.
None of it is a hand-written kernel: the JAX package runs it outside Pallas
too. ``compute_dtype`` float32 (the default) runs every convolution and
product in full f32 (``utils/device.full_f32``); bfloat16 runs the backbone
and the coarse transformer in bf16 and the matching and the fine stage in
f32, with the fine stage's weights rounded to bf16 as the JAX package's are.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.deform import upsample_bilinear_align
from ..utils.device import full_f32
from .vgg_refiner import conv_nhwc

Params = Dict

D_COARSE = 256
D_FINE = 128
NHEAD = 8
FINE_WINDOW = 5
BLOCK_DIMS = (128, 196, 256)
N_COARSE_LAYERS = 8
N_FINE_LAYERS = 2


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _he_conv(gen: torch.Generator, k: int, ci: int, co: int, bias: bool = True) -> Dict:
    out = {"w": torch.randn(co, ci, k, k, generator=gen) * np.sqrt(2.0 / (ci * k * k))}
    if bias:
        out["b"] = torch.zeros(co)
    return out


def _lin(gen: torch.Generator, ci: int, co: int, bias: bool = True) -> Dict:
    out = {"w": torch.randn(co, ci, generator=gen) / np.sqrt(ci)}
    if bias:
        out["b"] = torch.zeros(co)
    return out


def _block(gen: torch.Generator, ci: int, co: int, down: bool = False) -> Dict:
    p = {"conv1": _he_conv(gen, 3, ci, co), "conv2": _he_conv(gen, 3, co, co)}
    if down:
        p["down"] = _he_conv(gen, 1, ci, co)
    return p


def _init_encoder_layers(gen: torch.Generator, d: int, n: int) -> list:
    """``n`` encoder layers of width ``d``: bias-free q, k, v, merge and MLP
    (2d -> 2d -> d) projections, identity layer norms."""
    def enc():
        return {"q": _lin(gen, d, d, False), "k": _lin(gen, d, d, False),
                "v": _lin(gen, d, d, False), "merge": _lin(gen, d, d, False),
                "mlp1": _lin(gen, 2 * d, 2 * d, False), "mlp2": _lin(gen, 2 * d, d, False),
                "ln1": {"g": torch.ones(d), "b": torch.zeros(d)},
                "ln2": {"g": torch.ones(d), "b": torch.zeros(d)}}
    return [enc() for _ in range(n)]


def init_params(generator: torch.Generator) -> Params:
    """Random weights at the published shapes, drawn from ``generator``:
    He-normal convolutions with zero biases (a folded BatchNorm's), linear
    layers at 1 / sqrt(fan-in), identity layer norms."""
    g = generator
    d1, d2, d3 = BLOCK_DIMS
    backbone = {
        "conv1": _he_conv(g, 7, 1, 128),
        "layer1": [_block(g, 128, d1), _block(g, d1, d1)],
        "layer2": [_block(g, d1, d2, down=True), _block(g, d2, d2)],
        "layer3": [_block(g, d2, d3, down=True), _block(g, d3, d3)],
        "l3_out": _he_conv(g, 1, d3, d3, False),
        "l2_out": _he_conv(g, 1, d2, d3, False),
        "l2_out2a": _he_conv(g, 3, d3, d3),
        "l2_out2b": _he_conv(g, 3, d3, d2),
        "l1_out": _he_conv(g, 1, d1, d2, False),
        "l1_out2a": _he_conv(g, 3, d2, d2),
        "l1_out2b": _he_conv(g, 3, d2, d1),
    }
    return {
        "backbone": backbone,
        "coarse": _init_encoder_layers(g, D_COARSE, N_COARSE_LAYERS),
        "fine_pre": {"down_proj": _lin(g, D_COARSE, D_FINE),
                     "merge_feat": _lin(g, 2 * D_FINE, D_FINE)},
        "fine": _init_encoder_layers(g, D_FINE, N_FINE_LAYERS),
    }


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


def prepare(params: Params, compute_dtype: torch.dtype) -> Params:
    """The tree ``match_pair`` runs in ``compute_dtype``, made once per model:
    in bf16 the backbone and the coarse layers in bf16, and the fine stage
    in f32 from bf16-rounded weights (the JAX package casts the whole tree
    to bf16 and the fine stage's back)."""
    if params.get("dtype") == compute_dtype:
        return params
    if "dtype" in params:
        raise ValueError(f"parameters prepared for {params['dtype']}, not {compute_dtype}")
    out = dict(params, dtype=compute_dtype)
    if compute_dtype != torch.float32:
        for k in ("backbone", "coarse"):
            out[k] = _map_tree(params[k], lambda v: v.to(compute_dtype))
        for k in ("fine_pre", "fine"):
            out[k] = _map_tree(params[k], lambda v: v.to(compute_dtype).float())
    return out


# ---------------------------------------------------------------------------
# Backbone
# ---------------------------------------------------------------------------

def _conv(x: torch.Tensor, p: Dict, stride: int = 1) -> torch.Tensor:
    k = p["w"].shape[-1]
    return conv_nhwc(x, p["w"], p.get("b"), padding=(k - 1) // 2, stride=stride)


def _basic_block(x, p, stride):
    y = F.relu(_conv(x, p["conv1"], stride))
    y = _conv(y, p["conv2"])
    sc = _conv(x, p["down"], stride) if "down" in p else x
    return F.relu(sc + y)


def _resnet_fpn(bp: Dict, images: torch.Tensor, act: Callable) -> Tuple[torch.Tensor, ...]:
    """The stem, the three stages and the FPN with ``act`` after its
    3x3 convolutions; returns (the 1/8 map after ``l3_out``, the 1/2 map)."""
    x0 = F.relu(_conv(images, bp["conv1"], stride=2))
    x1 = _basic_block(x0, bp["layer1"][0], 1)
    x1 = _basic_block(x1, bp["layer1"][1], 1)
    x2 = _basic_block(x1, bp["layer2"][0], 2)
    x2 = _basic_block(x2, bp["layer2"][1], 1)
    x3 = _basic_block(x2, bp["layer3"][0], 2)
    x3 = _basic_block(x3, bp["layer3"][1], 1)
    x3_out = _conv(x3, bp["l3_out"])
    x3_up = upsample_bilinear_align(x3_out, 2).to(x3_out.dtype)
    x2_out = _conv(x2, bp["l2_out"])
    x2_out = _conv(act(_conv(x2_out + x3_up, bp["l2_out2a"])), bp["l2_out2b"])
    x2_up = upsample_bilinear_align(x2_out, 2).to(x2_out.dtype)
    x1_out = _conv(x1, bp["l1_out"])
    x1_out = _conv(act(_conv(x1_out + x2_up, bp["l1_out2a"])), bp["l1_out2b"])
    return x3_out, x1_out


def _leaky(x):
    return F.leaky_relu(x, 0.01)


def backbone_forward(params: Params, images: torch.Tensor):
    """images (B, H, W, 1), H and W multiples of 8 -> (coarse (B, H/8, W/8,
    256), fine (B, H/2, W/2, 128)); LeakyReLU in the FPN."""
    return _resnet_fpn(params["backbone"], images, _leaky)


# ---------------------------------------------------------------------------
# Position encoding + transformer
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def sine_pos_encoding(Hc: int, Wc: int, d_model: int, temp_bug_fix: bool,
                      device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """(Hc, Wc, d_model) 2D sinusoidal encoding, computed in numpy f32 as the
    JAX package computes it (without ``temp_bug_fix`` the exponent's floor
    division of the original code)."""
    y = np.arange(1, Hc + 1, dtype=np.float32)[:, None, None]
    x = np.arange(1, Wc + 1, dtype=np.float32)[None, :, None]
    if temp_bug_fix:
        div = np.exp(np.arange(0, d_model // 2, 2, dtype=np.float32)
                     * (-np.log(10000.0) / (d_model // 2)))
    else:
        div = np.exp(np.arange(0, d_model // 2, 2, dtype=np.float32)
                     * (-np.log(10000.0) / d_model // 2))
    pe = np.zeros((Hc, Wc, d_model), np.float32)
    pe[:, :, 0::4] = np.sin(x * div)
    pe[:, :, 1::4] = np.cos(x * div)
    pe[:, :, 2::4] = np.sin(y * div)
    pe[:, :, 3::4] = np.cos(y * div)
    return torch.from_numpy(pe).to(device)


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` as a true division on every device (CUDA turns a division
    by a Python scalar into a product with its reciprocal)."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


def _linear(x: torch.Tensor, p: Dict) -> torch.Tensor:
    return F.linear(x, p["w"], p.get("b"))


def _layernorm(x: torch.Tensor, p: Dict) -> torch.Tensor:
    y = F.layer_norm(x.float(), (x.shape[-1],), p["g"].float(), p["b"].float(), eps=1e-5)
    return y.to(x.dtype)


def linear_attention(q, k, v, q_mask=None, kv_mask=None, eps: float = 1e-6):
    """(B, L, H, D) linear attention with elu+1 feature maps; products
    accumulate in f32, the output is in ``q``'s dtype."""
    Q = F.elu(q) + 1.0
    K = F.elu(k) + 1.0
    if q_mask is not None:
        Q = Q * q_mask[:, :, None, None].to(Q.dtype)
    if kv_mask is not None:
        K = K * kv_mask[:, :, None, None].to(K.dtype)
        v = v * kv_mask[:, :, None, None].to(v.dtype)
    v_len = v.shape[1]
    v = _div(v, float(v_len))
    KV = torch.einsum("nshd,nshv->nhdv", K.float(), v.float())
    Z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q.float(), K.sum(dim=1).float()) + eps)
    out = torch.einsum("nlhd,nhdv->nlhv", Q.float(), KV) * Z[..., None] * v_len
    return out.to(q.dtype)


def _enc_layer(x, source, p, x_mask, src_mask, nhead):
    B, L, C = x.shape
    d = C // nhead
    q = _linear(x, p["q"]).reshape(B, L, nhead, d)
    k = _linear(source, p["k"]).reshape(B, -1, nhead, d)
    v = _linear(source, p["v"]).reshape(B, -1, nhead, d)
    msg = linear_attention(q, k, v, x_mask, src_mask).reshape(B, L, C)
    msg = _layernorm(_linear(msg, p["merge"]), p["ln1"])
    h = F.relu(_linear(torch.cat([x, msg], dim=-1), p["mlp1"]))
    msg = _layernorm(_linear(h, p["mlp2"]), p["ln2"])
    return x + msg


def transformer(feats0, feats1, layers, mask0=None, mask1=None, nhead: int = NHEAD):
    """Alternating self / cross layers (the list is [self, cross, ...])."""
    for i, p in enumerate(layers):
        if i % 2 == 0:
            feats0 = _enc_layer(feats0, feats0, p, mask0, mask0, nhead)
            feats1 = _enc_layer(feats1, feats1, p, mask1, mask1, nhead)
        else:
            f0 = _enc_layer(feats0, feats1, p, mask0, mask1, nhead)
            f1 = _enc_layer(feats1, feats0, p, mask1, mask0, nhead)
            feats0, feats1 = f0, f1
    return feats0, feats1


# ---------------------------------------------------------------------------
# Matching
# ---------------------------------------------------------------------------

def _border_mask(h: int, w: int, border_rm: int, device) -> torch.Tensor:
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    ok = (ys >= border_rm) & (ys < h - border_rm) & (xs >= border_rm) & (xs < w - border_rm)
    return ok.reshape(-1)


def _top_rows(row_conf: torch.Tensor, j_best: torch.Tensor, max_matches: int):
    """The ``max_matches`` rows of highest confidence, ties to the lower row
    (``jax.lax.top_k``'s rule, by a stable sort)."""
    k = min(max_matches, row_conf.shape[1])
    top, i_ids = torch.sort(row_conf, dim=1, descending=True, stable=True)
    top, i_ids = top[:, :k], i_ids[:, :k]
    return i_ids, torch.gather(j_best, 1, i_ids), top, top > 0.0


def coarse_match(fc0, fc1, hw0, hw1, max_matches: int, threshold: float = 0.2,
                 temperature: float = 0.1, border_rm: int = 2):
    """Dual-softmax coarse matching with border removal and mutual nearest
    neighbours on the dense (B, L, S) confidence; returns (i_ids, j_ids,
    confidence, valid), each (B, min(max_matches, L))."""
    B, L, C = fc0.shape
    f0 = _div(fc0, C ** 0.5).float()
    f1 = _div(fc1, C ** 0.5).float()
    sim = _div(torch.einsum("nlc,nsc->nls", f0, f1), temperature)
    # the column softmax as exp(x - max) / sum, jax.nn.softmax's arithmetic:
    # torch's softmax over the strided dim took 20 ms a pair at 1024 px on
    # the card, most of it outside the memory traffic
    conf = sim - sim.amax(dim=1, keepdim=True)
    conf.exp_()
    conf.div_(conf.sum(dim=1, keepdim=True))
    conf.mul_(torch.softmax(sim, dim=2))
    del sim
    ok = (_border_mask(*hw0, border_rm, fc0.device)[None, :, None]
          & _border_mask(*hw1, border_rm, fc0.device)[None, None, :])
    mask = conf == conf.amax(dim=2, keepdim=True)
    mask &= conf == conf.amax(dim=1, keepdim=True)
    mask &= conf > threshold
    mask &= ok
    row_conf, j_best = torch.where(mask, conf, 0.0).max(dim=2)
    return _top_rows(row_conf, j_best, max_matches)


def coarse_match_blocked(fc0, fc1, hw0, hw1, max_matches: int, threshold: float = 0.2,
                         temperature: float = 0.1, border_rm: int = 2, block: int = 2048):
    """``coarse_match``'s semantics without the (L, S) confidence: two passes
    over row blocks of the similarity, recomputing each block's product.
    Pass 1 takes the row logsumexps and accumulates the column ones online;
    pass 2 takes ``2 sim - row_lse - col_lse`` per block, each row's
    (argmax, max) and each column's running (argmax, max), the earlier block
    winning ties. A row is mutual where its argmax column's argmax is the row
    (mutual on the unmasked confidence, threshold and border after)."""
    B, L, C = fc0.shape
    S = fc1.shape[1]
    dev = fc0.device
    f0 = fc0.float() * (1.0 / (C * temperature))
    f1t = fc1.float().transpose(1, 2)
    nb = -(-L // block)
    Lp = nb * block
    f0p = F.pad(f0, (0, 0, 0, Lp - L))
    row_real = torch.arange(Lp, device=dev) < L
    ok0 = F.pad(_border_mask(*hw0, border_rm, dev), (0, Lp - L))
    ok1 = _border_mask(*hw1, border_rm, dev)
    NEG = -1e30

    def sim_block(b):
        sl = slice(b * block, (b + 1) * block)
        sim = torch.bmm(f0p[:, sl], f1t)
        return torch.where(row_real[sl][None, :, None], sim, NEG)

    cmax = torch.full((B, S), NEG, device=dev)
    csum = torch.zeros((B, S), device=dev)
    rlse = []
    for b in range(nb):
        sim = sim_block(b)
        rmax = sim.amax(dim=2)
        rsum = torch.exp(sim - rmax[..., None]).sum(dim=2)
        rlse.append(rmax + torch.log(rsum))
        ncmax = torch.maximum(cmax, sim.amax(dim=1))
        csum = csum * torch.exp(cmax - ncmax) + torch.exp(sim - ncmax[:, None]).sum(dim=1)
        cmax = ncmax
    clse = cmax + torch.log(csum)

    colmax = torch.full((B, S), NEG, device=dev)
    colarg = torch.zeros((B, S), dtype=torch.long, device=dev)
    jstar, rbest = [], []
    for b in range(nb):
        logconf = 2.0 * sim_block(b) - rlse[b][:, :, None] - clse[:, None, :]
        rb, js = logconf.max(dim=2)
        jstar.append(js)
        rbest.append(rb)
        bmax, barg = logconf.max(dim=1)
        upd = bmax > colmax
        colmax = torch.where(upd, bmax, colmax)
        colarg = torch.where(upd, barg + b * block, colarg)
    jstar = torch.cat(jstar, dim=1)
    conf = torch.exp(torch.cat(rbest, dim=1))
    mutual = torch.gather(colarg, 1, jstar) == torch.arange(Lp, device=dev)
    valid = mutual & (conf > threshold) & ok0 & ok1[jstar] & row_real
    row_conf = torch.where(valid, conf, 0.0)[:, :L]
    return _top_rows(row_conf, jstar[:, :L], max_matches)


def _gather_windows(fmap, ids, wc: int, window: int, stride: int):
    """(B, M, window^2, C) windows of the fine map around each matched
    cell's centre (cell * stride), zeros outside the map."""
    B, Hf, Wf, C = fmap.shape
    r = window // 2
    o = torch.arange(window, device=fmap.device) - r
    ys = ((ids // wc) * stride)[..., None, None] + o[:, None]
    xs = ((ids % wc) * stride)[..., None, None] + o[None, :]
    ok = (ys >= 0) & (ys < Hf) & (xs >= 0) & (xs < Wf)
    idx = ys.clamp(0, Hf - 1) * Wf + xs.clamp(0, Wf - 1)
    M = ids.shape[1]
    vals = torch.gather(fmap.reshape(B, Hf * Wf, C), 1,
                        idx.reshape(B, -1, 1).expand(-1, -1, C))
    vals = vals.reshape(B, M, window * window, C)
    return torch.where(ok.reshape(B, M, -1, 1), vals, 0.0)


def fine_refine(params, ff0, ff1, fc0, fc1, i_ids, j_ids, hw0_c, hw1_c,
                window: int = FINE_WINDOW, stride: int = 4, nhead: int = NHEAD):
    """Fine windows at the matched cells, the fine transformer, and the
    soft-argmax offset of image 1's window around its centre; returns
    (B, M, 2) offsets (dx, dy) in fine-map pixels."""
    B, M = i_ids.shape
    Cf = ff0.shape[-1]
    WW = window * window
    r = window // 2
    pre = params["fine_pre"]

    def windows(ff, fc, ids, wc):
        w = _gather_windows(ff, ids, wc, window, stride)
        c = _linear(torch.gather(fc, 1, ids[..., None].expand(-1, -1, fc.shape[-1])),
                    pre["down_proj"])
        return _linear(torch.cat([w, c[:, :, None].expand(-1, -1, WW, -1)], dim=-1),
                       pre["merge_feat"]).reshape(B * M, WW, Cf)

    w0 = windows(ff0, fc0, i_ids, hw0_c[1])
    w1 = windows(ff1, fc1, j_ids, hw1_c[1])
    w0, w1 = transformer(w0, w1, params["fine"], None, None, nhead)
    sim = torch.einsum("mc,mrc->mr", w0[:, WW // 2], w1)
    heat = torch.softmax(_div(sim, Cf ** 0.5), dim=1)
    o = torch.arange(window, device=ff0.device, dtype=torch.float32) - r
    gy = _div(o[:, None].expand(window, window).reshape(-1), float(r))
    gx = _div(o[None, :].expand(window, window).reshape(-1), float(r))
    ex = (heat * gx[None]).sum(dim=1)
    ey = (heat * gy[None]).sum(dim=1)
    return (torch.stack([ex, ey], dim=1) * r).reshape(B, M, 2)


def _to_unit(images: torch.Tensor) -> torch.Tensor:
    if images.dtype == torch.uint8:
        return _div(images.float(), 255.0)
    return images


def match_with_backbone(params: Params, backbone: Callable, images0, images1,
                        max_matches: int = 2048, threshold: float = 0.2,
                        temp_bug_fix: bool = False, compute_dtype=torch.float32,
                        coarse_impl: str = "dense", temperature: float = 0.1):
    """The matching of LoFTR and SE2-LoFTR on ``backbone``'s features:
    position encoding, the coarse transformer, coarse matching and the fine
    refinement; returns the JAX package's outputs (keypoints in the
    processed images' pixels, zero where not valid)."""
    if coarse_impl not in ("dense", "blocked"):
        raise ValueError(f"coarse_impl must be 'dense' or 'blocked', not {coarse_impl!r}")
    params = prepare(params, compute_dtype)
    with full_f32():
        images0 = _to_unit(images0).to(compute_dtype)
        images1 = _to_unit(images1).to(compute_dtype)
        B = images0.shape[0]
        fc0_map, ff0 = backbone(params, images0)
        fc1_map, ff1 = backbone(params, images1)
        h0c, w0c = fc0_map.shape[1:3]
        h1c, w1c = fc1_map.shape[1:3]
        dev = fc0_map.device
        pe0 = sine_pos_encoding(h0c, w0c, D_COARSE, temp_bug_fix, dev).to(fc0_map.dtype)
        pe1 = sine_pos_encoding(h1c, w1c, D_COARSE, temp_bug_fix, dev).to(fc1_map.dtype)
        fc0 = (fc0_map + pe0[None]).reshape(B, h0c * w0c, D_COARSE)
        fc1 = (fc1_map + pe1[None]).reshape(B, h1c * w1c, D_COARSE)
        fc0, fc1 = transformer(fc0, fc1, params["coarse"], None, None, NHEAD)
        fc0, fc1, ff0, ff1 = fc0.float(), fc1.float(), ff0.float(), ff1.float()
        matcher = coarse_match_blocked if coarse_impl == "blocked" else coarse_match
        i_ids, j_ids, conf, valid = matcher(fc0, fc1, (h0c, w0c), (h1c, w1c), max_matches,
                                            threshold, temperature)
        offsets1 = fine_refine(params, ff0, ff1, fc0, fc1, i_ids, j_ids, (h0c, w0c), (h1c, w1c))
    # coarse cells -> pixels (scale 8); fine offsets are fine-map pixels
    # (scale 2)
    x0 = (i_ids % w0c).float() * 8.0
    y0 = torch.div(i_ids, w0c, rounding_mode="floor").float() * 8.0
    x1 = (j_ids % w1c).float() * 8.0 + offsets1[..., 0] * 2.0
    y1 = torch.div(j_ids, w1c, rounding_mode="floor").float() * 8.0 + offsets1[..., 1] * 2.0
    v = valid[..., None]
    return {
        "keypoints0": torch.where(v, torch.stack([x0, y0], dim=-1), 0.0),
        "keypoints1": torch.where(v, torch.stack([x1, y1], dim=-1), 0.0),
        "confidence": torch.where(valid, conf, 0.0),
        "mask": valid,
    }


def match_pair(params: Params, images0: torch.Tensor, images1: torch.Tensor,
               max_matches: int = 2048, threshold: float = 0.2, temp_bug_fix: bool = False,
               compute_dtype=torch.float32, coarse_impl: str = "dense",
               temperature: float = 0.1) -> Dict[str, torch.Tensor]:
    """LoFTR on a batch of pairs: images (B, H, W, 1) uint8 or in [0, 1],
    H and W multiples of 8; every input in one batch has one shape per side."""
    return match_with_backbone(params, backbone_forward, images0, images1, max_matches,
                               threshold, temp_bug_fix, compute_dtype, coarse_impl, temperature)
