"""RDD, the Robust Dense Detector's sparse extractor (PyTorch port of
``deep_image_matching_tpu/models/rdd.py``).

- detector: ALIKE-style ConvBlock + ResBlocks (widths 8/16/32/64, ReLU,
  max-pools), the four-scale aggregation with align-corners upsampling and
  a 1x1 + sigmoid score map; detection is the shared DKD (radius 2,
  ``models/aliked.dkd_detect``);
- descriptor: a ResNet-50 (its frozen BatchNorms folded) whose levels 1-4
  plus one stride-2 extra level are projected to 256 channels (1x1 or 3x3
  convolution + GroupNorm(32)), DETR sine position embeddings plus per-level
  embeddings, 4 multi-scale deformable-attention encoder layers (8 heads,
  8 points, 5 levels), the levels summed onto the stride-4 map with
  align-corners upsampling, and the matchability head.

The parameters are the folded form the JAX package holds, as nested dicts of
tensors: convolution weights (out, in, kh, kw), linear weights (out, in).
The BatchNorms fold in numpy f32 when a checkpoint loads
(``params_from_torch``). Images and maps at the public functions are NHWC,
as in the JAX package; the convolutions run NCHW.

The deformable attention samples each level with ``F.grid_sample`` (zeros
outside, ``align_corners=False``: the sample of normalised location ``loc``
sits at pixel ``loc * W - 0.5``, the convention of the JAX package's
``bilinear_sample_zeropad`` there) and accumulates level by level, so the
sampled values of one level at a time are held (about 715 MB at 1024 px).
The JAX package runs all of RDD in XLA, outside any Pallas kernel, and so
does this port: cuDNN's convolutions and cuBLAS's products, in full f32
(``utils/device.full_f32``) since TF32 moved other extractors' keypoints
off the CPU's.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.deform import resize_bilinear_align, upsample_bilinear_align
from ..utils.device import full_f32
from .aliked import dkd_detect
from .vgg_refiner import IMAGENET_MEAN, IMAGENET_STD

Params = Dict

D_MODEL = 256
N_HEADS = 8
N_POINTS = 8
N_LEVELS = 5
N_ENC_LAYERS = 4
D_FFN = 1024
BLOCK_DIMS = [8, 16, 32, 64]
_BN_EPS = 1e-5

# ResNet-50 stages: (n_blocks, mid_channels, out_channels, stride)
_R50_STAGES = [(3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2), (3, 512, 2048, 2)]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def params_from_torch(state_dict) -> Params:
    """An upstream RDD state dict (``detector.*`` and ``descriptor.*``) in the
    port's folded form. The folds run in numpy f32, the JAX package's
    arithmetic, so both packages hold the same bits."""
    sd = {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
          for k, v in state_dict.items() if not k.endswith("num_batches_tracked")}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    def folded(conv, bn):
        # the conv's own bias is dropped, as upstream's FrozenBatchNorm
        # convolutions carry none
        s = sd[f"{bn}.weight"] / np.sqrt(sd[f"{bn}.running_var"] + _BN_EPS)
        w = sd[f"{conv}.weight"] * s[:, None, None, None]
        return {"w": t(w), "b": t((0.0 - sd[f"{bn}.running_mean"]) * s + sd[f"{bn}.bias"])}

    def plain(key, bias=True):
        out = {"w": t(sd[f"{key}.weight"])}
        if bias and f"{key}.bias" in sd:
            out["b"] = t(sd[f"{key}.bias"])
        return out

    def ln(key):
        return {"g": t(sd[f"{key}.weight"]), "b": t(sd[f"{key}.bias"])}

    def head_layer(i):
        # conv without bias + affine-free BatchNorm; the JAX package scales
        # the weight in f64 (its unit gain is an f64 array) and rounds once
        p = f"descriptor.matchibility_head.{i}.layer"
        root = np.sqrt(sd[f"{p}.1.running_var"] + 1e-5)
        w = sd[f"{p}.0.weight"]
        s = np.ones(w.shape[0]) / root
        return {"w": t(w * s[:, None, None, None]), "b": t(-sd[f"{p}.1.running_mean"] / root)}

    det = "detector"
    detector = {"block1": {"conv1": folded(f"{det}.block1.conv1", f"{det}.block1.bn1"),
                           "conv2": folded(f"{det}.block1.conv2", f"{det}.block1.bn2")}}
    for b in (2, 3, 4):
        detector[f"block{b}"] = {"conv1": folded(f"{det}.block{b}.conv1", f"{det}.block{b}.bn1"),
                                 "conv2": folded(f"{det}.block{b}.conv2", f"{det}.block{b}.bn2"),
                                 "down": plain(f"{det}.block{b}.downsample")}
    detector["agg"] = {f"conv{i}": plain(f"{det}.conv{i}", bias=False) for i in range(1, 5)}
    detector["head"] = plain(f"{det}.convhead2.0", bias=False)

    body = "descriptor.backbone.0.body"
    resnet = {"stem": folded(f"{body}.conv1", f"{body}.bn1"), "stages": []}
    for si, (n_blocks, _, _, _) in enumerate(_R50_STAGES):
        blocks = []
        for bi in range(n_blocks):
            p = f"{body}.layer{si + 1}.{bi}"
            blk = {f"conv{j}": folded(f"{p}.conv{j}", f"{p}.bn{j}") for j in (1, 2, 3)}
            if f"{p}.downsample.0.weight" in sd:
                blk["down"] = folded(f"{p}.downsample.0", f"{p}.downsample.1")
            blocks.append(blk)
        resnet["stages"].append(blocks)

    projs = [{"conv": plain(f"descriptor.input_proj.{i}.0"),
              "gn": ln(f"descriptor.input_proj.{i}.1")} for i in range(N_LEVELS)]
    encoder = []
    for i in range(N_ENC_LAYERS):
        p = f"descriptor.transformer.encoder.layers.{i}"
        encoder.append({
            "sampling_offsets": plain(f"{p}.self_attn.sampling_offsets"),
            "attention_weights": plain(f"{p}.self_attn.attention_weights"),
            "value_proj": plain(f"{p}.self_attn.value_proj"),
            "output_proj": plain(f"{p}.self_attn.output_proj"),
            "ln1": ln(f"{p}.norm1"), "fc1": plain(f"{p}.linear1"),
            "fc2": plain(f"{p}.linear2"), "ln2": ln(f"{p}.norm2"),
        })
    return {
        "detector": detector,
        "resnet": resnet,
        "projs": projs,
        "level_embed": t(sd["descriptor.transformer.level_embed"]),
        "encoder": encoder,
        "match_head": {"l0": head_layer(0), "l1": head_layer(1),
                       "out": plain("descriptor.matchibility_head.2")},
    }


def init_params(generator: torch.Generator) -> Params:
    """Random weights in the folded form, drawn from ``generator``: He-normal
    convolutions, 1/sqrt(fan-in) linear layers, zero biases, unit norms."""

    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    def conv(k, ci, co, bias=True):
        out = {"w": normal((co, ci, k, k), float(np.sqrt(2.0 / (ci * k * k))))}
        if bias:
            out["b"] = torch.zeros(co)
        return out

    def lin(ci, co):
        return {"w": normal((co, ci), float(1 / np.sqrt(ci))), "b": torch.zeros(co)}

    def norm(n):
        return {"g": torch.ones(n), "b": torch.zeros(n)}

    detector = {"block1": {"conv1": conv(3, 3, 8), "conv2": conv(3, 8, 8)}}
    cin = 8
    for b, co in zip((2, 3, 4), BLOCK_DIMS[1:]):
        detector[f"block{b}"] = {"conv1": conv(3, cin, co), "conv2": conv(3, co, co),
                                 "down": conv(1, cin, co)}
        cin = co
    detector["agg"] = {f"conv{i}": conv(1, c, 32, False)
                       for i, c in enumerate(BLOCK_DIMS, 1)}
    detector["head"] = conv(1, 128, 1, False)
    resnet = {"stem": conv(7, 3, 64), "stages": []}
    cin = 64
    for n_blocks, mid, cout, _ in _R50_STAGES:
        blocks = []
        for bi in range(n_blocks):
            blk = {"conv1": conv(1, cin if bi == 0 else cout, mid), "conv2": conv(3, mid, mid),
                   "conv3": conv(1, mid, cout)}
            if bi == 0:
                blk["down"] = conv(1, cin, cout)
            blocks.append(blk)
        resnet["stages"].append(blocks)
        cin = cout
    proj_in = [256, 512, 1024, 2048, 2048]
    projs = [{"conv": conv(1 if i < 4 else 3, proj_in[i], D_MODEL), "gn": norm(D_MODEL)}
             for i in range(N_LEVELS)]
    encoder = [{"sampling_offsets": lin(D_MODEL, N_HEADS * N_LEVELS * N_POINTS * 2),
                "attention_weights": lin(D_MODEL, N_HEADS * N_LEVELS * N_POINTS),
                "value_proj": lin(D_MODEL, D_MODEL), "output_proj": lin(D_MODEL, D_MODEL),
                "ln1": norm(D_MODEL), "fc1": lin(D_MODEL, D_FFN), "fc2": lin(D_FFN, D_MODEL),
                "ln2": norm(D_MODEL)} for _ in range(N_ENC_LAYERS)]
    return {"detector": detector, "resnet": resnet, "projs": projs,
            "level_embed": normal((N_LEVELS, D_MODEL), 1.0), "encoder": encoder,
            "match_head": {"l0": conv(1, 256, 128), "l1": conv(1, 128, 64),
                           "out": conv(1, 64, 1)}}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _conv(x: torch.Tensor, p, stride: int = 1) -> torch.Tensor:
    """Convolution of NCHW ``x``, padded by (k - 1) // 2 on each side."""
    w = p["w"]
    return F.conv2d(x, w, p.get("b"), stride=stride, padding=(w.shape[-1] - 1) // 2)


def _linear(x: torch.Tensor, p) -> torch.Tensor:
    return F.linear(x, p["w"], p.get("b"))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


@torch.no_grad()
def detector_scoremap(params: Params, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1], H and W multiples of 32 -> the sigmoid score
    map (B, H, W)."""
    p = params["detector"]
    x = images.permute(0, 3, 1, 2)
    x1 = F.relu(_conv(F.relu(_conv(x, p["block1"]["conv1"])), p["block1"]["conv2"]))

    def res(x, bp):
        out = _conv(F.relu(_conv(x, bp["conv1"])), bp["conv2"])
        return F.relu(out + _conv(x, bp["down"]))

    x2 = res(F.max_pool2d(x1, 2), p["block2"])
    x3 = res(F.max_pool2d(x2, 4), p["block3"])
    x4 = res(F.max_pool2d(x3, 4), p["block4"])
    a = p["agg"]
    xa = [_nhwc(F.relu(_conv(t, a[f"conv{i}"]))) for i, t in enumerate((x1, x2, x3, x4), 1)]
    x1234 = torch.cat([xa[0]] + [upsample_bilinear_align(t, f)
                                 for t, f in zip(xa[1:], (2, 8, 32))], dim=-1)
    return torch.sigmoid(_conv(x1234.permute(0, 3, 1, 2), p["head"]))[:, 0]


def _resnet_forward(params: Params, x: torch.Tensor) -> List[torch.Tensor]:
    """NCHW images -> the outputs of the four stages (NCHW)."""
    x = F.relu(_conv(x, params["stem"], stride=2))
    x = F.max_pool2d(x, 3, 2, 1)          # torch's padding is -inf
    outs = []
    for si, blocks in enumerate(params["stages"]):
        for bi, bp in enumerate(blocks):
            s = _R50_STAGES[si][3] if bi == 0 else 1
            out = F.relu(_conv(x, bp["conv1"]))
            out = F.relu(_conv(out, bp["conv2"], stride=s))
            out = _conv(out, bp["conv3"])
            identity = _conv(x, bp["down"], stride=s) if "down" in bp else x
            x = F.relu(out + identity)
        outs.append(x)
    return outs


def _group_norm(x: torch.Tensor, g, b, groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of NCHW ``x`` with the JAX package's two-pass variance."""
    B, C, H, W = x.shape
    xg = x.reshape(B, groups, C // groups, H, W)
    mu = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = ((xg - mu) ** 2).mean(dim=(2, 3, 4), keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return xg.reshape(B, C, H, W) * g[:, None, None] + b[:, None, None]


@lru_cache(maxsize=64)
def _sine_axis(n: int, num_pos_feats: int = 128, temperature: float = 10000.0) -> np.ndarray:
    """The normalised DETR sine embedding of one axis of n positions (n,
    num_pos_feats), built in numpy f64 and rounded once to f32, so the CPU
    and the card hold the same table (torch's and XLA's f32 ``pow`` may
    differ by an ulp)."""
    pos = (np.arange(1, n + 1, dtype=np.float64) - 0.5) / n * (2 * np.pi)
    i = np.arange(num_pos_feats, dtype=np.float64)
    p = pos[:, None] / temperature ** (2 * (i // 2) / num_pos_feats)
    return np.stack([np.sin(p[:, 0::2]), np.cos(p[:, 1::2])], -1).reshape(n, -1).astype(np.float32)


def sine_pos_embed(h: int, w: int, device=None) -> torch.Tensor:
    """(h, w, 256) f32 position embedding of an h x w level: the y table
    then the x table of each position. Only the two axis tables cross to
    the device; the broadcast happens there."""
    py = torch.from_numpy(_sine_axis(h)).to(device)
    px = torch.from_numpy(_sine_axis(w)).to(device)
    return torch.cat([py[:, None].expand(h, w, -1), px[None].expand(h, w, -1)], dim=-1)


def ms_deform_attn(query: torch.Tensor, value_levels: List[torch.Tensor],
                   ref_points: torch.Tensor, p, n_heads: int = N_HEADS,
                   n_points: int = N_POINTS) -> torch.Tensor:
    """Multi-scale deformable attention (upstream ``ms_deform_attn.py:82-125``).

    query (B, Lq, C); value_levels: per level the value-projected map
    (B, H_l, W_l, C); ref_points (B, Lq, 2) normalised (x, y) in [0, 1].
    Each level is sampled by ``F.grid_sample`` and its weighted sum added to
    the output before the next level is sampled."""
    B, Lq, C = query.shape
    hd = C // n_heads
    L = len(value_levels)
    off = _linear(query, p["sampling_offsets"]).reshape(B, Lq, n_heads, L, n_points, 2)
    attw = _linear(query, p["attention_weights"]).reshape(B, Lq, n_heads, L * n_points)
    attw = attw.softmax(-1).reshape(B, Lq, n_heads, L, n_points)
    out = None
    for lvl, v in enumerate(value_levels):
        H_l, W_l = v.shape[1:3]
        norm = torch.tensor([W_l, H_l], dtype=query.dtype, device=query.device)
        loc = ref_points[:, :, None, None, :] + off[:, :, :, lvl] / norm   # (B, Lq, h, P, 2)
        grid = (2.0 * loc - 1.0).permute(0, 2, 1, 3, 4).reshape(B * n_heads, Lq, n_points, 2)
        vm = v.reshape(B, H_l, W_l, n_heads, hd).permute(0, 3, 4, 1, 2)
        samp = F.grid_sample(vm.reshape(B * n_heads, hd, H_l, W_l), grid, mode="bilinear",
                             padding_mode="zeros", align_corners=False)  # (B h, hd, Lq, P)
        wl = attw[:, :, :, lvl].permute(0, 2, 1, 3).reshape(B * n_heads, 1, Lq, n_points)
        term = samp.mul_(wl).sum(-1)
        del samp
        out = term if out is None else out + term
    out = out.reshape(B, n_heads, hd, Lq).permute(0, 3, 1, 2).reshape(B, Lq, C)
    return _linear(out, p["output_proj"])


def _ln(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


@torch.no_grad()
def descriptor_forward(params: Params, images: torch.Tensor, with_matchability: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ImageNet-normalised (B, H, W, 3) -> (descriptor map (B, H/4, W/4, 256),
    matchability (B, H/4, W/4), or None without ``with_matchability``)."""
    feats = _resnet_forward(params["resnet"], images.permute(0, 3, 1, 2))
    srcs = []
    for i in range(N_LEVELS):
        pr = params["projs"][i]
        y = _conv(feats[i], pr["conv"]) if i < 4 else _conv(feats[3], pr["conv"], stride=2)
        srcs.append(_nhwc(_group_norm(y, pr["gn"]["g"], pr["gn"]["b"])))
    B = srcs[0].shape[0]
    dev = images.device
    shapes = [tuple(s.shape[1:3]) for s in srcs]
    pos, refs = [], []
    for lvl, (h, w) in enumerate(shapes):
        pos.append((sine_pos_embed(h, w, dev) + params["level_embed"][lvl]).reshape(h * w, -1))
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        refs.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    pos = torch.cat(pos)[None]
    refs = torch.cat(refs)[None].expand(B, -1, -1)
    x = torch.cat([s.reshape(B, -1, D_MODEL) for s in srcs], dim=1)
    starts = np.cumsum([0] + [h * w for h, w in shapes])
    for lp in params["encoder"]:
        v = _linear(x, lp["value_proj"])
        v_levels = [v[:, starts[i]:starts[i + 1]].reshape(B, *shapes[i], D_MODEL)
                    for i in range(N_LEVELS)]
        x = _ln(x + ms_deform_attn(x + pos, v_levels, refs, lp), lp["ln1"])
        x = _ln(x + _linear(F.relu(_linear(x, lp["fc1"])), lp["fc2"]), lp["ln2"])
    final = x[:, :starts[1]].reshape(B, *shapes[0], D_MODEL)
    for i in range(1, N_LEVELS):
        fl = x[:, starts[i]:starts[i + 1]].reshape(B, *shapes[i], D_MODEL)
        final = final + resize_bilinear_align(fl, shapes[0])
    if not with_matchability:
        return final, None
    mh = params["match_head"]
    m = F.relu(_conv(final.permute(0, 3, 1, 2), mh["l0"]))
    m = F.relu(_conv(m, mh["l1"]))
    return final, torch.sigmoid(_conv(m, mh["out"]))[:, 0]


@torch.no_grad()
def extract(params: Params, images: torch.Tensor, valid_hw: torch.Tensor,
            max_keypoints: int = 4096, detection_threshold: float = 0.01
            ) -> Dict[str, torch.Tensor]:
    """Batched RDD extraction of images (B, H, W, 3) in [0, 1] (or uint8),
    H and W multiples of 32, with the unpadded (h, w) per image. Keypoints
    are in pixels of the padded input; ``descriptors`` are zero on invalid
    rows. Runs in full f32."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    B, H, W, _ = images.shape
    with full_f32():
        score_map = detector_scoremap(params, images)
        kpts, scores, _, valid = dkd_detect(score_map, valid_hw, max_keypoints,
                                            detection_threshold, nms_radius=2)
        mean = torch.from_numpy(IMAGENET_MEAN).to(images.device)
        std = torch.from_numpy(IMAGENET_STD).to(images.device)
        desc_map, _ = descriptor_forward(params, (images - mean) / std,
                                         with_matchability=False)
    Hc, Wc = desc_map.shape[1:3]
    # the /4 map sampled at full-resolution coordinates normalised by (W - 1)
    gx = (2.0 * kpts[..., 0] / (W - 1) - 1.0 + 1.0) * Wc / 2.0 - 0.5
    gy = (2.0 * kpts[..., 1] / (H - 1) - 1.0 + 1.0) * Hc / 2.0 - 0.5
    from ..ops.deform import bilinear_sample_zeropad

    d = torch.stack([bilinear_sample_zeropad(dm, torch.stack([x, y], -1))
                     for dm, x, y in zip(desc_map, gx, gy)])
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp(min=1e-12)
    return {"keypoints": kpts, "scores": scores, "descriptors": d * valid[..., None],
            "mask": valid}
