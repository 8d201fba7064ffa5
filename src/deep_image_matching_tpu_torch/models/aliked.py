"""ALIKED detector and descriptor (PyTorch port of
``deep_image_matching_tpu/models/aliked.py``).

The parameters are the folded form the JAX package holds: nested dicts of
tensors, every BatchNorm folded into the convolution before it when a
checkpoint loads (``params_from_torch``), convolution weights in torch's
(out, in, kh, kw) layout. The JAX package's layouts stay at the public
functions: images (B, H, W, 3), feature maps (B, H, W, dim), per-image
(H, W, C) maps for the descriptor head, fixed-capacity (B, K, ...) keypoint
outputs with a validity mask. Inside the backbone the activations are NCHW,
as ``torch.nn.functional.conv2d`` takes them.

- ``dense_forward``: the ConvBlock and ResBlocks (deformable convolutions in
  blocks 3 and 4, ``ops/deform.py``), the multi-scale aggregation with
  align-corners upsampling, the sigmoid score head; a bf16 backbone keeps
  the score sigmoid and the feature normalisation in f32;
- ``dkd_detect``: NMS, border removal, the masked top-k and the soft-argmax
  sub-pixel refinement;
- ``sddh_describe``: the deformable descriptor head;
- ``extract``: all three for an image batch.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.deform import (
    bilinear_sample_zeropad,
    deform_conv2d,
    extract_patches,
    upsample_bilinear_align,
)
from ..ops.detect import bilinear_sample, select_topk, simple_nms

Params = Dict

# c1, c2, c3, c4, dim, K (SDDH kernel), M (SDDH sample count)
CFGS = {
    "aliked-t16": (8, 16, 32, 64, 64, 3, 16),
    "aliked-n16": (16, 32, 64, 128, 128, 3, 16),
    "aliked-n16rot": (16, 32, 64, 128, 128, 3, 16),
    "aliked-n32": (16, 32, 64, 128, 128, 3, 32),
}

_BN_EPS = 1e-5


def params_from_torch(state_dict, model_name: str = "aliked-n16rot") -> Params:
    """An upstream ALIKED state dict in the port's folded form: each
    BatchNorm folded into its convolution, weights kept (out, in, kh, kw).
    The fold runs in numpy f32, the JAX package's arithmetic, so both
    packages hold the same bits (torch's CPU sqrt is not always correctly
    rounded)."""
    sd = {k: np.asarray(v, np.float32) for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    def folded(conv_key, bn_prefix, has_bias=False):
        w = sd[f"{conv_key}.weight"]
        s = sd[f"{bn_prefix}.weight"] / np.sqrt(sd[f"{bn_prefix}.running_var"] + _BN_EPS)
        mean, beta = sd[f"{bn_prefix}.running_mean"], sd[f"{bn_prefix}.bias"]
        b = (sd[f"{conv_key}.bias"] - mean) * s + beta if has_bias else -mean * s + beta
        return {"w": t(w * s[:, None, None, None]), "b": t(b)}

    def plain(conv_key, bias=True):
        out = {"w": t(sd[f"{conv_key}.weight"])}
        if bias and f"{conv_key}.bias" in sd:
            out["b"] = t(sd[f"{conv_key}.bias"])
        return out

    def dcn(prefix, bn_prefix):
        return {"offset": plain(f"{prefix}.offset_conv"),
                "regular": folded(f"{prefix}.regular_conv", bn_prefix)}

    return {
        "block1": {"conv1": folded("block1.conv1", "block1.bn1"),
                   "conv2": folded("block1.conv2", "block1.bn2")},
        "block2": {"conv1": folded("block2.conv1", "block2.bn1"),
                   "conv2": folded("block2.conv2", "block2.bn2"),
                   "down": plain("block2.downsample")},
        "block3": {"conv1": dcn("block3.conv1", "block3.bn1"),
                   "conv2": dcn("block3.conv2", "block3.bn2"),
                   "down": plain("block3.downsample")},
        "block4": {"conv1": dcn("block4.conv1", "block4.bn1"),
                   "conv2": dcn("block4.conv2", "block4.bn2"),
                   "down": plain("block4.downsample")},
        "agg": {f"conv{i}": plain(f"conv{i}", bias=False) for i in range(1, 5)},
        "score_head": [plain(f"score_head.{i}", bias=False) for i in (0, 2, 4, 6)],
        "sddh": {"offset1": plain("desc_head.offset_conv.0"),
                 "offset2": plain("desc_head.offset_conv.2"),
                 "sf": plain("desc_head.sf_conv", bias=False),
                 "agg_weights": t(sd["desc_head.agg_weights"])},
    }


def tree_map(fn, tree):
    """``fn`` on every tensor of a parameter tree (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _conv(x, p):
    """Same-padded stride-1 convolution of NCHW ``x``."""
    w = p["w"]
    return F.conv2d(x, w, p.get("b"), padding=(w.shape[-1] - 1) // 2)


def _dcn(x, p, max_offset):
    """Deformable 3x3 convolution of NCHW ``x``, image by image; the
    result in ``x``'s dtype."""
    offset = _conv(x, p["offset"]).clamp(-max_offset, max_offset)
    xs, offs = x.permute(0, 2, 3, 1), offset.permute(0, 2, 3, 1)
    out = torch.stack([deform_conv2d(xi, oi, p["regular"]["w"], p["regular"]["b"])
                       for xi, oi in zip(xs, offs)])
    return out.to(x.dtype).permute(0, 3, 1, 2)


def _res_block(x, p, dcn: bool, max_offset=None):
    if dcn:
        out = _dcn(F.selu(_dcn(x, p["conv1"], max_offset)), p["conv2"], max_offset)
    else:
        out = _conv(F.selu(_conv(x, p["conv1"])), p["conv2"])
    return F.selu(out + _conv(x, p["down"]))


@torch.no_grad()
def dense_forward(params: Params, images: torch.Tensor,
                  compute_dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """images (B, H, W, 3) uint8 or float in [0, 1], H and W multiples of 32.

    Returns (feature_map (B, H, W, dim) f32, L2-normalised; score_map
    (B, H, W) f32). A bf16 ``compute_dtype`` runs the convolution backbone in
    bf16; the score sigmoid and the normalisation stay f32."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    cdt = compute_dtype
    if cdt != torch.float32:
        params = tree_map(lambda t: t.to(cdt) if t.dtype == torch.float32 else t, params)
    x = images.to(cdt).permute(0, 3, 1, 2)
    x1 = F.selu(_conv(F.selu(_conv(x, params["block1"]["conv1"])), params["block1"]["conv2"]))
    x2 = _res_block(F.avg_pool2d(x1, 2), params["block2"], dcn=False)
    x3 = F.avg_pool2d(x2, 4)
    x3 = _res_block(x3, params["block3"], dcn=True, max_offset=max(x3.shape[2:]) / 4.0)
    x4 = F.avg_pool2d(x3, 4)
    x4 = _res_block(x4, params["block4"], dcn=True, max_offset=max(x4.shape[2:]) / 4.0)

    agg = params["agg"]
    xa = [F.selu(_conv(t, agg[f"conv{i}"])).permute(0, 2, 3, 1)
          for i, t in enumerate((x1, x2, x3, x4), 1)]
    # align-corners upsampling runs in f32; the backbone's dtype is restored
    x1234 = torch.cat([xa[0]] + [upsample_bilinear_align(t, f).to(cdt)
                                 for t, f in zip(xa[1:], (2, 8, 32))], dim=-1)
    s = x1234.permute(0, 3, 1, 2)
    for i, p in enumerate(params["score_head"]):
        s = _conv(s, p)
        if i < 3:
            s = F.selu(s)
    score_map = torch.sigmoid(s[:, 0].float())
    x1234 = x1234.float()
    feature_map = x1234 / torch.linalg.norm(x1234, dim=-1, keepdim=True).clamp(min=1e-12)
    return feature_map, score_map


# ---------------------------------------------------------------------------
# DKD: keypoint detection with sub-pixel refinement
# ---------------------------------------------------------------------------

def _centered_patches_zeropad(smap: torch.Tensor, centers: torch.Tensor, radius: int):
    """(B, K, ks*ks) score patches of smap (B, H, W) centred on integer (x, y)
    keypoints, zeros outside the map (torch Unfold padding)."""
    B, H, W = smap.shape
    o = torch.arange(-radius, radius + 1, device=smap.device)
    ys = centers[..., 1][..., None, None] + o[:, None]
    xs = centers[..., 0][..., None, None] + o[None, :]
    valid = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
    idx = (ys.clamp(0, H - 1) * W + xs.clamp(0, W - 1)).reshape(B, -1).long()
    vals = torch.gather(smap.reshape(B, H * W), 1, idx).reshape(valid.shape)
    return torch.where(valid, vals, vals.new_tensor(0.0)).reshape(B, centers.shape[1], -1)


@torch.no_grad()
def dkd_detect(score_map: torch.Tensor, valid_hw: torch.Tensor, max_keypoints: int,
               detection_threshold: float = 0.2, nms_radius: int = 2,
               temperature: float = 0.1):
    """Batched DKD on (B, H, W) scores with the unpadded (h, w) per image:
    NMS, border removal, masked top-k, soft-argmax refinement. Returns
    keypoints (B, K, 2) in pixels, refined scores (B, K), dispersity (B, K)
    and the validity mask (B, K)."""
    nms = simple_nms(score_map, nms_radius)
    kpts_i, _, valid = select_topk(nms, max_keypoints, threshold=detection_threshold,
                                   border=nms_radius, valid_hw=(valid_hw[:, 0], valid_hw[:, 1]))
    ks = 2 * nms_radius + 1
    dev = score_map.device
    o = torch.arange(ks, dtype=torch.float32, device=dev) - nms_radius
    # local grid, (x, y) offsets in row-major patch order
    grid = torch.stack([o.repeat(ks), o.repeat_interleave(ks)], dim=1)   # (ks*ks, 2)
    patch = _centered_patches_zeropad(score_map, kpts_i.int(), nms_radius)
    max_v = patch.amax(dim=2, keepdim=True)
    x_exp = torch.exp((patch - max_v) / temperature)
    denom = x_exp.sum(dim=2, keepdim=True)
    residual = (x_exp @ grid) / denom                                    # (B, K, 2)
    dist2 = ((grid[None, None] - residual[:, :, None]) / nms_radius) ** 2
    dispersity = (x_exp * dist2.sum(-1)).sum(2) / denom[..., 0]
    refined = kpts_i + residual
    # refined score: bilinear on the raw map, clamped to the map
    scores = bilinear_sample(score_map[..., None], refined)[..., 0]
    refined = torch.where(valid[..., None], refined, refined.new_tensor(0.0))
    scores = torch.where(valid, scores, scores.new_tensor(0.0))
    return refined, scores, dispersity, valid


# ---------------------------------------------------------------------------
# SDDH descriptor head
# ---------------------------------------------------------------------------

@torch.no_grad()
def sddh_describe(params: Params, fmap: torch.Tensor, kpts: torch.Tensor,
                  kernel_size: int = 3, n_pos: int = 16) -> torch.Tensor:
    """Deformable descriptors of one image: fmap (H, W, C), kpts (K, 2)
    pixel (x, y) -> (K, C), L2-normalised."""
    H, W, C = fmap.shape
    max_offset = max(H, W) / 4.0
    ikpts = kpts.int()
    w1 = params["offset1"]["w"]                                   # (2 n_pos, C, ks, ks)
    if kernel_size > 1:
        patch = extract_patches(fmap, ikpts, kernel_size)         # (K, ks, ks, C)
        h = patch.reshape(len(kpts), -1) @ w1.permute(2, 3, 1, 0).reshape(-1, w1.shape[0])
    else:
        idx = (ikpts[:, 1].clamp(0, H - 1) * W + ikpts[:, 0].clamp(0, W - 1)).long()
        h = fmap.reshape(-1, C)[idx] @ w1[:, :, 0, 0].T
    h = F.selu(h + params["offset1"]["b"])
    off = h @ params["offset2"]["w"][:, :, 0, 0].T + params["offset2"]["b"]
    off = off.clamp(-max_offset, max_offset)
    # torch: view(K, 2, n_pos).permute(0, 2, 1)
    offsets = off.reshape(-1, 2, n_pos).transpose(1, 2)          # (K, n_pos, 2)
    feats = bilinear_sample_zeropad(fmap, kpts[:, None, :] + offsets)   # (K, n_pos, C)
    feats = F.selu(feats @ params["sf"]["w"][:, :, 0, 0].T)
    agg = params["agg_weights"]                                   # (n_pos, C, C)
    desc = feats.reshape(len(kpts), -1) @ agg.reshape(-1, agg.shape[-1])
    return desc / torch.linalg.norm(desc, dim=-1, keepdim=True).clamp(min=1e-12)


@torch.no_grad()
def extract(params: Params, images: torch.Tensor, valid_hw: torch.Tensor,
            max_keypoints: int = 4000, detection_threshold: float = 0.2,
            nms_radius: int = 2, model_name: str = "aliked-n16rot",
            compute_dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Batched ALIKED extraction of images (B, H, W, 3), H and W multiples of
    32, with the unpadded (h, w) per image. Keypoints are in pixels of the
    padded input; ``descriptors`` are zero on invalid rows."""
    _, _, _, _, dim, K, M = CFGS[model_name]
    feature_map, score_map = dense_forward(params, images, compute_dtype)
    kpts, scores, _, valid = dkd_detect(score_map, valid_hw, max_keypoints,
                                        detection_threshold, nms_radius)
    descs = torch.stack([sddh_describe(params["sddh"], f, k, kernel_size=K, n_pos=M)
                         for f, k in zip(feature_map, kpts)])
    return {"keypoints": kpts, "scores": scores, "descriptors": descs * valid[..., None],
            "mask": valid}
