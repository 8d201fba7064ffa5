"""Tiling on the device: cut overlapping tiles from a once-uploaded image,
and merge per-tile features into one padded per-image feature set
(PyTorch port of ``deep_image_matching_tpu/ops/tile_merge.py``).

Parity with the reference ``extractors/extractor_base.py:279-390``
(per-tile extraction, origin offsets, the padding-border filter, dedup on
rounded coordinates, the score-ranked cap). The image crosses to the device
once, as uint8, and its tiles are cut there; the merge runs on the same
device. Both functions are plain device code in the JAX package too (no
Pallas kernel), so they are plain PyTorch here.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def cut_tiles(
    image: torch.Tensor,                       # (H, W[, C]), any dtype (uint8 preferred)
    starts_yx: Sequence[Sequence[int]],        # (T, 2) (y, x) into the PADDED image, host
    tile_hw: Tuple[int, int],                  # (th, tw)
    pad: Tuple[int, int, int, int],            # (top, bottom, left, right)
) -> torch.Tensor:
    """The (T, th, tw[, C]) tile batch of one image, on the image's device.

    Equivalent to the host ``Tiler``: the image is zero-padded once to a
    window-divisible size and the windows are sliced from it, so the tiles
    never exist on the host and the upload is the image itself, once.
    """
    th, tw = int(tile_hw[0]), int(tile_hw[1])
    top, bottom, left, right = (int(p) for p in pad)
    # F.pad pads the last dimensions first: move (H, W) last
    x = image if image.ndim == 2 else image.permute(2, 0, 1)
    padded = F.pad(x, (left, right, top, bottom))
    if image.ndim == 3:
        padded = padded.permute(1, 2, 0)
    starts = np.asarray(starts_yx, np.int64).reshape(-1, 2)
    return torch.stack([padded[y:y + th, x0:x0 + tw] for y, x0 in starts.tolist()])


def merge_tile_features(
    kpts: torch.Tensor,         # (T, K, 2) tile-local (x, y), f32
    scores: torch.Tensor,       # (T, K) f32
    desc: torch.Tensor,         # (T, K, D)
    mask: torch.Tensor,         # (T, K) bool
    origins_xy: torch.Tensor,   # (T, 2) tile origins in image coordinates
    wh: Tuple[float, float],    # (w, h) of the (resized) image
    max_kpts: int,
) -> Dict[str, torch.Tensor]:
    """Merge per-tile padded features into one (max_kpts, ...) padded set.

    The host ``_extract_by_tile`` merge's semantics:
      - keypoints offset by their tiles' origins into image coordinates;
      - the padding-border filter 0 <= x < w, 0 <= y < h;
      - dedup on rounded integer coordinates (half to even, as
        ``jnp.round``), keeping the lowest flat (tile-major) index among
        duplicates, the row ``np.unique(rounded, return_index=True)``
        selects;
      - the cap at ``max_kpts`` by score, ties by the lower flat index
        first, as ``jax.lax.top_k`` (a stable descending sort; ``torch.topk``
        and ``torch.unique`` order ties differently on CUDA).
    Rows come back score-descending with valid rows as a prefix;
    ``tile_idx`` is -1 on padding rows. Every step is exact in IEEE f32 (one
    add, a rounding, stable sorts, gathers and products by 0 or 1), so the
    CPU and the card give equal bits.
    """
    T, K, _ = kpts.shape
    D = desc.shape[-1]
    dev = kpts.device
    w, h = float(wh[0]), float(wh[1])

    k = kpts + origins_xy.to(device=dev, dtype=kpts.dtype)[:, None, :]
    inb = mask & (k[..., 0] >= 0) & (k[..., 0] < w) & (k[..., 1] >= 0) & (k[..., 1] < h)

    n = T * K
    fk = k.reshape(n, 2)
    fs = scores.reshape(n).float()
    fd = desc.reshape(n, D)
    fm = inb.reshape(n)
    ftile = torch.arange(T, device=dev, dtype=torch.float32).repeat_interleave(K)

    # dedup on rounded coordinates without a 64-bit key: two stable sorts
    # give (ry, rx, flat index) order; the first row of each run of equal
    # rounded coordinates is the lowest flat index
    big = torch.tensor(2 ** 30, dtype=torch.int32, device=dev)
    rx = torch.where(fm, torch.round(fk[:, 0]).int(), big)
    ry = torch.where(fm, torch.round(fk[:, 1]).int(), big)
    o1 = torch.sort(rx, stable=True).indices
    o2 = torch.sort(ry[o1], stable=True).indices
    order = o1[o2]
    sy, sx = ry[order], rx[order]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = (sy[1:] != sy[:-1]) | (sx[1:] != sx[:-1])
    keep = torch.zeros(n, dtype=torch.bool, device=dev)
    keep[order] = first
    keep &= fm

    s_eff = torch.where(keep, fs, fs.new_tensor(-float("inf")))
    if n < max_kpts:  # tiny inputs: pad the candidate set to max_kpts
        padlen = max_kpts - n
        s_eff = torch.cat([s_eff, s_eff.new_full((padlen,), -float("inf"))])
        fk = torch.cat([fk, fk.new_zeros(padlen, 2)])
        fd = torch.cat([fd, fd.new_zeros(padlen, D)])
        ftile = torch.cat([ftile, ftile.new_zeros(padlen)])
    vals, top = torch.sort(s_eff, descending=True, stable=True)
    vals, top = vals[:max_kpts], top[:max_kpts]
    out_mask = vals > -float("inf")
    fl = out_mask.to(fk.dtype)[:, None]
    return {
        "keypoints": fk[top] * fl,
        "scores": torch.where(out_mask, vals, vals.new_tensor(0.0)),
        "descriptors": fd[top] * fl.to(fd.dtype),
        "mask": out_mask,
        "tile_idx": torch.where(out_mask, ftile[top], ftile.new_tensor(-1.0)),
    }
