"""Padded batches of images for the batched extract programs (port of
``deep_image_matching_tpu/ops/assemble.py``, with the bucketing loop that
the extractors share).

The batched extract programs take a zero-padded ``(B, ph, pw, C)`` batch.
``padded_batches`` buckets images by their padded shape and runs each
bucket's batches as they fill; images decoded and uploaded one by one by
``utils/prefetch.py`` are padded and stacked where they already are, on the
device (``assemble_batch``), so the pixels cross the host link once.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

logger = logging.getLogger("dim_tpu_torch")


def assemble_batch(dev_imgs: Sequence[torch.Tensor], pad_hw: Tuple[int, int],
                   channels: Optional[int] = None) -> torch.Tensor:
    """Stack images (h, w[, C]) of varying size into one zero-padded
    ``(B, ph, pw, C)`` batch on their device, keeping the dtype (uint8 stays
    uint8: the extract programs normalise). ``channels`` forces the channel
    count: a grey image is broadcast to it, any other mismatch raises."""
    ph, pw = int(pad_hw[0]), int(pad_hw[1])
    padded = []
    for x in dev_imgs:
        if x.ndim == 2:
            x = x[..., None]
        if channels is not None and x.shape[-1] != channels:
            if x.shape[-1] != 1:
                raise ValueError(f"cannot adapt {x.shape[-1]} channels to {channels}")
            x = x.expand(*x.shape[:2], channels)
        h, w = x.shape[:2]
        padded.append(F.pad(x, (0, 0, 0, pw - w, 0, ph - h)))
    return torch.stack(padded)


def is_device_array(x) -> bool:
    """True for a torch tensor (an image already uploaded), False for a
    numpy array on the host."""
    return isinstance(x, torch.Tensor)


def _host_batch(imgs: Sequence[np.ndarray], pad_hw: Tuple[int, int], channels: int) -> np.ndarray:
    """``assemble_batch`` on the host: uint8 where every image is, else f32
    with the uint8 images scaled to [0, 1]."""
    as_uint8 = all(im.dtype == np.uint8 for im in imgs)
    batch = np.zeros((len(imgs), *pad_hw, channels), np.uint8 if as_uint8 else np.float32)
    for j, im in enumerate(imgs):
        if not as_uint8 and im.dtype == np.uint8:
            im = im.astype(np.float32) / 255.0
        if im.ndim == 2:
            im = im[..., None]
        if im.shape[-1] != channels:
            if im.shape[-1] != 1:
                raise ValueError(f"cannot adapt {im.shape[-1]} channels to {channels}")
            im = np.repeat(im, channels, axis=-1)
        batch[j, :im.shape[0], :im.shape[1]] = im
    return batch


def padded_batches(images: Iterable, pad_to: int, channels: int, batch_size: int,
                   run: Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]],
                   device: torch.device, pixel_budget: Optional[int] = None,
                   ) -> Iterator[Tuple[List[int], Dict[str, torch.Tensor]]]:
    """Run ``images`` through ``run`` as zero-padded batches and yield
    (indices into ``images``, the batch's outputs) per batch.

    ``images`` is consumed in order and lazily, so a prefetch generator
    decodes ahead of the model. Each image (h, w[, C]), uint8 or float in
    [0, 1], a host array or a tensor on the device, joins the bucket of its
    shape padded up to multiples of ``pad_to``. A bucket runs a batch as
    soon as it holds ``batch_size`` images (fewer where ``pixel_budget``
    caps a batch's pixels); where more than two batches' worth of images
    wait in all, the fullest bucket runs as it is; the rest run at the end.
    So the images held at once stay within a few batches, however many
    there are. A batch of device tensors is padded and stacked on the
    device, one of host arrays on the host and then uploaded.
    ``run(batch (B, ph, pw, channels), valid_hw (B, 2) int64)``, both on
    ``device``, gives the batch's outputs. With a ``pixel_budget``, a batch
    that runs out of device memory halves its bucket's batch size and runs
    again; any other error propagates."""
    waiting: Dict[Tuple[int, int], list] = {}
    bsz: Dict[Tuple[int, int], int] = {}

    def drain(key, final: bool):
        q = waiting[key]
        while q and (final or len(q) >= bsz[key]):
            part = q[:bsz[key]]
            imgs = [im for _, im in part]
            vhw = torch.tensor([im.shape[:2] for im in imgs], dtype=torch.int64)
            try:
                if all(is_device_array(im) for im in imgs):
                    batch = assemble_batch(imgs, key, channels)
                else:
                    batch = torch.from_numpy(_host_batch(imgs, key, channels))
                out = run(batch.to(device), vhw.to(device))
            except torch.cuda.OutOfMemoryError:
                if pixel_budget is None or bsz[key] == 1:
                    raise
                bsz[key] = max(1, bsz[key] // 2)
                torch.cuda.empty_cache()
                logger.warning(f"extraction ran out of device memory at {key[0]}x{key[1]}; "
                               f"retrying with batch {bsz[key]}")
                continue
            del q[:len(part)]
            yield [i for i, _ in part], out
        if not q:
            del waiting[key]

    for i, im in enumerate(images):
        h, w = im.shape[:2]
        key = (-(-h // pad_to) * pad_to, -(-w // pad_to) * pad_to)
        if key not in bsz:
            cap = batch_size if pixel_budget is None else pixel_budget // (key[0] * key[1])
            bsz[key] = max(1, min(batch_size, cap))
        waiting.setdefault(key, []).append((i, im))
        yield from drain(key, final=False)
        if sum(len(q) for q in waiting.values()) > 2 * batch_size:
            yield from drain(max(waiting, key=lambda k: len(waiting[k])), final=True)
    for key in list(waiting):
        yield from drain(key, final=True)


def unpad(out: Dict[str, torch.Tensor]) -> List[Dict[str, np.ndarray]]:
    """One batch's padded outputs -> per-image host ``keypoints``,
    ``scores`` and ``descriptors``: the rows where ``mask`` is set."""
    out = {k: v.cpu().numpy() for k, v in out.items()}
    return [{k: out[k][j][m] for k in ("keypoints", "scores", "descriptors")}
            for j, m in enumerate(out["mask"])]
