"""LoFTR detector-free matcher (port of ``deep_image_matching_tpu/matchers/loftr.py``).

Images are read in grayscale, resized by ``quality``, capped at
``max_tile_size`` (1200 px) on the longer side and cropped to multiples of 8;
each is uploaded once as uint8 and kept on the device (first in, first out
under ``image_cache_mb``, default 512). A chunk's pairs (``pair_batch_size``)
are bucketed by their processed shapes and each bucket runs as one batch of
``models/loftr.match_pair``; each pair's valid matches (at most
``max_matches``) come back in full-resolution pixels and are appended to
features.h5 by ``DetectorFreeMatcher``. Configuration keys, as in the JAX
package: ``pretrained``, ``max_matches``, ``match_threshold``,
``max_tile_size``, ``coarse_impl`` (``dense`` or ``blocked``),
``dsmax_temperature``, ``image_cache_mb`` and ``compute_dtype`` (float32 or
bfloat16).

Weights: ``{pretrained}_ds.ckpt``, ``loftr_{pretrained}.ckpt`` or
``loftr_{pretrained}.pth`` from DIM_TPU_WEIGHTS_DIR or ~/.cache/dim_tpu,
converted at load and cached per checkpoint file, so ``pretrained: indoor``
never gets the outdoor weights; without a file, random weights under the
weights policy.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..constants import Quality, get_size_by_quality
from ..models import loftr as loftr_model
from ..utils.device import to_device
from ..utils.image import read_image, resize_image
from ..utils.weights import find_checkpoint, missing_weights, reject_cached_random
from .matcher_base import DetectorFreeMatcher, _to_host_async

logger = logging.getLogger("dim_tpu_torch")

_PARAMS: Dict[object, Dict] = {}


def cached_load(path: Path, convert: Callable):
    """``convert(state_dict)`` of the checkpoint at ``path``, once per file
    (its path, size and modification time)."""
    st = path.stat()
    key = (str(path.resolve()), st.st_size, st.st_mtime_ns)
    if key not in _PARAMS:
        ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
        _PARAMS[key] = convert(ckpt.get("state_dict", ckpt))
        logger.info(f"Loaded {path.name} from {path.parent}")
    return _PARAMS[key]


def load_params(pretrained: str = "outdoor") -> Dict:
    """LoFTR's parameters on the CPU for ``pretrained`` (outdoor or indoor):
    its checkpoint's, or random ones under the weights policy."""
    from ..convert import loftr_params_from_torch

    names = [f"{pretrained}_ds.ckpt", f"loftr_{pretrained}.ckpt", f"loftr_{pretrained}.pth"]
    path = find_checkpoint(names)
    if path is not None:
        return cached_load(path, loftr_params_from_torch)
    if "random" in _PARAMS:
        reject_cached_random("LoFTR", names)
    else:
        missing_weights("LoFTR", names)
        _PARAMS["random"] = loftr_model.init_params(torch.Generator().manual_seed(21))
    return _PARAMS["random"]


class LOFTRMatcher(DetectorFreeMatcher):
    default_conf = {
        "pretrained": "outdoor",
        "max_matches": 2048,
        "match_threshold": 0.2,
        "max_tile_size": 1200,
        # "blocked" streams the dual softmax without the (L, S) confidence
        "coarse_impl": "dense",
        "dsmax_temperature": 0.1,
        "image_cache_mb": 512,
        "compute_dtype": "float32",
    }

    def __init__(self, config: dict):
        super().__init__(config)
        self.max_matches = int(self.conf["max_matches"])
        self.match_threshold = float(self.conf["match_threshold"])
        self.coarse_impl = str(self.conf["coarse_impl"])
        if self.coarse_impl not in ("dense", "blocked"):
            raise ValueError(f"coarse_impl must be 'dense' or 'blocked', not {self.coarse_impl!r}")
        self.temperature = float(self.conf["dsmax_temperature"])
        self.compute_dtype = getattr(torch, str(self.conf["compute_dtype"]))
        if self.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError("compute_dtype must be float32 or bfloat16")
        params, self._match_fn = self._load_model()
        # cast once per model, not per batch
        self.params = loftr_model.prepare(to_device(params, self.device), self.compute_dtype)
        self._img_cache: Dict[str, Tuple[torch.Tensor, int]] = {}
        self._img_cache_bytes = 0
        self._full_shapes: Dict[str, Tuple[int, int]] = {}

    def _load_model(self):
        """(parameters on the CPU, the batch matching function)."""
        return load_params(str(self.conf["pretrained"])), self._loftr_batch

    def _loftr_batch(self, params, img0, img1):
        return loftr_model.match_pair(
            params, img0, img1, max_matches=self.max_matches, threshold=self.match_threshold,
            compute_dtype=self.compute_dtype, coarse_impl=self.coarse_impl,
            temperature=self.temperature)

    def _load(self, path) -> np.ndarray:
        """The image as uint8 grayscale, resized by quality, capped at
        ``max_tile_size`` and cropped to multiples of 8; records its
        full-resolution shape."""
        img = read_image(path, grayscale=True)
        h, w = img.shape
        self._full_shapes.setdefault(str(path), (h, w))
        if self.quality is not Quality.HIGH:
            nw, nh = get_size_by_quality(self.quality, (w, h))
            img = resize_image(img, (max(nw, 8), max(nh, 8)))
        cap = int(self.conf["max_tile_size"])
        hh, ww = img.shape
        if max(hh, ww) > cap:
            s = cap / max(hh, ww)
            img = resize_image(img, (round(ww * s), round(hh * s)))
        hh, ww = img.shape
        return img[: hh - hh % 8, : ww - ww % 8]

    def _device_image(self, path) -> torch.Tensor:
        """The processed image (H, W, 1) uint8 on the device, uploaded once
        (each image appears in many pairs); first in, first out under
        ``image_cache_mb``."""
        key = str(path)
        if key not in self._img_cache:
            arr = self._load(path)
            cap = int(self.conf["image_cache_mb"]) * (1 << 20)
            while self._img_cache and self._img_cache_bytes + arr.nbytes > cap:
                old = next(iter(self._img_cache))
                self._img_cache_bytes -= self._img_cache.pop(old)[1]
            dev = torch.from_numpy(np.ascontiguousarray(arr[..., None])).to(self.device)
            self._img_cache[key] = (dev, arr.nbytes)
            self._img_cache_bytes += arr.nbytes
        return self._img_cache[key][0]

    def _match_images(self, path0, path1) -> Tuple[np.ndarray, np.ndarray]:
        """One pair's matches as (kpts0 (M, 2), kpts1 (M, 2)) in
        full-resolution pixels."""
        return self._finish_images_batch(self._dispatch_images_batch([(path0, path1)]))[0]

    def _dispatch_images_batch(self, paths):
        """A chunk's pairs bucketed by processed shapes, one batch a bucket;
        each bucket's outputs packed into one (B, M, 5) tensor (kpts0, kpts1,
        mask) whose copy to the host is queued."""
        loaded = {}
        for pair in paths:
            for p in pair:
                if str(p) not in loaded:
                    loaded[str(p)] = self._device_image(p)
        buckets: Dict[tuple, List[int]] = {}
        for i, (p0, p1) in enumerate(paths):
            buckets.setdefault((loaded[str(p0)].shape, loaded[str(p1)].shape), []).append(i)
        jobs = []
        for idxs in buckets.values():
            img0 = torch.stack([loaded[str(paths[i][0])] for i in idxs])
            img1 = torch.stack([loaded[str(paths[i][1])] for i in idxs])
            with torch.no_grad():
                out = self._match_fn(self.params, img0, img1)
            packed = torch.cat([out["keypoints0"], out["keypoints1"],
                                out["mask"][..., None].float()], dim=-1)
            host, done = _to_host_async(packed)
            meta = [(str(paths[i][0]), str(paths[i][1]), tuple(img0.shape[1:3]),
                     tuple(img1.shape[1:3])) for i in idxs]
            jobs.append((idxs, host, done, meta))
        return len(paths), jobs

    def _finish_images_batch(self, disp):
        """The dispatched chunk's matches -> [(kpts0, kpts1)] in
        full-resolution pixels, in the chunk's order."""
        n, jobs = disp
        out: List = [None] * n
        for idxs, host, done, meta in jobs:
            if done is not None:
                done.synchronize()
            arr = host.numpy()
            for b, i in enumerate(idxs):
                p0, p1, (h0, w0), (h1, w1) = meta[b]
                m = arr[b, :, 4] > 0.5
                s0 = np.array([self._full_shapes[p0][1] / w0, self._full_shapes[p0][0] / h0],
                              np.float32)
                s1 = np.array([self._full_shapes[p1][1] / w1, self._full_shapes[p1][0] / h1],
                              np.float32)
                out[i] = (arr[b, m, 0:2] * s0, arr[b, m, 2:4] * s1)
        return out
