"""RoMa dense matcher (port of ``deep_image_matching_tpu/matchers/roma.py``).

Detector-free dense matching at the model resolution (``coarse_res`` 560),
refined by a second pass at ``upsample_res`` 864 (``upsample_preds``),
symmetric warps and certainties, threshold-balanced sampling of
``num_sampled_points`` matches on the device, keypoints appended per pair
to features.h5 (``DetectorFreeMatcher``).

Weights: ``roma_outdoor.pth`` (or ``roma_indoor.pth``) and
``dinov2_vitl14_pretrain.pth`` from DIM_TPU_WEIGHTS_DIR or
~/.cache/dim_tpu, converted at load; without them, random weights with a
2-block DINOv2, subject to the weights policy. The JAX package's
configuration keys: ``coarse_res``, ``upsample_res``, ``upsample_preds``,
``num_sampled_points``, ``sample_thresh``, ``decoder_dtype``,
``corr_dtype``, ``attenuate_cert``, ``image_cache_mb``, ``pair_batch_size``
and ``tpu.roma_batch_size``.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from ..models import dinov2
from ..models import roma as roma_model
from ..utils.image import read_image, resize_image
from .matcher_base import DetectorFreeMatcher

logger = logging.getLogger("dim_tpu_torch")

_PARAMS = None
_PARAMS_RANDOM = False
_NAMES = ["roma_outdoor.pth", "roma_indoor.pth", "dinov2_vitl14_pretrain.pth"]


def load_params() -> Dict:
    """RoMa's parameters on the CPU, loaded once per process."""
    global _PARAMS, _PARAMS_RANDOM
    from ..utils.weights import missing_weights, reject_cached_random

    if _PARAMS is not None:
        if _PARAMS_RANDOM:
            reject_cached_random("RoMa", _NAMES)
        return _PARAMS
    from ..convert import roma_params_from_torch

    wdir = os.environ.get("DIM_TPU_WEIGHTS_DIR")
    for base in ([Path(wdir)] if wdir else []) + [Path.home() / ".cache/dim_tpu"]:
        for name in ("roma_outdoor.pth", "roma_indoor.pth"):
            cand = base / name
            if not cand.exists():
                continue
            sd = torch.load(str(cand), map_location="cpu")
            sd = sd.get("state_dict", sd)
            dcand = base / "dinov2_vitl14_pretrain.pth"
            dino = torch.load(str(dcand), map_location="cpu") if dcand.exists() else None
            if dino is None:
                logger.warning("roma weights found but dinov2_vitl14_pretrain.pth is "
                               "missing - coarse matching will be random")
            _PARAMS = roma_params_from_torch(sd, dino)
            if dino is None:
                from ..convert import dinov2_params_from_jax

                _PARAMS["dinov2"] = dinov2_params_from_jax(dinov2.init_tree(depth=2))
            logger.info(f"Loaded RoMa weights from {cand}")
            return _PARAMS
    missing_weights("RoMa", _NAMES)
    _PARAMS = roma_model.init_params(dinov2_depth=2)
    _PARAMS_RANDOM = True
    return _PARAMS


def _dtype(name):
    return getattr(torch, str(name)) if name else None


class RomaMatcher(DetectorFreeMatcher):
    # DINOv2 runs in bf16 (on CUDA the attention kernel takes nothing else);
    # the JAX package exposes no key for it either
    encoder_dtype = torch.bfloat16
    default_conf = {
        "pretrained": "outdoor",
        "coarse_res": 560,
        "upsample_res": 864,
        "upsample_preds": True,
        "num_sampled_points": 5000,
        "sample_thresh": 0.05,
    }

    def __init__(self, config: dict):
        super().__init__(config)
        self.res = int(self.conf.get("coarse_res", 560))
        if self.res % 56 != 0:
            raise ValueError("coarse_res must be a multiple of 56 (14 and 8)")
        self.upsample_res = int(self.conf.get("upsample_res", 864))
        self.upsample_preds = bool(self.conf.get("upsample_preds", True))
        if self.upsample_res % 8 != 0:
            raise ValueError("upsample_res must be a multiple of 8")
        self.num_points = int(self.conf.get("num_sampled_points", 5000))
        self.sample_thresh = float(self.conf.get("sample_thresh", 0.05))
        # the decoder stays f32 unless asked (the flow drifts through the
        # coarse-to-fine loop in bf16)
        self.decoder_dtype = _dtype(self.conf.get("decoder_dtype", "float32"))
        # bf16 halves the local-correlation gather payload; opt-in
        self.corr_dtype = _dtype(self.conf.get("corr_dtype"))
        self.attenuate = bool(self.conf.get("attenuate_cert", True))
        params = roma_model.to_device(load_params(), self.device)
        # DINOv2's blocks cast once, not per pair
        self.params = {**params, "dinov2": dinov2.prepare(params["dinov2"], self.encoder_dtype)}
        self._key = 0
        self._img_cache: Dict[Tuple[str, int], Tuple[torch.Tensor, int]] = {}
        self._img_cache_bytes = 0
        self._full_shapes: Dict[str, Tuple[int, int]] = {}

    def _full_shape(self, path) -> Tuple[int, int]:
        key = str(path)
        if key not in self._full_shapes:
            self._full_shapes[key] = read_image(path, grayscale=False).shape[:2]
        return self._full_shapes[key]

    def _dev_img(self, path, res: int) -> torch.Tensor:
        """The image as uint8 (res, res, 3) on the device, cached: each image
        appears in many pairs, so it uploads once per resolution. First in,
        first out under ``image_cache_mb`` (default 512)."""
        key = (str(path), res)
        if key not in self._img_cache:
            full = read_image(path, grayscale=False)
            self._full_shapes.setdefault(str(path), full.shape[:2])
            arr = resize_image(full, (res, res))
            cap = int(self.conf.get("image_cache_mb", 512)) * (1 << 20)
            while self._img_cache and self._img_cache_bytes + arr.nbytes > cap:
                old = next(iter(self._img_cache))
                self._img_cache_bytes -= self._img_cache.pop(old)[1]
            self._img_cache[key] = (torch.from_numpy(arr).to(self.device), arr.nbytes)
            self._img_cache_bytes += arr.nbytes
        return self._img_cache[key][0]

    def _dispatch_images_batch(self, paths):
        """The warps of a chunk's pairs as one batch (2B images with the
        symmetric pass), then each pair's matches sampled on the device and
        their copy to the host queued; ``_finish_images_batch`` waits for
        them. A pair downloads (num, 4) matches, not its warp maps."""
        B_cap = int(self.tpu.get("roma_batch_size", 4))  # 2B images per program
        if len(paths) > B_cap:
            jobs = []
            for s in range(0, len(paths), B_cap):
                jobs.extend(self._dispatch_images_batch(paths[s:s + B_cap]))
            return jobs
        a = torch.stack([self._dev_img(p0, self.res) for p0, _ in paths])
        b = torch.stack([self._dev_img(p1, self.res) for _, p1 in paths])
        sizes = [(self._full_shape(p0), self._full_shape(p1)) for p0, p1 in paths]
        out = roma_model.match_pair(
            self.params, a, b, compute_dtype=self.encoder_dtype,
            decoder_dtype=self.decoder_dtype, corr_dtype=self.corr_dtype,
            attenuate_cert=self.attenuate and not self.upsample_preds,
            with_cert16=self.attenuate and self.upsample_preds,
        )
        warp_ab, cert_ab, warp_ba, cert_ba = out[:4]
        if self.upsample_preds:
            r = self.upsample_res
            a_hr = torch.stack([self._dev_img(p0, r) for p0, _ in paths])
            b_hr = torch.stack([self._dev_img(p1, r) for _, p1 in paths])
            warp_ab, cert_ab, warp_ba, cert_ba = roma_model.match_pair_upsample(
                self.params, a_hr, b_hr, warp_ab, cert_ab, warp_ba, cert_ba,
                scale_factor=float(np.sqrt(r * r / (self.res * self.res))),
                compute_dtype=self.decoder_dtype, corr_dtype=self.corr_dtype,
                cert16_ab=out[4] if self.attenuate else None,
                cert16_ba=out[5] if self.attenuate else None,
            )
        jobs = []
        for i, (shape_a, shape_b) in enumerate(sizes):
            # one generator per pair, seeded from the pair counter
            self._key += 1
            gen = torch.Generator(device=self.device).manual_seed(self._key)
            matches, _ = roma_model.sample_matches_device(
                warp_ab[i], cert_ab[i], warp_ba[i], cert_ba[i], generator=gen,
                num=self.num_points, sample_thresh=self.sample_thresh,
            )
            done = None
            if matches.is_cuda:
                host = torch.empty(matches.shape, dtype=matches.dtype, pin_memory=True)
                host.copy_(matches, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                matches = host
            jobs.append((matches, done, shape_a, shape_b))
        return jobs

    def _finish_images_batch(self, jobs):
        results = []
        for matches, done, (HA, WA), (HB, WB) in jobs:
            if done is not None:
                done.synchronize()
            kA, kB = roma_model.to_pixel_coordinates(matches.numpy(), HA, WA, HB, WB)
            results.append((kA.astype(np.float32), kB.astype(np.float32)))
        return results
