"""Matcher templates: batched sparse matching + verification + h5 writes.

Port of ``deep_image_matching_tpu/matchers/matcher_base.py`` for one device
and untiled matching. ``BatchedMatcher.match_all`` loads every image's
features once into a padded store that lives on the device, assembles pair
batches there, runs the matcher and (on CUDA) the batched RANSAC chained
behind it, and packs each chunk's results into one int32 tensor, one
device->host copy per chunk. Two chunks are in flight: chunk N+1 and N+2 are
dispatched before chunk N is verified and written.

Failures are not swallowed: a chunk that runs out of device memory is
bisected and retried (a batch that does not fit at B usually fits at B/2);
every other exception propagates, and so does an out-of-memory error of a
single pair. The mesh path and tiled matching are not ported yet
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import inspect
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..constants import KPT_PAD_MULTIPLE, GeometricVerification, Quality
from ..io.h5 import get_features, list_h5_names
from ..io.writer import MatchWriter
from ..utils.device import resolve_device
from ..utils.geometric_verification import geometric_verification

logger = logging.getLogger("dim_tpu_torch")

# GV pixel threshold is scaled when matching at reduced quality
GV_QUALITY_SCALES = {
    Quality.HIGHEST: 1.0,
    Quality.HIGH: 1.0,
    Quality.MEDIUM: 1.5,
    Quality.LOW: 2.0,
    Quality.LOWEST: 3.0,
}


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pack_match_results(matches0, valid, inl=None) -> torch.Tensor:
    """Pack a chunk's (matches0 int32, valid bool[, inl bool]), all (B, K),
    into one int32 tensor: bits 15:0 = match index (K <= 65535; unmatched
    rows carry garbage there and are never read), bit 16 = valid, bit 17 =
    inlier."""
    packed = (matches0.int() & 0xFFFF) | (valid.int() << 16)
    if inl is not None:
        packed = packed | (inl.int() << 17)
    return packed


class MatcherBase:
    default_conf: Dict = {}

    def __init__(self, config: dict):
        self.config = config
        self.conf = {**self.default_conf, **config.get("matcher", {})}
        general = config.get("general", {})
        self.quality: Quality = general.get("quality", Quality.HIGH)
        self.gv_method = general.get("geom_verification", GeometricVerification.MAGSAC)
        self.gv_threshold = float(general.get("gv_threshold", 4.0))
        self.gv_confidence = float(general.get("gv_confidence", 0.99999))
        self.min_inliers_per_pair = int(general.get("min_inliers_per_pair", 15))
        self.min_inlier_ratio_per_pair = float(general.get("min_inlier_ratio_per_pair", 0.15))
        self.tpu = dict(general.get("tpu", {}))
        self.device = resolve_device(self.tpu.get("device", "auto"))
        # in-memory extract->match handoff set by ImageMatcher: per-image
        # features with h5-roundtrip-exact values; images absent here are
        # read from features.h5
        self.feature_cache: Optional[Dict[str, Dict[str, np.ndarray]]] = None
        self._writer: Optional[MatchWriter] = None

    def _verify_and_save(
        self, img0: str, img1: str, matches: np.ndarray,
        kpts0: np.ndarray, kpts1: np.ndarray,
        inlier_mask: Optional[np.ndarray] = None,
    ) -> Optional[np.ndarray]:
        """Geometric verification + gates + matches.h5 write (through the
        match stage's writer). With ``inlier_mask`` (the device RANSAC
        already ran) host GV is skipped."""
        if len(matches) < 8:
            logger.debug(f"Too few matches ({len(matches)}) for {img0}-{img1}")
            return None
        if inlier_mask is None:
            _, inlier_mask = geometric_verification(
                kpts0=kpts0[matches[:, 0]], kpts1=kpts1[matches[:, 1]],
                method=self.gv_method,
                threshold=self.gv_threshold * GV_QUALITY_SCALES[self.quality],
                confidence=self.gv_confidence,
            )
        num_inliers = int(np.sum(inlier_mask))
        ratio = num_inliers / max(len(matches), 1)
        if num_inliers < self.min_inliers_per_pair:
            logger.debug(f"Too few inliers ({num_inliers}) for {img0}-{img1}")
            return None
        if ratio < self.min_inlier_ratio_per_pair:
            logger.debug(f"Inlier ratio too small ({ratio:.2%}) for {img0}-{img1}")
            return None
        verified = matches[np.asarray(inlier_mask, bool)]
        self._writer.save_verified(img0, img1, verified)
        return verified

    def _use_device_gv(self) -> bool:
        """Whether verification runs as the batched device RANSAC
        (``ops/ransac.py``). ``tpu.device_ransac: "auto"`` routes the
        RANSAC-family methods (MAGSAC / RANSAC / JAX_RANSAC) there whenever
        the matcher runs on CUDA; host OpenCV stays the fidelity mode."""
        dr = self.tpu.get("device_ransac", "auto")
        if isinstance(dr, str) and dr.lower() == "auto":
            return self.device.type == "cuda" and self.gv_method in (
                GeometricVerification.JAX_RANSAC,
                GeometricVerification.MAGSAC,
                GeometricVerification.RANSAC,
            )
        return bool(dr) and (
            self.gv_method is GeometricVerification.JAX_RANSAC
            or bool(self.tpu.get("force_device_ransac", False))
        )

    def _host_gv_batch(self, jobs):
        """Host GV for ``(matches (M,2), kpts0, kpts1)`` jobs on a thread
        pool (the OpenCV solvers release the GIL); one inlier mask per job,
        None where < 8 matches. ``tpu.gv_workers`` sets the pool width
        (0 = cpu_count)."""
        import os

        threshold = self.gv_threshold * GV_QUALITY_SCALES[self.quality]

        def one(job):
            m, k0, k1 = job
            if len(m) < 8:
                return None
            _, mask = geometric_verification(
                kpts0=k0[m[:, 0]], kpts1=k1[m[:, 1]], method=self.gv_method,
                threshold=threshold, confidence=self.gv_confidence,
            )
            return mask

        workers = min(int(self.tpu.get("gv_workers", 0)) or (os.cpu_count() or 1), len(jobs))
        if workers <= 1:
            return [one(j) for j in jobs]
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(workers) as ex:
            return list(ex.map(one, jobs))


class BatchedMatcher(MatcherBase):
    """Pads features to a fixed capacity and matches pairs in device
    batches; subclasses implement ``_match_batch_arrays``."""

    def match_all(self, pairs, feature_path, matches_path):
        if not pairs:
            return {}
        names = sorted({n for p in pairs for n in p})
        store = _PaddedFeatureStore(feature_path, names, self.device, cache=self.feature_cache)
        bsz = int(self.tpu.get("match_batch_size", 32))
        use_device_gv = self._use_device_gv()
        results: Dict[Tuple[str, str], int] = {}
        with MatchWriter(matches_path) as writer:
            self._writer = writer
            try:
                window: list = []  # [(chunk, dispatched)]
                for start in range(0, len(pairs), bsz):
                    chunk = pairs[start:start + bsz]
                    try:
                        disp = self._dispatch_chunk(chunk, store, use_device_gv)
                    except torch.cuda.OutOfMemoryError as e:
                        logger.warning(f"Batch of {len(chunk)} pairs ran out of device "
                                       f"memory ({e}); retrying in halves")
                        torch.cuda.empty_cache()
                        while window:
                            self._finish_chunk(*window.pop(0), store, matches_path,
                                               use_device_gv, results)
                        mid = len(chunk) // 2
                        if mid == 0:
                            raise
                        for half in (chunk[:mid], chunk[mid:]):
                            self._match_chunk_bisecting(half, store, matches_path,
                                                        use_device_gv, results)
                        continue
                    window.append((chunk, disp))
                    if len(window) > 2:
                        self._finish_chunk(*window.pop(0), store, matches_path,
                                           use_device_gv, results)
                for job in window:
                    self._finish_chunk(*job, store, matches_path, use_device_gv, results)
            finally:
                self._writer = None
        return results

    def _match_chunk_bisecting(self, chunk, store, matches_path, use_device_gv, results):
        """Match a chunk synchronously, halving it on device OOM; a single
        pair that does not fit re-raises."""
        try:
            disp = self._dispatch_chunk(chunk, store, use_device_gv)
        except torch.cuda.OutOfMemoryError:
            if len(chunk) == 1:
                raise
            torch.cuda.empty_cache()
            mid = len(chunk) // 2
            for half in (chunk[:mid], chunk[mid:]):
                self._match_chunk_bisecting(half, store, matches_path, use_device_gv, results)
            return
        self._finish_chunk(chunk, disp, store, matches_path, use_device_gv, results)

    def _dispatch_chunk(self, chunk, store, use_device_gv: bool):
        """Queue a chunk's device work and its device->host copy; returns
        what ``_finish_chunk`` needs to materialise it."""
        from ..ops.ransac import ransac_fundamental_store_batch

        idx0 = [store.index[a] for a, _ in chunk]
        idx1 = [store.index[b] for _, b in chunk]
        ind0 = torch.as_tensor(idx0, device=self.device)
        ind1 = torch.as_tensor(idx1, device=self.device)
        matches0, valid = self._match_batch_arrays(store.gather(ind0), store.gather(ind1))
        inl = None
        if use_device_gv:
            inl = ransac_fundamental_store_batch(
                store.dev["keypoints"], ind0, ind1, matches0, valid,
                self.gv_threshold * GV_QUALITY_SCALES[self.quality],
                iters=int(self.tpu.get("ransac_iters", 2048)),
                generator=torch.Generator(device=self.device).manual_seed(0),
            )
        packed = _pack_match_results(matches0, valid, inl)
        done = None
        if packed.is_cuda:
            host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            packed = host
        return idx0, idx1, packed, done, inl is not None

    def _finish_chunk(self, chunk, disp, store, matches_path, use_device_gv, results):
        idx0, idx1, packed, done, has_inl = disp
        if done is not None:
            done.synchronize()
        packed = packed.numpy()
        matches0 = (packed & 0xFFFF).astype(np.int32)
        valid = ((packed >> 16) & 1).astype(bool)
        inl = ((packed >> 17) & 1).astype(bool) if has_inl else None

        prepared = []
        for b, (img0, img1) in enumerate(chunk):
            sel = valid[b]
            pair_matches = np.stack([np.nonzero(sel)[0], matches0[b][sel]], axis=1).astype(np.int32)
            # padded rows never match real keypoints; keep the guard anyway
            n0, n1 = store.counts[idx0[b]], store.counts[idx1[b]]
            keep = (pair_matches[:, 0] < n0) & (pair_matches[:, 1] < n1)
            pair_matches = pair_matches[keep]
            mask = inl[b][sel][keep] if inl is not None else None
            prepared.append((b, img0, img1, pair_matches, mask))
        if inl is None:
            masks = self._host_gv_batch([
                (pm, store.keypoints_of(idx0[b]), store.keypoints_of(idx1[b]))
                for b, _, _, pm, _ in prepared
            ])
            prepared = [(b, i0, i1, pm, mk) for (b, i0, i1, pm, _), mk in zip(prepared, masks)]
        for b, img0, img1, pair_matches, mask in prepared:
            self._writer.save_raw(img0, img1, pair_matches)
            verified = self._verify_and_save(
                img0, img1, pair_matches,
                store.keypoints_of(idx0[b]), store.keypoints_of(idx1[b]), inlier_mask=mask,
            )
            results[(img0, img1)] = 0 if verified is None else len(verified)

    def _match_batch_arrays(self, batch0: Dict[str, torch.Tensor],
                            batch1: Dict[str, torch.Tensor]):
        """Subclass hook over stacked padded device tensors ``keypoints
        (B,K,2)``, ``descriptors (B,K,D)``, ``scores (B,K)``, ``mask (B,K)``,
        ``image_size (B,2)``. Returns (matches0 (B,K) int32 into the second
        set, valid (B,K) bool), still on the device."""
        raise NotImplementedError


class _PaddedFeatureStore:
    """Every image's features padded to one capacity (a multiple of 128):
    host arrays for verification and gating, and one device copy from which
    pair batches are gathered (each image uploads once, not once per pair)."""

    def __init__(self, feature_path, names: List[str], device: torch.device, cache=None):
        cache = cache or {}
        known = set(list_h5_names(feature_path)) if any(n not in cache for n in names) else set()
        missing = [n for n in names if n not in known and n not in cache]
        if missing:
            raise ValueError(f"Features missing for {missing[:5]}...")
        # the layout comes from the source, never from the shape (an image
        # with exactly D keypoints is square): the cache holds (N, D) rows,
        # features.h5 holds (D, N)
        feats = [cache[n] if n in cache else _rows_from_file(feature_path, n) for n in names]
        counts = [len(f["keypoints"]) for f in feats]
        cap = _round_up(max(max(counts), 1), KPT_PAD_MULTIPLE)
        if cap > 0xFFFF:
            raise ValueError(f"keypoint capacity {cap} exceeds the 16-bit match packing")
        dims = {f["descriptors"].shape[1] for f, c in zip(feats, counts)
                if "descriptors" in f and c > 0}
        if len(dims) > 1:
            raise ValueError(f"descriptor widths differ between images: {sorted(dims)}")
        D = dims.pop() if dims else 0
        n = len(names)
        self.index = {name: i for i, name in enumerate(names)}
        self.counts = np.array(counts, np.int32)
        self.kpts = np.zeros((n, cap, 2), np.float32)
        desc = np.zeros((n, cap, D), np.float32)
        scores = np.zeros((n, cap), np.float32)
        mask = np.zeros((n, cap), bool)
        self.image_size = np.zeros((n, 2), np.int32)
        for i, f in enumerate(feats):
            c = counts[i]
            self.kpts[i, :c] = f["keypoints"]
            if "descriptors" in f and c > 0:
                desc[i, :c] = f["descriptors"]
            if "scores" in f:
                scores[i, :c] = f["scores"]
            mask[i, :c] = True
            if "image_size" in f:
                self.image_size[i] = f["image_size"]
        self.dev = {
            "keypoints": torch.from_numpy(self.kpts).to(device),
            "descriptors": torch.from_numpy(desc).to(device),
            "scores": torch.from_numpy(scores).to(device),
            "mask": torch.from_numpy(mask).to(device),
            "image_size": torch.from_numpy(self.image_size).to(device),
        }

    def gather(self, ind: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {k: v[ind] for k, v in self.dev.items()}

    def keypoints_of(self, i: int) -> np.ndarray:
        return self.kpts[i, : self.counts[i]]


def _rows_from_file(feature_path, name: str) -> Dict[str, np.ndarray]:
    """One image's features from features.h5 with descriptors as (N, D)
    rows (the file stores them (D, N))."""
    f = get_features(feature_path, name)
    if "descriptors" in f:
        f["descriptors"] = np.ascontiguousarray(f["descriptors"].T)
    return f


def matcher_loader(root_module, name: str):
    import importlib

    module = importlib.import_module(f"{root_module.__name__}.{name}")
    classes = [
        c for _, c in inspect.getmembers(module, inspect.isclass)
        if issubclass(c, MatcherBase)
        and c not in (MatcherBase, BatchedMatcher)
        and c.__module__ == module.__name__
    ]
    if not classes:
        raise ImportError(f"No matcher class found in module '{name}'")
    return classes[0]
