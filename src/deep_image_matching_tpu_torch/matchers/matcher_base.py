"""Matcher templates: batched sparse matching + verification + h5 writes.

Port of ``deep_image_matching_tpu/matchers/matcher_base.py`` for one
device. ``BatchedMatcher.match_all`` loads every image's
features once into a padded store that lives on the device (built from the
extractor's device handoff where it covers every image: the features never
leave the device between the two stages), assembles pair
batches there, runs the matcher and (on CUDA) the batched RANSAC chained
behind it, and packs each chunk's results into one int32 tensor, one
device->host copy per chunk. Two chunks are in flight: chunk N+1 and N+2 are
dispatched before chunk N is verified and written.

``DetectorFreeMatcher.match_all`` is the detector-free counterpart (RoMa):
the matcher produces the keypoints of each pair, which are appended to each
image's group of features.h5, with the same two-chunk window.

With ``--tiling`` and features that carry ``tile_idx``,
``BatchedMatcher._match_all_tiled`` expands each pair into tile-pair jobs
(``matchers/tiling.py``); each job is the same batched matcher with each
side's mask restricted to one tile on the device (``gather_tiled``), and each
pair's union of its jobs' matches, deduplicated on the query index, is
verified (device RANSAC on CUDA) and written.

On a device mesh of more than one slot (``parallel/mesh.py``: the devices
of ``tpu.mesh_devices``, or an injected ``_DEFAULT_MESH``; a device may be
named twice) each chunk of pairs or tile-pair jobs is padded to a multiple
of the mesh and split across the slots (``_match_sharded``): each slot
gathers its rows from its device's replica of the store and matches them
with its device's replica of the matcher's weights; the slots' results come
back to the first mesh device in row order, padding trimmed, where device
RANSAC verifies the chunk as one batch and one device->host copy takes it.
The batch-level decisions are taken over the whole chunk (LightGlue's depth
exit in ``forward_shards``, AdaLAM's draws, RANSAC's), so the output equals
the one-device output bit for bit. A mesh of one device runs the one-device
path: no padding, no replica.

Failures are not swallowed: a chunk that runs out of device memory is
bisected and retried (a batch that does not fit at B usually fits at B/2);
every other exception propagates, from any slot, and so does an
out-of-memory error of a single pair.
"""

from __future__ import annotations

import copy
import inspect
import logging
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..constants import KPT_PAD_MULTIPLE, GeometricVerification, Quality, TileSelection
from ..io import hdf5
from ..io.h5 import get_features, list_h5_names
from ..io.writer import MatchWriter
from ..parallel.mesh import get_default_mesh
from ..utils.device import resolve_device, upload_blocking
from ..utils.geometric_verification import geometric_verification
from ..utils.profiler import device_span, span

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


def _to_host_async(t: torch.Tensor):
    """Queue ``t``'s copy to pinned host memory on the current stream of
    ``t``'s device; returns (host tensor, event to wait on, None on the
    CPU)."""
    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    return host, done


def _in_span(name: str, fn):
    """``fn`` with each call inside a span of ``name``."""
    def call(*args):
        with span(name):
            return fn(*args)
    return call


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
        self._mesh = None
        # this matcher with its weights on another mesh device, by device
        self._replicas: Dict[torch.device, "MatcherBase"] = {}
        # in-memory extract->match handoff set by ImageMatcher: per-image
        # features with h5-roundtrip-exact values; images absent here are
        # read from features.h5
        self.feature_cache: Optional[Dict[str, Dict[str, np.ndarray]]] = None
        # the extractor's DeviceFeatureHandoff, set by ImageMatcher where it
        # covers every image of the pairs
        self.device_handoff = None
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

    def _pipelined(self, pairs, bsz: int, dispatch, finish) -> None:
        """``dispatch(chunk)`` over chunks of ``bsz`` pairs with two chunks in
        flight, and ``finish(chunk, dispatched)`` for each, in order. A chunk
        whose dispatch runs out of device memory is halved and retried
        synchronously; an out-of-memory error of a single pair and every
        other exception propagate. Each call of either is a span
        (``match.dispatch``, ``match.finish``)."""
        dispatch = _in_span("match.dispatch", dispatch)
        finish = _in_span("match.finish", finish)
        window: list = []  # [(chunk, dispatched)]
        for start in range(0, len(pairs), bsz):
            chunk = pairs[start:start + bsz]
            try:
                disp = dispatch(chunk)
            except torch.cuda.OutOfMemoryError as e:
                logger.warning(f"Batch of {len(chunk)} pairs ran out of device "
                               f"memory ({e}); retrying in halves")
                self._empty_caches()
                while window:
                    finish(*window.pop(0))
                mid = len(chunk) // 2
                if mid == 0:
                    raise
                for half in (chunk[:mid], chunk[mid:]):
                    self._bisecting(half, dispatch, finish)
                continue
            window.append((chunk, disp))
            if len(window) > 2:
                finish(*window.pop(0))
        for job in window:
            finish(*job)

    def _bisecting(self, chunk, dispatch, finish) -> None:
        """Match a chunk synchronously, halving it on device OOM; a single
        pair that does not fit re-raises."""
        try:
            disp = dispatch(chunk)
        except torch.cuda.OutOfMemoryError:
            if len(chunk) == 1:
                raise
            self._empty_caches()
            mid = len(chunk) // 2
            for half in (chunk[:mid], chunk[mid:]):
                self._bisecting(half, dispatch, finish)
            return
        finish(chunk, disp)

    @property
    def mesh(self):
        """The device mesh of the batched matchers' chunks
        (``parallel/mesh.py::get_default_mesh`` of ``general.tpu``, taken at
        first use; one device: the one-device path on ``self.device``)."""
        if self._mesh is None:
            self._mesh = get_default_mesh(self.tpu)
        return self._mesh

    @mesh.setter
    def mesh(self, mesh) -> None:
        self._mesh = mesh

    def _empty_caches(self) -> None:
        """Return the cached blocks of every CUDA device the matcher runs on
        (each mesh device) to the driver."""
        for dev in dict.fromkeys([self.device, *self.mesh.devices]):
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    torch.cuda.empty_cache()

    def _replica(self, device: torch.device) -> "MatcherBase":
        """This matcher with its weights on ``device``: itself on its own
        device, elsewhere a shallow copy whose weights ``_move_weights``
        copies, made once per device."""
        if device == self.device:
            return self
        if device not in self._replicas:
            rep = copy.copy(self)
            rep.device = device
            rep._move_weights(device)
            self._replicas[device] = rep
        return self._replicas[device]

    def _move_weights(self, device: torch.device) -> None:
        """Give this (replica) matcher its own copy of its weights on
        ``device``; matchers without weights keep nothing there."""

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
        with span("match.store"):
            store = _PaddedFeatureStore(feature_path, names, self.device,
                                        cache=self.feature_cache, handoff=self.device_handoff)
        tile_mode = self.config.get("general", {}).get("tile_selection", TileSelection.NONE)
        if tile_mode is not TileSelection.NONE and store.has_tiles:
            return self._match_all_tiled(pairs, store, matches_path, tile_mode)
        bsz = int(self.tpu.get("match_batch_size", 32))
        use_device_gv = self._use_device_gv()
        results: Dict[Tuple[str, str], int] = {}
        with MatchWriter(matches_path) as writer:
            self._writer = writer
            try:
                self._pipelined(
                    pairs, bsz, lambda chunk: self._dispatch_chunk(chunk, store, use_device_gv),
                    lambda chunk, disp: self._finish_chunk(chunk, disp, store, matches_path,
                                                           use_device_gv, results))
            finally:
                self._writer = None
        return results

    def _dispatch_chunk(self, chunk, store, use_device_gv: bool):
        """Queue a chunk's device work and its device->host copy; returns
        what ``_finish_chunk`` needs to materialise it. Over a mesh the
        slots match their rows (``_match_sharded``) and the chunk comes back
        to the first mesh device, where RANSAC verifies it as one batch, as
        on one device: torch's CUDA sums depend on the batch's shape, so a
        slot's RANSAC would not repeat the one-device bits."""
        from ..ops.ransac import ransac_fundamental_store_batch

        idx0 = [store.index[a] for a, _ in chunk]
        idx1 = [store.index[b] for _, b in chunk]
        if self.mesh.n_devices == 1:
            dev, table = self.device, store
            ind0, ind1 = upload_blocking(idx0, dev), upload_blocking(idx1, dev)
            matches0, valid = self._match_batch_arrays(store.gather(ind0), store.gather(ind1))
        else:
            matches0, valid = self._match_sharded(store, idx0, idx1)
            dev = self.mesh.devices[0]
            table = store.replica(dev)
            ind0, ind1 = upload_blocking(idx0, dev), upload_blocking(idx1, dev)
        inl = None
        if use_device_gv:
            with device_span("ransac", dev):
                inl = ransac_fundamental_store_batch(
                    table.dev["keypoints"], ind0, ind1, matches0, valid,
                    self.gv_threshold * GV_QUALITY_SCALES[self.quality],
                    iters=int(self.tpu.get("ransac_iters", 2048)),
                    generator=torch.Generator(device=dev).manual_seed(0),
                )
        packed, done = _to_host_async(_pack_match_results(matches0, valid, inl))
        return idx0, idx1, packed, done, inl is not None

    def _finish_chunk(self, chunk, disp, store, matches_path, use_device_gv, results):
        idx0, idx1, packed, done, has_inl = disp
        with span("sync.result"):
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

    # ---------------------------------------------------------------- tiled
    def _match_all_tiled(self, pairs, store, matches_path, tile_mode):
        """Tiled matching: each pair expands into tile-pair jobs whose masks
        restrict both padded feature sets to one tile each, on the device;
        indices stay global, so each pair's jobs union and dedup directly
        (the first match of a query keypoint is kept), then verify."""
        from .tiling import LowResProbe, RomaProbe, select_tile_pairs, tile_grid_for

        general = self.config.get("general", {})
        tile_size = general.get("tile_size", (2400, 2000))
        overlap = general.get("tile_overlap", 10)
        min_per_tile = int(general.get("min_matches_per_tile", 10))
        image_dir = general.get("image_dir")

        probe = None
        if tile_mode in (TileSelection.PRESELECTION,
                         TileSelection.PRESELECTION_AFFINE_TRANSFORM):
            # reference matcher_base.py:1095-1110: superpoint+lightglue (the
            # default) or roma
            if str(general.get("preselection_pipeline", "superpoint+lightglue")) == "roma":
                probe = RomaProbe(device=self.device)
            else:
                probe = LowResProbe(
                    preselection_size=int(general.get("tile_preselection_size", 2000)),
                    device=self.device)

        grids = {name: tile_grid_for(store.image_size[i], tile_size, overlap)
                 for name, i in store.index.items()}
        jobs = []  # (pair index, i0, i1, t0, t1)
        for p_idx, (name0, name1) in enumerate(pairs):
            (o0, twh0), (o1, twh1) = grids[name0], grids[name1]
            lp0 = lp1 = None
            if probe is not None and image_dir is not None:
                lp0, lp1 = probe.matches(Path(image_dir) / name0, Path(image_dir) / name1)
            for t0, t1 in select_tile_pairs(
                    tile_mode, len(o0), len(o1), lowres_pts0=lp0, lowres_pts1=lp1,
                    origins0=o0, origins1=o1, tile_wh0=twh0, tile_wh1=twh1,
                    min_matches=min_per_tile):
                jobs.append((p_idx, store.index[name0], store.index[name1], t0, t1))
        logger.info(f"Tiled matching: {len(pairs)} pairs -> {len(jobs)} tile-pair jobs")

        gv_per_tile = bool(general.get("geometric_verification_per_tile", False))
        gv_tile_th = float(general.get("gv_threshold_in_tiles_matching", 4))
        per_pair: Dict[int, list] = {i: [] for i in range(len(pairs))}

        def dispatch(chunk):
            if self.mesh.n_devices > 1:
                return _to_host_async(_pack_match_results(*self._match_sharded(
                    store, [j[1] for j in chunk], [j[2] for j in chunk],
                    [j[3] for j in chunk], [j[4] for j in chunk])))
            dev = self.device
            tiles = [upload_blocking([j[c] for j in chunk], dev, torch.float32) for c in (3, 4)]
            batch0 = store.gather_tiled(upload_blocking([j[1] for j in chunk], dev), tiles[0])
            batch1 = store.gather_tiled(upload_blocking([j[2] for j in chunk], dev), tiles[1])
            return _to_host_async(_pack_match_results(*self._match_batch_arrays(batch0, batch1)))

        def finish(chunk, disp):
            packed, done = disp
            with span("sync.result"):
                if done is not None:
                    done.synchronize()
            packed = packed.numpy()
            matches0 = (packed & 0xFFFF).astype(np.int32)
            valid = ((packed >> 16) & 1).astype(bool)
            for b, (p_idx, i0, i1, _, _) in enumerate(chunk):
                rows = np.nonzero(valid[b])[0]
                if not len(rows):
                    continue
                m = np.stack([rows, matches0[b][rows]], axis=1)
                if gv_per_tile:
                    # reference matcher_base.py:428-440: each tile pair
                    # verifies alone; under 15 inliers it adds nothing
                    _, inl = geometric_verification(
                        store.keypoints_of(i0)[m[:, 0]], store.keypoints_of(i1)[m[:, 1]],
                        method=self.gv_method, threshold=gv_tile_th,
                        confidence=self.gv_confidence, quiet=True)
                    if inl is None or inl.sum() < 15:
                        continue
                    m = m[inl]
                per_pair[p_idx].append(m)

        self._pipelined(jobs, int(self.tpu.get("match_batch_size", 32)), dispatch, finish)

        unions = []
        for p_idx, (name0, name1) in enumerate(pairs):
            i0, i1 = store.index[name0], store.index[name1]
            m = np.zeros((0, 2), np.int32)
            if per_pair[p_idx]:
                m = np.concatenate(per_pair[p_idx], axis=0).astype(np.int32)
                _, first = np.unique(m[:, 0], return_index=True)
                m = m[np.sort(first)]
                m = m[(m[:, 0] < store.counts[i0]) & (m[:, 1] < store.counts[i1])]
            unions.append((name0, name1, i0, i1, m))
        masks = self._verify_unions(unions, store)
        results: Dict[Tuple[str, str], int] = {}
        with MatchWriter(matches_path) as writer:
            self._writer = writer
            try:
                for (name0, name1, i0, i1, m), mask in zip(unions, masks):
                    writer.save_raw(name0, name1, m)
                    verified = self._verify_and_save(
                        name0, name1, m, store.keypoints_of(i0), store.keypoints_of(i1),
                        inlier_mask=mask)
                    results[(name0, name1)] = 0 if verified is None else len(verified)
            finally:
                self._writer = None
        return results

    def _verify_unions(self, unions, store) -> list:
        """Inlier masks of each pair's unioned matches: the batched device
        RANSAC over the store's keypoints where ``_use_device_gv``, in chunks
        of ``match_batch_size`` pairs (each union as a (K,) match row with
        its validity, as the untiled chunks hold it); None (host
        verification in ``_verify_and_save``) otherwise. On a mesh it runs
        on the store's device (the matcher's), as on one device: the
        unions are few, one per image pair."""
        if not self._use_device_gv():
            return [None] * len(unions)
        from ..ops.ransac import ransac_fundamental_store_batch

        K = store.dev["keypoints"].shape[1]
        bsz = int(self.tpu.get("match_batch_size", 32))
        masks = []
        for start in range(0, len(unions), bsz):
            chunk = unions[start:start + bsz]
            matches0 = np.zeros((len(chunk), K), np.int32)
            valid = np.zeros((len(chunk), K), bool)
            for b, (_, _, _, _, m) in enumerate(chunk):
                matches0[b, m[:, 0]] = m[:, 1]
                valid[b, m[:, 0]] = True
            dev = self.device
            ind0 = upload_blocking([u[2] for u in chunk], dev)
            ind1 = upload_blocking([u[3] for u in chunk], dev)
            matches0, valid = upload_blocking(matches0, dev), upload_blocking(valid, dev)
            with device_span("ransac", dev):
                inl = ransac_fundamental_store_batch(
                    store.dev["keypoints"], ind0, ind1, matches0, valid,
                    self.gv_threshold * GV_QUALITY_SCALES[self.quality],
                    iters=int(self.tpu.get("ransac_iters", 2048)),
                    generator=torch.Generator(device=dev).manual_seed(0),
                )
            with span("sync.result"):
                inl = inl.cpu().numpy()
            masks.extend(inl[b][m[:, 0]] for b, (_, _, _, _, m) in enumerate(chunk))
        return masks

    def _match_sharded(self, store, idx0, idx1, tiles0=None, tiles1=None):
        """The rows of a chunk (image indices ``idx0`` / ``idx1``, and with
        ``tiles0`` / ``tiles1`` each row restricted to one tile per side)
        over the mesh: padded to a multiple of the mesh (the last row
        repeated) and split across the slots, each slot gathering its rows
        from its device's replica of the store and matching them with
        ``_match_shards``. Returns (matches0, valid) of the real rows, in
        row order, on the first mesh device."""
        mesh = self.mesh
        n = len(idx0)
        sides = [mesh.shard(np.asarray(i)) for i in (idx0, idx1)]
        if tiles0 is not None:
            tiles = [mesh.shard(np.asarray(t, np.float32)) for t in (tiles0, tiles1)]
        shards = []
        for s, (dev, _) in enumerate(mesh.slots(n)):
            rep = store.replica(dev)
            if tiles0 is None:
                batches = [rep.gather(side[s]) for side in sides]
            else:
                batches = [rep.gather_tiled(side[s], t[s]) for side, t in zip(sides, tiles)]
            shards.append((dev, *batches))
        outs = self._match_shards(shards, mesh.real_rows(n))
        dev0 = mesh.devices[0]
        return (mesh.gather([o[0] for o in outs], n, dev0),
                mesh.gather([o[1] for o in outs], n, dev0))

    def _match_shards(self, shards, n_real) -> list:
        """(matches0, valid) of each mesh slot's ``(device, batch0,
        batch1)``, ``n_real`` of its rows real: ``_match_batch_arrays`` on
        the slot's device with that device's weights. Matchers whose batch
        takes a decision over all its rows (LightGlue's depth exit, AdaLAM's
        draws) take it over every slot here."""
        return [self._replica(dev)._match_batch_arrays(b0, b1) for dev, b0, b1 in shards]

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
    pair batches are gathered (each image uploads once, not once per pair).
    Built from a device handoff that covers ``names``, the device copy is the
    handoff's own tensors and nothing is uploaded. Each other device of a
    mesh gets its copy once (``replica``), the tile indices with it."""

    def __init__(self, feature_path, names: List[str], device: torch.device, cache=None,
                 handoff=None):
        # copies of the device tensors on other mesh devices, by device
        self._replicas: Dict[torch.device, "_PaddedFeatureStore"] = {}
        if handoff is not None and handoff.covers(names):
            self._init_from_handoff(handoff, names)
            return
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
        cap = self._capacity(counts)
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
            "keypoints": upload_blocking(self.kpts, device),
            "descriptors": upload_blocking(desc, device),
            "scores": upload_blocking(scores, device),
            "mask": upload_blocking(mask, device),
            "image_size": upload_blocking(self.image_size, device),
        }
        # per-keypoint tile indices (-1 on padding) where the features are
        # tiled, on the device for the tile-restricted gathers
        tile_idx = np.full((n, cap), -1.0, np.float32)
        self.has_tiles = False
        for i, f in enumerate(feats):
            if "tile_idx" in f and counts[i] > 0:
                tile_idx[i, :counts[i]] = f["tile_idx"]
                self.has_tiles = True
        self.tile_idx = upload_blocking(tile_idx, device)

    @staticmethod
    def _capacity(counts) -> int:
        cap = _round_up(max(max(counts), 1), KPT_PAD_MULTIPLE)
        if cap > 0xFFFF:
            raise ValueError(f"keypoint capacity {cap} exceeds the 16-bit match packing")
        return cap

    def _init_from_handoff(self, handoff, names: List[str]) -> None:
        """The store of ``names`` from the handoff's device tensors (rows
        gathered, the capacity cut or zero-padded to the one the h5 route
        gives), equal to the store built from features.h5 bit for bit."""
        rows = np.asarray([handoff.index[n] for n in names], np.int64)
        self.index = {n: i for i, n in enumerate(names)}
        self.counts = handoff.counts[rows].astype(np.int32)
        cap = self._capacity(self.counts.tolist())
        K = handoff.kpts.shape[1]
        kpts = handoff.kpts[rows, :cap]
        self.kpts = np.zeros((len(names), cap, 2), np.float32)
        self.kpts[:, :kpts.shape[1]] = kpts
        self.image_size = handoff.image_size[rows].astype(np.int32)
        dev = next(iter(handoff.dev.values())).device
        ind = upload_blocking(rows, dev)

        def fit(t, fill=0):
            t = t[ind][:, :cap]
            if cap > K:
                t = torch.cat([t, t.new_full((t.shape[0], cap - K, *t.shape[2:]), fill)], 1)
            return t

        self.dev = {k: fit(handoff.dev[k]) for k in ("keypoints", "descriptors", "scores",
                                                     "mask")}
        self.dev["image_size"] = upload_blocking(self.image_size, dev)
        self.has_tiles = "tile_idx" in handoff.dev
        if self.has_tiles:
            self.tile_idx = fit(handoff.dev["tile_idx"], -1.0)
        else:
            self.tile_idx = torch.full((len(names), cap), -1.0, device=dev)

    def replica(self, device: torch.device) -> "_PaddedFeatureStore":
        """The store with its device tensors on ``device``: itself on its
        own device (the handoff's tensors where it came from a handoff),
        elsewhere a device-to-device copy made once."""
        home = self.dev["keypoints"].device
        if device == home:
            return self
        if device not in self._replicas:
            rep = copy.copy(self)
            rep.dev = {k: v.to(device) for k, v in self.dev.items()}
            rep.tile_idx = self.tile_idx.to(device)
            rep._replicas = {}
            self._replicas[device] = rep
        return self._replicas[device]

    def gather(self, ind: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {k: v[ind] for k, v in self.dev.items()}

    def gather_tiled(self, ind: torch.Tensor, tiles: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The pair batch of ``gather`` with each row's mask restricted to
        keypoints of one tile (``tiles`` (B,) float, on the device): the
        valid rows lie scattered over the capacity, not as a prefix."""
        out = self.gather(ind)
        out["mask"] = out["mask"] & (self.tile_idx[ind] == tiles[:, None])
        return out

    def keypoints_of(self, i: int) -> np.ndarray:
        return self.kpts[i, : self.counts[i]]


def _rows_from_file(feature_path, name: str) -> Dict[str, np.ndarray]:
    """One image's features from features.h5 with descriptors as (N, D)
    rows (the file stores them (D, N))."""
    f = get_features(feature_path, name)
    if "descriptors" in f:
        f["descriptors"] = np.ascontiguousarray(f["descriptors"].T)
    return f


class DetectorFreeMatcher(MatcherBase):
    """Matchers that consume image pairs and produce the keypoints: each
    pair's keypoints are appended to its images' groups of features.h5, and
    its matches index them with the images' running offsets.

    Subclasses implement ``_dispatch_images_batch(paths)``, which queues a
    chunk's device work and returns what ``_finish_images_batch(jobs)``
    needs to give ``[(kpts0 (M, 2), kpts1 (M, 2)), ...]`` in full-resolution
    pixels. Chunks of ``pair_batch_size`` pairs (default 1) go through the
    same two-chunk window as ``BatchedMatcher``: a pair's download, appends,
    host verification and writes overlap the next chunks' device work.

    Durability: features.h5, raw_matches.h5 and matches.h5 stay open for the
    whole stage and their group indexes are written when it ends
    (``io/hdf5.py`` appends the datasets as they come); each image's
    appended keypoints replace its ``keypoints`` dataset once, by their
    concatenation. A run killed mid-stage keeps
    features.h5 as the extractor wrote it and no match files, so
    ``--resume`` matches every pair again; a stage that ends in an exception
    writes what it finished, the keypoints and the matches of the same
    pairs, and ``--resume`` appends to them."""

    def match_all(self, pairs, feature_path, matches_path):
        image_dir = self.config.get("general", {}).get("image_dir")
        if image_dir is None:
            raise ValueError("Detector-free matching needs general['image_dir']")
        self._image_dir = Path(image_dir)
        results: Dict[Tuple[str, str], int] = {}
        bsz = int(self.conf.get("pair_batch_size", 1))
        with MatchWriter(matches_path) as writer, hdf5.File(feature_path, "a") as fd:
            self._writer, self._feature_fd = writer, fd
            self._appended: Dict[str, List[np.ndarray]] = {}
            self._n_kpts: Dict[str, int] = {}
            try:
                self._pipelined(
                    pairs, bsz, lambda chunk: self._dispatch_images_batch(self._paths(chunk)),
                    lambda chunk, jobs: self._consume_chunk(chunk, jobs, results))
            finally:
                self._write_appended()
                self._writer = None
                self._feature_fd = None
        return results

    def _paths(self, chunk):
        return [(self._image_dir / a, self._image_dir / b) for a, b in chunk]

    def _consume_chunk(self, chunk, jobs, results):
        """Per-pair host tail: append the keypoints, write the raw matches,
        verify on the host and write the verified matches."""
        for (img0, img1), (kpts0, kpts1) in zip(chunk, self._finish_images_batch(jobs)):
            matches = self._append_features(img0, img1, kpts0, kpts1)
            self._writer.save_raw(img0, img1, matches)
            verified = self._verify_and_save_coords(img0, img1, matches, kpts0, kpts1)
            results[(img0, img1)] = 0 if verified is None else len(verified)

    def _dispatch_images_batch(self, paths):
        raise NotImplementedError

    def _finish_images_batch(self, jobs):
        raise NotImplementedError

    def _append_features(self, img0, img1, kpts0, kpts1) -> np.ndarray:
        """Queue a pair's keypoints for its images' groups; returns the
        (M, 2) match indices into the images' keypoints after the append."""
        m = len(kpts0)
        matches = np.zeros((m, 2), np.int32)
        for col, (name, kpts) in enumerate(((img0, kpts0), (img1, kpts1))):
            if name not in self._n_kpts:
                grp = self._feature_fd.require_group(name)
                self._n_kpts[name] = grp["keypoints"].shape[0] if "keypoints" in grp else 0
            matches[:, col] = np.arange(m) + self._n_kpts[name]
            self._appended.setdefault(name, []).append(np.asarray(kpts, np.float32).reshape(-1, 2))
            self._n_kpts[name] += m
        return matches

    def _write_appended(self) -> None:
        """Replace each touched image's ``keypoints`` by the concatenation of
        what it held and what the stage appended."""
        for name, chunks in self._appended.items():
            grp = self._feature_fd.require_group(name)
            if "keypoints" in grp:
                chunks = [np.asarray(grp["keypoints"], np.float32).reshape(-1, 2)] + chunks
                del grp["keypoints"]
            grp.create_dataset("keypoints", data=np.concatenate(chunks, axis=0))
        self._appended = {}

    def _verify_and_save_coords(self, img0, img1, matches, kpts0, kpts1):
        """Host verification on the matched coordinates (one keypoint of
        each image per match), then the gates and the write."""
        mask = None
        if len(matches) >= 8:
            _, mask = geometric_verification(
                kpts0=kpts0, kpts1=kpts1, method=self.gv_method,
                threshold=self.gv_threshold * GV_QUALITY_SCALES[self.quality],
                confidence=self.gv_confidence,
            )
        return self._verify_and_save(img0, img1, matches, kpts0, kpts1, inlier_mask=mask)


def matcher_loader(root_module, name: str):
    import importlib

    module = importlib.import_module(f"{root_module.__name__}.{name}")
    classes = [
        c for _, c in inspect.getmembers(module, inspect.isclass)
        if issubclass(c, MatcherBase)
        and c not in (MatcherBase, BatchedMatcher, DetectorFreeMatcher)
        and c.__module__ == module.__name__
    ]
    if not classes:
        raise ImportError(f"No matcher class found in module '{name}'")
    return classes[0]
