"""Native incremental SfM mapper (pycolmap-free reconstruction backend).

Reads the COLMAP database the pipeline already produces (keypoints +
verified ``two_view_geometries``; reference ``reconstruction.py:12-110``
hands the same db to pycolmap), builds feature tracks with union-find,
initializes from the best two-view geometry, then alternates RANSAC-PnP
registration, multi-view DLT triangulation, and bundle adjustment on the
mapper's device (``sfm/ba.py``, PyTorch; the first CUDA device unless the
caller asks for the CPU). Output matches the reference's artifact contract: a
COLMAP text model + ``model.ply`` under ``reconstruction/``.

Scope: this mapper targets the framework's example-scale scenes (tens to
hundreds of images) with SIMPLE_PINHOLE / PINHOLE / SIMPLE_RADIAL / RADIAL /
OPENCV cameras (full radial+tangential distortion in projection,
undistortion, and bundle adjustment), FULL_OPENCV (rational tail k3..k6
rectified to plain OPENCV at load, fixed thereafter), the equidistant
fisheye family OPENCV_FISHEYE / SIMPLE_RADIAL_FISHEYE / RADIAL_FISHEYE,
and FOV / THIN_PRISM_FISHEYE — i.e. every COLMAP camera model (ids 0-10).
Fisheye/FOV/thin-prism keypoints are rectified to an ideal pinhole frame
at load; BA refines f/c while the calibrated distortion passes through to
export unchanged. A disconnected
scene graph is mapped per connected component and the largest model kept
(reference via COLMAP: ``reconstruction.py:81-89``). pycolmap remains the
preferred backend for full COLMAP fidelity when installed.
"""

from __future__ import annotations

import contextlib
import logging
import sqlite3
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io.colmap_db import blob_to_array, pair_id_to_image_ids
from ..io.colmap_read_write_model import (
    Camera,
    Image,
    Point3D,
    rotmat2qvec,
    write_model,
)
from ..utils.device import resolve_device
from . import geometry as geom
from .ba import bundle_adjust

logger = logging.getLogger("dim_tpu_torch")


# ---------------------------------------------------------------------------
# database loading
# ---------------------------------------------------------------------------


@dataclass
class SfMData:
    image_names: Dict[int, str]
    image_cam: Dict[int, int]
    keypoints: Dict[int, np.ndarray]          # image_id -> (N,2) pixels
    cameras: Dict[int, dict]                   # camera_id -> {intr, width, height, model}
    pair_matches: Dict[Tuple[int, int], np.ndarray]  # (id0,id1) -> (M,2) kpt idx
    # fisheye cameras are rectified to an ideal pinhole frame at load time;
    # the observed (distorted) pixels are kept here for model export
    keypoints_raw: Dict[int, np.ndarray] = field(default_factory=dict)


def load_database(database_path: Path) -> SfMData:
    """Read images, keypoints, cameras and verified matches from the db.

    Intrinsics are carried as the 8-parameter OPENCV vector
    ``(fx, fy, cx, cy, k1, k2, p1, p2)``; simpler models embed with fx=fy
    and zero higher-order terms, so SIMPLE_PINHOLE / PINHOLE / SIMPLE_RADIAL
    / RADIAL / OPENCV all round-trip exactly.
    """
    con = sqlite3.connect(str(database_path))
    cur = con.cursor()
    cameras: Dict[int, dict] = {}
    full_rational: Dict[int, np.ndarray] = {}  # FULL_OPENCV k3..k6 to rectify
    rectify_fov: Dict[int, float] = {}         # FOV omega to rectify
    rectify_thin_prism: Dict[int, np.ndarray] = {}  # THIN_PRISM_FISHEYE
    for cam_id, model, width, height, params, _prior in cur.execute(
        "SELECT camera_id, model, width, height, params, prior_focal_length "
        "FROM cameras"
    ):
        p = blob_to_array(params, np.float64)
        z = 0.0
        fk = None  # equidistant-fisheye coefficients, when applicable
        if model == 0:  # SIMPLE_PINHOLE f cx cy
            intr = np.array([p[0], p[0], p[1], p[2], z, z, z, z])
        elif model == 1:  # PINHOLE fx fy cx cy
            intr = np.array([p[0], p[1], p[2], p[3], z, z, z, z])
        elif model == 2:  # SIMPLE_RADIAL f cx cy k
            intr = np.array([p[0], p[0], p[1], p[2], p[3], z, z, z])
        elif model == 3:  # RADIAL f cx cy k1 k2
            intr = np.array([p[0], p[0], p[1], p[2], p[3], p[4], z, z])
        elif model == 4:  # OPENCV fx fy cx cy k1 k2 p1 p2
            intr = np.array([p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]])
        elif model == 6:  # FULL_OPENCV fx fy cx cy k1 k2 p1 p2 k3 k4 k5 k6
            # rational-polynomial tail (k3..k6) has no slot in intr8:
            # rectify keypoints to plain OPENCV at load (the k3..k6 terms
            # are removed exactly; k1 k2 p1 p2 stay live and refinable)
            intr = np.array([p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]])
            if np.any(p[8:12] != 0.0):
                full_rational[cam_id] = p[:12].copy()
        elif model == 7:  # FOV fx fy cx cy omega
            intr = np.array([p[0], p[1], p[2], p[3], z, z, z, z])
            if p[4] != 0.0:
                rectify_fov[cam_id] = float(p[4])
        elif model == 10:  # THIN_PRISM_FISHEYE (12 params)
            intr = np.array([p[0], p[1], p[2], p[3], z, z, z, z])
            rectify_thin_prism[cam_id] = p[:12].copy()
        elif model in (5, 8, 9):  # *_FISHEYE (equidistant) family
            # carried as the ideal-pinhole equivalent; keypoints are
            # rectified below and the original distortion is kept for export
            if model == 5:   # OPENCV_FISHEYE fx fy cx cy k1 k2 k3 k4
                fx, fy, cx, cy = p[0], p[1], p[2], p[3]
                fk = np.array([p[4], p[5], p[6], p[7]], np.float64)
            elif model == 8:  # SIMPLE_RADIAL_FISHEYE f cx cy k
                fx = fy = p[0]
                cx, cy = p[1], p[2]
                fk = np.array([p[3], 0.0, 0.0, 0.0])
            else:             # RADIAL_FISHEYE f cx cy k1 k2
                fx = fy = p[0]
                cx, cy = p[1], p[2]
                fk = np.array([p[3], p[4], 0.0, 0.0])
            intr = np.array([fx, fy, cx, cy, z, z, z, z])
        else:
            logger.warning(
                f"Camera model id {model} unsupported by the native mapper; "
                "treating as PINHOLE with zero distortion"
            )
            intr = np.array([p[0], p[0],
                             p[1] if len(p) > 1 else width / 2.0,
                             p[2] if len(p) > 2 else height / 2.0,
                             z, z, z, z])
        cameras[cam_id] = {
            "intr": intr, "width": width, "height": height, "model": model,
        }
        if fk is not None:
            cameras[cam_id]["fisheye_k"] = fk
        if cam_id in full_rational:
            cameras[cam_id]["full_rational"] = full_rational[cam_id]
        if cam_id in rectify_fov:
            cameras[cam_id]["fov_omega"] = rectify_fov[cam_id]
        if cam_id in rectify_thin_prism:
            cameras[cam_id]["thin_prism"] = rectify_thin_prism[cam_id]
    image_names, image_cam = {}, {}
    for image_id, name, cam_id in cur.execute(
        "SELECT image_id, name, camera_id FROM images"
    ):
        image_names[image_id] = name
        image_cam[image_id] = cam_id
    keypoints = {}
    for image_id, rows, cols, data in cur.execute(
        "SELECT image_id, rows, cols, data FROM keypoints"
    ):
        kp = blob_to_array(data, np.float32, (rows, cols)) if rows else \
            np.zeros((0, 2), np.float32)
        keypoints[image_id] = np.asarray(kp[:, :2], np.float64)
    pair_matches = {}
    for pair_id, rows, cols, data in cur.execute(
        "SELECT pair_id, rows, cols, data FROM two_view_geometries"
    ):
        if not rows:
            continue
        m = blob_to_array(data, np.uint32, (rows, cols)).astype(np.int64)
        id0, id1 = pair_id_to_image_ids(pair_id)
        pair_matches[(id0, id1)] = m
    con.close()
    # fisheye rectification: map observed pixels to the ideal-pinhole frame
    # once, so the whole incremental pipeline (PnP, triangulation, BA) runs
    # distortion-free. The equidistant coefficients stay fixed
    # (prior calibration) — BA refines f/c on the pinhole equivalent; the
    # reference refines fisheye distortion only via pycolmap/COLMAP.
    keypoints_raw: Dict[int, np.ndarray] = {}
    fisheye_cams = {c for c, cam in cameras.items() if "fisheye_k" in cam}
    rectified = (
        fisheye_cams | set(full_rational) | set(rectify_fov)
        | set(rectify_thin_prism)
    )
    if rectified:
        logger.info(
            f"Rectifying keypoints of {len(rectified)} camera(s) at load "
            "(fisheye/FOV/thin-prism -> ideal pinhole; FULL_OPENCV rational "
            "tail -> plain OPENCV; rectified terms held fixed during "
            "refinement)"
        )
        for image_id, kp in keypoints.items():
            cid = image_cam.get(image_id)
            if cid not in rectified or not len(kp):
                continue
            cam = cameras[cid]
            intr = cam["intr"]
            keypoints_raw[image_id] = kp.copy()
            xyd = (kp - intr[2:4]) / intr[0:2]
            if cid in fisheye_cams:
                xy = geom.fisheye_undistort_normalized(cam["fisheye_k"], xyd)
                keypoints[image_id] = xy * intr[0:2] + intr[2:4]
            elif cid in rectify_fov:
                xy = geom.fov_undistort_normalized(rectify_fov[cid], xyd)
                keypoints[image_id] = xy * intr[0:2] + intr[2:4]
            elif cid in rectify_thin_prism:
                xy = geom.thin_prism_undistort_normalized(
                    rectify_thin_prism[cid], xyd
                )
                keypoints[image_id] = xy * intr[0:2] + intr[2:4]
            else:
                # FULL_OPENCV: invert the full rational model, re-apply the
                # truncated OPENCV part — k1 k2 p1 p2 remain live in intr8
                xy = geom.full_opencv_undistort_normalized(
                    full_rational[cid], xyd
                )
                keypoints[image_id] = geom.normalized_to_pixels(intr, xy)
    return SfMData(
        image_names, image_cam, keypoints, cameras, pair_matches,
        keypoints_raw,
    )


# ---------------------------------------------------------------------------
# track building (union-find over (image, kpt) feature nodes)
# ---------------------------------------------------------------------------


def build_tracks(data: SfMData, min_track_len: int = 2) -> List[dict]:
    """Connected components of the match graph -> feature tracks.

    A track is ``{image_id: kpt_idx}``; components where one image appears
    with two different keypoints are ambiguous and dropped (standard
    conservative policy for transitive-closure track building).
    """
    offsets = {}
    total = 0
    for img_id, kps in data.keypoints.items():
        offsets[img_id] = total
        total += len(kps)

    edge_chunks = [
        np.asarray(m, np.int64) + np.array([offsets[id0], offsets[id1]])
        for (id0, id1), m in data.pair_matches.items()
        if len(m)
    ]
    if not edge_chunks:
        return []
    edges = np.concatenate(edge_chunks, axis=0)

    # C++ union-find (native/unionfind.cpp) + vectorized
    # grouping — the per-match Python loop dominated mapper startup on
    # large projects
    from ..native import connected_components

    labels = connected_components(total, edges)
    node_img = np.empty(total, np.int64)
    node_kpt = np.empty(total, np.int64)
    for img_id, off in offsets.items():
        n = len(data.keypoints[img_id])
        node_img[off : off + n] = img_id
        node_kpt[off : off + n] = np.arange(n)

    order = np.lexsort((node_img, labels))
    sl, si, sk = labels[order], node_img[order], node_kpt[order]
    is_start = np.r_[True, sl[1:] != sl[:-1]]
    starts = np.flatnonzero(is_start)
    sizes = np.diff(np.r_[starts, len(sl)])
    grp_of_pos = np.cumsum(is_start) - 1
    # a component is ambiguous if one image contributes two keypoints
    dup = (sl[1:] == sl[:-1]) & (si[1:] == si[:-1])
    bad = np.zeros(len(starts), bool)
    np.logical_or.at(bad, grp_of_pos[1:][dup], True)
    keep = np.flatnonzero((sizes >= min_track_len) & ~bad)

    tracks = [
        dict(zip(si[s : s + n].tolist(), sk[s : s + n].tolist()))
        for s, n in zip(starts[keep], sizes[keep])
    ]
    logger.info(
        f"Built {len(tracks)} tracks from {len(data.pair_matches)} verified "
        f"pairs ({int(bad.sum())} ambiguous components dropped)"
    )
    return tracks


# ---------------------------------------------------------------------------
# the mapper
# ---------------------------------------------------------------------------


@dataclass
class MapperOptions:
    init_min_matches: int = 50
    init_min_inliers: int = 30
    init_min_angle_deg: float = 2.0
    abs_pose_min_inliers: int = 12
    abs_pose_thresh_px: float = 8.0
    tri_thresh_px: float = 6.0
    tri_min_angle_deg: float = 1.0
    filter_thresh_px: float = 6.0
    # 0 = COLMAP-style adaptive schedule (local BA after every registration,
    # global BA on ~10% model growth + once at the end) — the default; this
    # is what keeps the mapper O(n log n)-ish instead of O(n^2) in images.
    # k >= 1 forces a full global BA after every k registrations.
    ba_global_every: int = 0
    # LM steps of the closing global BA, of every global BA when
    # ba_global_every >= 1, and (halved) of the adaptive schedule's in-loop
    # global and local BAs
    ba_lm_iters: int = 25
    ba_cg_iters: int = 30
    refine_focal: bool = True
    refine_distortion: bool = True
    seed: int = 0


class IncrementalMapper:
    """Incremental reconstruction over a loaded SfMData; bundle adjustment
    runs on ``device`` (``utils/device.resolve_device``)."""

    def __init__(self, data: SfMData, options: Optional[MapperOptions] = None, device=None):
        self.data = data
        self.opt = options or MapperOptions()
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(self.opt.seed)
        self.tracks = build_tracks(data)
        # per-image: track ids touching it
        self.img_tracks: Dict[int, List[int]] = {i: [] for i in data.image_names}
        for tid, tr in enumerate(self.tracks):
            for img_id in tr:
                self.img_tracks[img_id].append(tid)
        self.poses: Dict[int, np.ndarray] = {}     # image_id -> (6,) rvec|tvec
        self.intr: Dict[int, np.ndarray] = {
            cid: cam["intr"].copy() for cid, cam in data.cameras.items()
        }
        self.points: Dict[int, np.ndarray] = {}    # track id -> xyz
        self.reg_order: List[int] = []
        # image_id -> human-readable reason the LAST registration attempt
        # failed (surfaced by run()'s final report; reference analog: COLMAP
        # logs per-image registration failures during mapping)
        self.reg_failures: Dict[int, str] = {}
        # phase -> (total seconds, call count); populated by _phase() and
        # logged by run() so scale runs attribute their mapper wall time
        self.phase_times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def _phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            acc = self.phase_times.setdefault(name, [0.0, 0])
            acc[0] += time.perf_counter() - t0
            acc[1] += 1

    def log_phase_times(self) -> None:
        total = sum(v[0] for v in self.phase_times.values())
        logger.info(f"Mapper phase times ({total:.1f} s attributed):")
        for name, (secs, n) in sorted(
            self.phase_times.items(), key=lambda kv: -kv[1][0]
        ):
            logger.info(
                f"  {name:<16} {secs:7.1f} s  ({n} calls, "
                f"{1e3 * secs / max(n, 1):7.1f} ms/call)"
            )

    # -- helpers ----------------------------------------------------------

    def _pair_track_matches(self, id0: int, id1: int) -> List[int]:
        return [
            tid for tid in self.img_tracks[id0]
            if id1 in self.tracks[tid]
        ]

    def _norm_kpts(self, img_id: int, idx: np.ndarray) -> np.ndarray:
        intr = self.intr[self.data.image_cam[img_id]]
        return geom.undistort_normalized(intr, self.data.keypoints[img_id][idx])

    # -- initialization ---------------------------------------------------

    def _evaluate_init(self, id0: int, id1: int):
        """Score a candidate initial pair WITHOUT mutating mapper state.

        Returns None when the pair fails the thresholds, else a dict with the
        relative pose, triangulated points, and a score = number of
        well-conditioned points. Scoring (instead of first-success) protects
        against degenerate near-duplicate pairs that have the most raw
        matches but almost no parallax (COLMAP's mapper similarly rejects
        homography-dominated init pairs)."""
        opt = self.opt
        tids = self._pair_track_matches(id0, id1)
        if len(tids) < opt.init_min_matches:
            return None
        k0 = np.array([self.tracks[t][id0] for t in tids])
        k1 = np.array([self.tracks[t][id1] for t in tids])
        x0 = self._norm_kpts(id0, k0)
        x1 = self._norm_kpts(id1, k1)
        intr0 = self.intr[self.data.image_cam[id0]]
        f = float((intr0[0] + intr0[1]) / 2.0)
        res = geom.ransac_essential(x0, x1, thresh=4.0 / f, n_iters=200,
                                    rng=self.rng)
        if res is None:
            return None
        E, mask = res
        if mask.sum() < opt.init_min_inliers:
            return None
        R, t, front = geom.decompose_essential(E, x0[mask], x1[mask])
        P0 = geom.pose_to_P(np.eye(3), np.zeros(3))
        P1 = geom.pose_to_P(R, t)
        inl_idx = np.where(mask)[0][front]
        if len(inl_idx) < opt.init_min_inliers:
            return None
        X = geom.triangulate_dlt(P0, P1, x0[inl_idx], x1[inl_idx])
        angles = geom.triangulation_angles(
            X, np.zeros(3), geom.camera_center(R, t)
        )
        if np.median(angles) < opt.init_min_angle_deg:
            logger.debug(
                f"init pair ({id0},{id1}) rejected: median angle "
                f"{np.median(angles):.2f} deg"
            )
            return None
        good = angles > opt.tri_min_angle_deg
        return {
            "id0": id0, "id1": id1, "R": R, "t": t,
            "tids": np.asarray(tids)[inl_idx][good], "X": X[good],
            "median_angle": float(np.median(angles)),
            "score": int(good.sum()),
        }

    def _commit_init(self, info: dict) -> None:
        self.poses[info["id0"]] = np.zeros(6)
        self.poses[info["id1"]] = np.concatenate(
            [geom.matrix_to_rotvec(info["R"]), info["t"]]
        )
        for tid, xyz in zip(info["tids"], info["X"]):
            self.points[int(tid)] = xyz
        self.reg_order = [info["id0"], info["id1"]]
        logger.info(
            f"Initialized from pair ({self.data.image_names[info['id0']]}, "
            f"{self.data.image_names[info['id1']]}): {info['score']} points, "
            f"median angle {info['median_angle']:.1f} deg"
        )

    def _try_initialize(self, id0: int, id1: int) -> bool:
        info = self._evaluate_init(id0, id1)
        if info is None:
            return False
        self._commit_init(info)
        return True

    def initialize(self) -> bool:
        # rank candidate pairs by track-filtered correspondence count
        ranked = sorted(
            self.data.pair_matches,
            key=lambda p: -len(self._pair_track_matches(*p)),
        )
        opt = self.opt
        # progressive threshold relaxation when no pair qualifies (COLMAP's
        # mapper retries initialization with lowered requirements; small or
        # low-texture sets legitimately have < 50 correspondences per pair).
        # The configured thresholds are restored afterwards — relaxation is
        # local to this search, not a permanent mutation of the options.
        saved = (opt.init_min_matches, opt.init_min_inliers,
                 opt.init_min_angle_deg)
        schedule = [
            saved,
            (max(15, saved[0] // 2), max(10, saved[1] // 2),
             max(1.0, saved[2] / 2)),
            (max(8, saved[0] // 4), max(6, saved[1] // 4),
             max(0.5, saved[2] / 4)),
        ]
        try:
            for round_i, (mm, mi, ma) in enumerate(schedule):
                opt.init_min_matches, opt.init_min_inliers = mm, mi
                opt.init_min_angle_deg = ma
                if round_i:
                    logger.info(
                        f"Relaxing initialization thresholds (round {round_i + 1}): "
                        f"min_matches={mm} min_inliers={mi} min_angle={ma:.2g} deg"
                    )
                best = None
                for id0, id1 in ranked[:20]:
                    info = self._evaluate_init(id0, id1)
                    if info is None:
                        continue
                    if best is None or info["score"] > best["score"]:
                        best = info
                if best is not None:
                    self._commit_init(best)
                    return True
            return False
        finally:
            (opt.init_min_matches, opt.init_min_inliers,
             opt.init_min_angle_deg) = saved

    # -- registration -----------------------------------------------------

    def _visible_correspondences(self, img_id: int):
        tids = [
            t for t in self.img_tracks[img_id] if t in self.points
        ]
        if not tids:
            return None
        X = np.stack([self.points[t] for t in tids])
        uv = self.data.keypoints[img_id][
            np.array([self.tracks[t][img_id] for t in tids])
        ]
        return np.asarray(tids), X, uv

    def next_candidates(self) -> List[Tuple[int, int]]:
        out = []
        for img_id in self.data.image_names:
            if img_id in self.poses:
                continue
            vis = self._visible_correspondences(img_id)
            out.append((0 if vis is None else len(vis[0]), img_id))
        out.sort(reverse=True)
        return [(n, i) for n, i in out if n >= 6]

    def register_image(self, img_id: int) -> bool:
        opt = self.opt
        vis = self._visible_correspondences(img_id)
        if vis is None:
            self.reg_failures[img_id] = (
                "no 2D-3D correspondences (shares no reconstructed track "
                "with the model)"
            )
            return False
        tids, X, uv = vis
        intr = self.intr[self.data.image_cam[img_id]]
        res = geom.pnp_ransac(
            X, uv, intr, n_hyp=256, thresh_px=opt.abs_pose_thresh_px,
            rng=self.rng,
        )
        if res is None:
            self.reg_failures[img_id] = (
                f"PnP RANSAC found no pose from {len(tids)} 2D-3D "
                f"correspondences (thresh {opt.abs_pose_thresh_px:.1f} px)"
            )
            return False
        R, t, mask = res
        if mask.sum() < opt.abs_pose_min_inliers:
            self.reg_failures[img_id] = (
                f"PnP inliers {int(mask.sum())}/{len(mask)} below the "
                f"abs_pose_min_inliers={opt.abs_pose_min_inliers} gate "
                f"(thresh {opt.abs_pose_thresh_px:.1f} px)"
            )
            logger.debug(
                f"register {self.data.image_names[img_id]}: only "
                f"{int(mask.sum())} PnP inliers"
            )
            return False
        self.reg_failures.pop(img_id, None)
        self.poses[img_id] = np.concatenate([geom.matrix_to_rotvec(R), t])
        self.reg_order.append(img_id)
        logger.info(
            f"Registered {self.data.image_names[img_id]} "
            f"({int(mask.sum())}/{len(mask)} PnP inliers)"
        )
        return True

    # -- triangulation ----------------------------------------------------

    def triangulate_new(self) -> int:
        """Multi-view DLT for tracks with >=2 registered views and no point.

        Vectorized: tracks are grouped by registered-view count V and each
        group is solved with one batched (T,4,4) eigendecomposition and
        validated with one batched projection — no per-track Python loop
        around LAPACK, so 100k-track scenes stay fast.
        """
        opt = self.opt
        Rm = {i: geom.rotvec_to_matrix(p[:3]) for i, p in self.poses.items()}
        groups: Dict[int, List[Tuple[int, List[int]]]] = {}
        for tid, tr in enumerate(self.tracks):
            if tid in self.points:
                continue
            reg = [i for i in tr if i in self.poses]
            if len(reg) >= 2:
                groups.setdefault(len(reg), []).append((tid, reg))
        new = 0
        for V, items in groups.items():
            T = len(items)
            xs = np.empty((T, V, 2))      # normalized coords
            uvs = np.empty((T, V, 2))     # raw pixels (for validation)
            Rs = np.empty((T, V, 3, 3))
            ts = np.empty((T, V, 3))
            intrs = np.empty((T, V, 8))
            for a, (tid, reg) in enumerate(items):
                tr = self.tracks[tid]
                for b, im in enumerate(reg):
                    k = tr[im]
                    uvs[a, b] = self.data.keypoints[im][k]
                    intrs[a, b] = self.intr[self.data.image_cam[im]]
                    Rs[a, b] = Rm[im]
                    ts[a, b] = self.poses[im][3:]
            # batch-undistort (vectorized fixed point; full OPENCV model,
            # distortion varies per view)
            xy = (uvs - intrs[..., 2:4]) / intrs[..., 0:2]
            xs = xy.copy()
            for _ in range(10):
                x1_, y1_ = xs[..., 0:1], xs[..., 1:2]
                r2 = x1_ * x1_ + y1_ * y1_
                radial = (1.0 + intrs[..., 4:5] * r2
                          + intrs[..., 5:6] * r2 * r2)
                dx = (2.0 * intrs[..., 6:7] * x1_ * y1_
                      + intrs[..., 7:8] * (r2 + 2.0 * x1_ * x1_))
                dy = (intrs[..., 6:7] * (r2 + 2.0 * y1_ * y1_)
                      + 2.0 * intrs[..., 7:8] * x1_ * y1_)
                xs = (xy - np.concatenate([dx, dy], axis=-1)) / radial
            P = np.concatenate([Rs, ts[..., None]], axis=-1)  # (T,V,3,4)
            rows = np.concatenate(
                [
                    xs[..., 0:1] * P[..., 2, :] - P[..., 0, :],
                    xs[..., 1:2] * P[..., 2, :] - P[..., 1, :],
                ],
                axis=1,
            )  # (T,2V,4)
            AtA = np.einsum("tij,tik->tjk", rows, rows)
            _, v = np.linalg.eigh(AtA)
            Xh = v[:, :, 0]
            w = Xh[:, 3:4]
            X = Xh[:, :3] / np.where(np.abs(w) < 1e-12, 1e-12, w)  # (T,3)
            # validate: cheirality + pixel reprojection in every view
            Xc = np.einsum("tvij,tj->tvi", Rs, X) + ts  # (T,V,3)
            z = Xc[..., 2]
            xyp = Xc[..., :2] / np.where(np.abs(z) < 1e-12, 1e-12, z)[..., None]
            uvp = geom.normalized_to_pixels(intrs, xyp)
            err = np.linalg.norm(uvp - uvs, axis=-1)  # (T,V)
            ok = (z > 0).all(axis=1) & (err <= opt.tri_thresh_px).all(axis=1)
            # max pairwise triangulation angle
            centers = -np.einsum("tvji,tvj->tvi", Rs, ts)  # R^T t with sign
            d = centers - X[:, None, :]  # (T,V,3)
            dn = d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-12)
            cosang = np.einsum("tvi,twi->tvw", dn, dn)
            np.einsum("tvv->tv", cosang)[...] = 1.0  # ignore self-pairs
            min_cos = cosang.min(axis=(1, 2))
            max_angle = np.degrees(np.arccos(np.clip(min_cos, -1.0, 1.0)))
            ok &= max_angle >= opt.tri_min_angle_deg
            for a, (tid, _) in enumerate(items):
                if ok[a]:
                    self.points[tid] = X[a]
                    new += 1
        return new

    # -- bundle adjustment / filtering -------------------------------------

    def _gather_problem(self):
        img_ids = list(self.reg_order)
        img_index = {im: i for i, im in enumerate(img_ids)}
        cam_ids = sorted(self.intr)
        cam_index = {c: i for i, c in enumerate(cam_ids)}
        tids = sorted(self.points)
        tid_index = {t: i for i, t in enumerate(tids)}
        obs_pose, obs_cam, obs_pt, obs_uv, obs_key = [], [], [], [], []
        for t in tids:
            tr = self.tracks[t]
            for im, k in tr.items():
                if im not in img_index:
                    continue
                obs_pose.append(img_index[im])
                obs_cam.append(cam_index[self.data.image_cam[im]])
                obs_pt.append(tid_index[t])
                obs_uv.append(self.data.keypoints[im][k])
                obs_key.append((t, im))
        return (
            img_ids, cam_ids, tids,
            np.array(obs_pose), np.array(obs_cam), np.array(obs_pt),
            np.asarray(obs_uv, np.float64), obs_key,
        )

    def global_ba(self, final: bool = False) -> None:
        """Full-scene bundle adjustment.

        On the adaptive schedule (``ba_global_every == 0``) in-loop
        refinements (``final=False``) run half the LM iterations — they are
        re-run as the model grows, so full convergence is wasted work
        (COLMAP likewise caps in-loop BA iterations); the closing BA, and
        every global BA of a forced schedule (``ba_global_every >= 1``), use
        the full ``ba_lm_iters``.
        """
        opt = self.opt
        halve = not final and opt.ba_global_every == 0
        n_lm = max(10, opt.ba_lm_iters // 2) if halve else opt.ba_lm_iters
        with self._phase("ba_gather"):
            (img_ids, cam_ids, tids, obs_pose, obs_cam, obs_pt, obs_uv,
             _) = self._gather_problem()
        if len(tids) == 0 or len(obs_pose) == 0:
            return
        poses = np.stack([self.poses[i] for i in img_ids])
        intr = np.stack([self.intr[c] for c in cam_ids])
        pts = np.stack([self.points[t] for t in tids])
        pose_free = np.ones((len(img_ids), 6))
        pose_free[0] = 0.0          # gauge: first pose constant
        if len(img_ids) > 1:
            pose_free[1, 3] = 0.0   # + one translation DOF (scale gauge)
        intr_free = np.zeros((len(cam_ids), 8))
        if opt.refine_focal:
            intr_free[:, 0:2] = 1.0
        if opt.refine_distortion:
            # free only the distortion terms the camera's SOURCE model has
            # (COLMAP refines per-model): SIMPLE_RADIAL -> k1, RADIAL ->
            # k1 k2, OPENCV -> k1 k2 p1 p2; pinhole models stay undistorted.
            # Fisheye models (5/8/9) are deliberately absent: their
            # keypoints were rectified to an ideal pinhole frame at load,
            # so the internal model must stay zero-distortion
            for i, c in enumerate(cam_ids):
                model = self.data.cameras[c]["model"]
                if model == 2:
                    intr_free[i, 4] = 1.0
                elif model == 3:
                    intr_free[i, 4:6] = 1.0
                elif model in (4, 6):
                    # 6 (FULL_OPENCV): k1 k2 p1 p2 live; the rational tail
                    # was rectified away at load and stays fixed
                    intr_free[i, 4:8] = 1.0
        out = bundle_adjust(
            poses, intr, pts, obs_pose, obs_cam, obs_pt, obs_uv,
            pose_free, intr_free,
            huber_delta_px=opt.filter_thresh_px,
            n_lm_iters=n_lm, n_cg_iters=opt.ba_cg_iters, device=self.device,
        )
        for i, im in enumerate(img_ids):
            self.poses[im] = out["poses"][i]
        for i, c in enumerate(cam_ids):
            self.intr[c] = out["intr"][i]
        for i, t in enumerate(tids):
            self.points[t] = out["points"][i]

    def local_ba(self, img_id: int) -> None:
        """Refine the newly registered pose + the points it observes.

        Covisible registered poses participate in the residuals but stay
        frozen, so the cost per registration is O(local), which is what lets
        ``ba_global_every=0`` (adaptive global schedule) scale to hundreds of
        images the way COLMAP's local/global split does.
        """
        opt = self.opt
        tids = [t for t in self.img_tracks[img_id] if t in self.points]
        if not tids:
            return
        involved = {img_id}
        for t in tids:
            for im in self.tracks[t]:
                if im in self.poses:
                    involved.add(im)
        img_ids = sorted(involved)
        img_index = {im: i for i, im in enumerate(img_ids)}
        cam_ids = sorted(self.intr)
        cam_index = {c: i for i, c in enumerate(cam_ids)}
        tid_index = {t: i for i, t in enumerate(tids)}
        obs_pose, obs_cam, obs_pt, obs_uv = [], [], [], []
        for t in tids:
            for im, k in self.tracks[t].items():
                if im not in img_index:
                    continue
                obs_pose.append(img_index[im])
                obs_cam.append(cam_index[self.data.image_cam[im]])
                obs_pt.append(tid_index[t])
                obs_uv.append(self.data.keypoints[im][k])
        pose_free = np.zeros((len(img_ids), 6))
        pose_free[img_index[img_id]] = 1.0
        out = bundle_adjust(
            np.stack([self.poses[i] for i in img_ids]),
            np.stack([self.intr[c] for c in cam_ids]),
            np.stack([self.points[t] for t in tids]),
            np.array(obs_pose), np.array(obs_cam), np.array(obs_pt),
            np.asarray(obs_uv, np.float64),
            pose_free, np.zeros((len(cam_ids), 8)),
            huber_delta_px=opt.filter_thresh_px,
            n_lm_iters=max(8, opt.ba_lm_iters // 2),
            n_cg_iters=opt.ba_cg_iters, device=self.device,
        )
        self.poses[img_id] = out["poses"][img_index[img_id]]
        for i, t in enumerate(tids):
            self.points[t] = out["points"][i]

    def filter_points(self) -> int:
        """Drop points with bad reprojection / cheirality in any view.

        Vectorized over all observations of all current points (one
        projection + one segment reduction on host).
        """
        opt = self.opt
        Rm = {i: geom.rotvec_to_matrix(p[:3]) for i, p in self.poses.items()}
        tids = list(self.points)
        if not tids:
            return 0
        rows_pt, rows_uv, rows_R, rows_t, rows_intr = [], [], [], [], []
        n_reg = np.zeros(len(tids), int)
        for a, tid in enumerate(tids):
            tr = self.tracks[tid]
            for im, k in tr.items():
                if im not in self.poses:
                    continue
                n_reg[a] += 1
                rows_pt.append(a)
                rows_uv.append(self.data.keypoints[im][k])
                rows_R.append(Rm[im])
                rows_t.append(self.poses[im][3:])
                rows_intr.append(self.intr[self.data.image_cam[im]])
        pt_idx = np.asarray(rows_pt)
        X = np.stack([self.points[t] for t in tids])[pt_idx]
        R = np.stack(rows_R)
        t = np.stack(rows_t)
        intr = np.stack(rows_intr)
        uv_obs = np.stack(rows_uv)
        Xc = np.einsum("oij,oj->oi", R, X) + t
        z = Xc[:, 2]
        xy = Xc[:, :2] / np.where(np.abs(z) < 1e-12, 1e-12, z)[:, None]
        uv = geom.normalized_to_pixels(intr, xy)
        bad_obs = (z <= 0) | (
            np.linalg.norm(uv - uv_obs, axis=1) > opt.filter_thresh_px
        )
        bad = np.zeros(len(tids), bool)
        np.logical_or.at(bad, pt_idx, bad_obs)
        bad |= n_reg < 2
        for a, tid in enumerate(tids):
            if bad[a]:
                del self.points[tid]
        return int(bad.sum())

    # -- main loop ---------------------------------------------------------

    def run(self) -> bool:
        with self._phase("initialize"):
            ok = self.initialize()
        if not ok:
            logger.error("Native mapper: no valid initial pair found")
            return False
        with self._phase("triangulate"):
            self.triangulate_new()
        with self._phase("global_ba"):
            self.global_ba()
        with self._phase("filter_points"):
            self.filter_points()
        last_global = len(self.poses)
        since_ba = 0
        relaxed = False
        while True:
            with self._phase("candidates"):
                candidates = self.next_candidates()
            progressed = False
            for _, img_id in candidates:
                with self._phase("register"):
                    registered = self.register_image(img_id)
                if registered:
                    progressed = True
                    with self._phase("triangulate"):
                        self.triangulate_new()
                    since_ba += 1
                    # ba_global_every >= 1: global BA every k registrations;
                    # 0 = adaptive (local BA each step, global on ~10% growth
                    # like COLMAP's local/global split)
                    if self.opt.ba_global_every > 0:
                        run_global = since_ba >= self.opt.ba_global_every
                    else:
                        with self._phase("local_ba"):
                            self.local_ba(img_id)
                        run_global = len(self.poses) >= 1.1 * last_global + 1
                    if run_global:
                        with self._phase("global_ba"):
                            self.global_ba()
                        with self._phase("filter_points"):
                            self.filter_points()
                        with self._phase("triangulate"):
                            self.triangulate_new()
                        since_ba = 0
                        last_global = len(self.poses)
                    break
            if not progressed:
                # one-shot stall relaxation (COLMAP-style retry with looser
                # absolute-pose bounds): small scenes legitimately have few
                # 2D-3D correspondences right after a thin initialization
                if not relaxed and len(self.poses) < len(self.data.image_names):
                    relaxed = True
                    self.opt.abs_pose_min_inliers = max(
                        6, self.opt.abs_pose_min_inliers // 2
                    )
                    self.opt.abs_pose_thresh_px *= 1.5
                    logger.info(
                        "Registration stalled; relaxing absolute-pose "
                        f"thresholds (min_inliers="
                        f"{self.opt.abs_pose_min_inliers}, thresh="
                        f"{self.opt.abs_pose_thresh_px:.1f} px) and retrying"
                    )
                    continue
                break
        with self._phase("global_ba"):
            self.global_ba(final=True)
        with self._phase("filter_points"):
            self.filter_points()
        self.log_phase_times()
        logger.info(
            f"Native mapper: {len(self.poses)}/{len(self.data.image_names)} "
            f"images registered, {len(self.points)} 3D points"
        )
        for name, reason in self.registration_report().items():
            logger.info(f"Unregistered {name}: {reason}")
        return len(self.poses) >= 2

    def registration_report(self) -> Dict[str, str]:
        """image name -> why it is NOT in the model (empty when all
        registered). Reasons come from the last failed registration attempt;
        images that never reached PnP are diagnosed here from their
        track/candidate state."""
        report: Dict[str, str] = {}
        for img_id, name in self.data.image_names.items():
            if img_id in self.poses:
                continue
            reason = self.reg_failures.get(img_id)
            if reason is None:
                if not self.img_tracks[img_id]:
                    reason = (
                        "no feature tracks (image has no verified matches, "
                        "or all its match components were ambiguous)"
                    )
                else:
                    vis = self._visible_correspondences(img_id)
                    n = 0 if vis is None else len(vis[0])
                    reason = (
                        f"only {n} visible 2D-3D correspondences (< 6 needed "
                        "for PnP) — likely a different connected component "
                        "or verified-pair starvation"
                    )
            report[name] = reason
        return report

    # -- export ------------------------------------------------------------

    def to_colmap_model(self, image_dir: Optional[Path] = None):
        """Convert the mapper state to COLMAP cameras/images/points3D dicts."""
        cameras = {}
        for cid, cam in self.data.cameras.items():
            fx, fy, cx, cy, k1, k2, p1, p2 = self.intr[cid]
            # write back the camera's SOURCE model with its refined params
            model = cam["model"]
            if model == 0:
                name, params = "SIMPLE_PINHOLE", [fx, cx, cy]
            elif model == 1:
                name, params = "PINHOLE", [fx, fy, cx, cy]
            elif model == 3:
                name, params = "RADIAL", [fx, cx, cy, k1, k2]
            elif model == 4:
                name, params = "OPENCV", [fx, fy, cx, cy, k1, k2, p1, p2]
            elif model == 6:
                # refined OPENCV part + the fixed (rectified-away) rational
                # tail; zeros if the source had none
                kr = cam.get("full_rational", np.zeros(12))[8:12]
                name = "FULL_OPENCV"
                params = [fx, fy, cx, cy, k1, k2, p1, p2,
                          kr[0], kr[1], kr[2], kr[3]]
            elif model == 7:
                name = "FOV"
                params = [fx, fy, cx, cy, cam.get("fov_omega", 0.0)]
            elif model == 10:
                tp = cam.get("thin_prism", np.zeros(12))
                name = "THIN_PRISM_FISHEYE"
                params = [fx, fy, cx, cy, *tp[4:12]]
            elif model in (5, 8, 9):
                # refined pinhole part + the fixed equidistant coefficients
                fk = cam.get("fisheye_k", np.zeros(4))
                if model == 5:
                    name = "OPENCV_FISHEYE"
                    params = [fx, fy, cx, cy, fk[0], fk[1], fk[2], fk[3]]
                elif model == 8:
                    name, params = "SIMPLE_RADIAL_FISHEYE", [fx, cx, cy, fk[0]]
                else:
                    name, params = "RADIAL_FISHEYE", [fx, cx, cy, fk[0], fk[1]]
            else:
                name, params = "SIMPLE_RADIAL", [fx, cx, cy, k1]
            cameras[cid] = Camera(
                id=cid, model=name,
                width=cam["width"], height=cam["height"],
                params=np.asarray(params, np.float64),
            )
        # per-image 2D points & point3D ids
        colors = _point_colors(self, image_dir)
        img_xys = {i: [] for i in self.poses}
        img_pids = {i: [] for i in self.poses}
        pt_entries = {}
        errors = {}
        for tid in sorted(self.points):
            tr = self.tracks[tid]
            X = self.points[tid]
            image_ids, p2d_idxs, errs = [], [], []
            for im, k in tr.items():
                if im not in self.poses:
                    continue
                intr = self.intr[self.data.image_cam[im]]
                p = self.poses[im]
                uv, _ = geom.project_points(
                    intr, geom.rotvec_to_matrix(p[:3]), p[3:], X[None]
                )
                errs.append(
                    np.linalg.norm(uv[0] - self.data.keypoints[im][k])
                )
                image_ids.append(im)
                p2d_idxs.append(len(img_xys[im]))
                # export the OBSERVED pixels (fisheye images store the
                # distorted originals in keypoints_raw; reprojection errors
                # above are computed in the rectified pinhole frame)
                img_xys[im].append(
                    self.data.keypoints_raw.get(
                        im, self.data.keypoints[im]
                    )[k]
                )
                img_pids[im].append(tid + 1)
            pt_entries[tid] = (image_ids, p2d_idxs)
            errors[tid] = float(np.mean(errs)) if errs else 0.0
        images = {}
        for im, p in self.poses.items():
            R = geom.rotvec_to_matrix(p[:3])
            images[im] = Image(
                id=im, qvec=rotmat2qvec(R), tvec=p[3:].copy(),
                camera_id=self.data.image_cam[im],
                name=self.data.image_names[im],
                xys=np.asarray(img_xys[im], np.float64).reshape(-1, 2),
                point3D_ids=np.asarray(img_pids[im], np.int64),
            )
        points3D = {}
        for tid in sorted(self.points):
            image_ids, p2d_idxs = pt_entries[tid]
            points3D[tid + 1] = Point3D(
                id=tid + 1, xyz=self.points[tid].copy(),
                rgb=colors.get(tid, np.array([128, 128, 128], np.uint8)),
                error=errors[tid],
                image_ids=np.asarray(image_ids, np.int64),
                point2D_idxs=np.asarray(p2d_idxs, np.int64),
            )
        return cameras, images, points3D


def _point_colors(
    mapper: IncrementalMapper, image_dir: Optional[Path]
) -> Dict[int, np.ndarray]:
    """Sample the color of each point from its first observing image."""
    colors: Dict[int, np.ndarray] = {}
    if image_dir is None:
        return colors
    try:
        import cv2
    except ImportError:
        return colors
    by_image: Dict[int, List[int]] = {}
    for tid in mapper.points:
        for im in mapper.tracks[tid]:
            if im in mapper.poses:
                by_image.setdefault(im, []).append(tid)
                break
    for im, tids in by_image.items():
        path = Path(image_dir) / mapper.data.image_names[im]
        img = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if img is None:
            continue
        h, w = img.shape[:2]
        for tid in tids:
            k = mapper.tracks[tid][im]
            x, y = mapper.data.keypoints[im][k]
            xi = int(np.clip(round(x), 0, w - 1))
            yi = int(np.clip(round(y), 0, h - 1))
            colors[tid] = img[yi, xi, ::-1].astype(np.uint8)  # BGR->RGB
    return colors


def write_ply(path: Path, points3D: Dict[int, Point3D]) -> None:
    """Write the sparse point cloud as binary little-endian PLY."""
    pts = list(points3D.values())
    with open(path, "wb") as f:
        f.write(
            (
                "ply\nformat binary_little_endian 1.0\n"
                f"element vertex {len(pts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                "end_header\n"
            ).encode()
        )
        if pts:
            xyz = np.stack([p.xyz for p in pts]).astype("<f4")
            rgb = np.stack([p.rgb for p in pts]).astype(np.uint8)
            rec = np.zeros(
                len(pts),
                dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)],
            )
            rec["xyz"] = xyz
            rec["rgb"] = rgb
            f.write(rec.tobytes())


def native_triangulate_points(
    model_path: Path,
    database_path: Path,
    image_dir: Path,
    output_dir: Path,
    options: Optional[dict] = None,
    device=None,
):
    """Point triangulation with *known poses* (no pycolmap).

    Reads camera poses from an existing COLMAP model and keypoints/matches
    from the database, triangulates all tracks, runs a points-only bundle
    adjustment (poses and intrinsics frozen), and writes the completed model.
    Mirrors ``pycolmap.triangulate_points`` for the triangulation-only
    workflow (reference ``triangulation.py:255-306``). The refinement runs
    on ``device``.
    """
    from ..io.colmap_read_write_model import qvec2rotmat, read_model

    known = {f for f in MapperOptions.__dataclass_fields__}
    opt = MapperOptions(
        **{k: v for k, v in (options or {}).items() if k in known}
    )
    data = load_database(Path(database_path))
    cameras_in, images_in, _ = read_model(Path(model_path))
    mapper = IncrementalMapper(data, opt, device)
    name_to_id = {n: i for i, n in data.image_names.items()}
    for im in images_in.values():
        img_id = name_to_id.get(im.name)
        if img_id is None:
            logger.warning(f"Model image {im.name} not found in database")
            continue
        R = qvec2rotmat(im.qvec)
        mapper.poses[img_id] = np.concatenate(
            [geom.matrix_to_rotvec(R), np.asarray(im.tvec, np.float64)]
        )
        mapper.reg_order.append(img_id)
    if len(mapper.poses) < 2:
        logger.error("Native triangulation: fewer than 2 posed images")
        return None
    n = mapper.triangulate_new()
    logger.info(f"Triangulated {n} points from known poses")
    # points-only refinement: freeze all poses and intrinsics
    (img_ids, cam_ids, tids, obs_pose, obs_cam, obs_pt, obs_uv,
     _) = mapper._gather_problem()
    if tids:
        out = bundle_adjust(
            np.stack([mapper.poses[i] for i in img_ids]),
            np.stack([mapper.intr[c] for c in cam_ids]),
            np.stack([mapper.points[t] for t in tids]),
            obs_pose, obs_cam, obs_pt, obs_uv,
            pose_free=np.zeros((len(img_ids), 6)),
            intr_free=np.zeros((len(cam_ids), 8)),
            huber_delta_px=opt.filter_thresh_px,
            n_lm_iters=opt.ba_lm_iters, n_cg_iters=opt.ba_cg_iters,
            device=mapper.device,
        )
        for i, t in enumerate(tids):
            mapper.points[t] = out["points"][i]
    mapper.filter_points()
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    cameras, images, points3D = mapper.to_colmap_model(image_dir)
    write_model(cameras, images, points3D, output_dir, ext=".txt")
    write_ply(output_dir / "model.ply", points3D)
    logger.info(
        f"Native triangulation: {len(points3D)} points across "
        f"{len(images)} posed images -> {output_dir}"
    )
    return cameras, images, points3D


def scene_components(data: SfMData) -> List[set]:
    """Connected components of the IMAGE graph (an edge per verified pair),
    largest first. A disconnected scene graph yields multiple independent
    models; the reference gets this from COLMAP's multi-model output and
    keeps the largest (``reconstruction.py:81-89``)."""
    parent: Dict[int, int] = {i: i for i in data.image_names}

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for (i0, i1), m in data.pair_matches.items():
        if len(m) and i0 in parent and i1 in parent:
            parent[find(i0)] = find(i1)
    comps: Dict[int, set] = {}
    for i in parent:
        comps.setdefault(find(i), set()).add(i)
    return sorted(comps.values(), key=len, reverse=True)


def _component_subset(data: SfMData, comp: set) -> SfMData:
    return SfMData(
        image_names={i: n for i, n in data.image_names.items() if i in comp},
        image_cam={i: c for i, c in data.image_cam.items() if i in comp},
        keypoints={i: k for i, k in data.keypoints.items() if i in comp},
        cameras=data.cameras,
        pair_matches={
            p: m for p, m in data.pair_matches.items()
            if p[0] in comp and p[1] in comp
        },
        keypoints_raw={
            i: k for i, k in data.keypoints_raw.items() if i in comp
        },
    )


def native_incremental_mapping(
    database_path: Path,
    image_dir: Path,
    output_dir: Path,
    options: Optional[dict] = None,
    export_text: bool = True,
    export_ply: bool = True,
    device=None,
):
    """Drop-in reconstruction entry point mirroring the pycolmap wrapper.

    Returns (cameras, images, points3D) dicts or None on failure; writes the
    COLMAP text model and model.ply under ``output_dir/reconstruction``.

    A disconnected scene graph is mapped per connected component and the
    largest resulting model is kept — the behavior the reference gets from
    COLMAP's multi-model output (``reconstruction.py:81-89``). Bundle
    adjustment runs on ``device`` (``utils/device.resolve_device``).
    """
    known = {f for f in MapperOptions.__dataclass_fields__}
    opts = dict(options or {})
    unknown = set(opts) - known
    if unknown:
        # tolerate pycolmap-style option dicts when "auto" falls back here
        logger.debug(f"Native mapper ignoring unknown options: {sorted(unknown)}")
    opt = MapperOptions(**{k: v for k, v in opts.items() if k in known})
    data = load_database(Path(database_path))
    if not data.pair_matches:
        logger.error("Native mapper: database has no verified matches")
        return None
    comps = [c for c in scene_components(data) if len(c) >= 2]
    mapper = None
    if len(comps) > 1:
        logger.info(
            f"Scene graph has {len(comps)} connected components "
            f"(sizes {[len(c) for c in comps]}); mapping each and keeping "
            "the largest model"
        )
        best_key, mapped = None, []
        for ci, comp in enumerate(comps):
            m = IncrementalMapper(_component_subset(data, comp), opt, device)
            ok = m.run()
            n_reg, n_pts = len(m.poses), len(m.points)
            logger.info(
                f"Component {ci}: {'mapped' if ok else 'FAILED'} "
                f"{n_reg}/{len(comp)} images, {n_pts} points"
            )
            if ok:
                mapped.append((ci, m))
            key = (n_reg, n_pts) if ok else (-1, -1)
            if best_key is None or key > best_key:
                best_key, mapper = key, m
        if best_key is None or best_key[0] < 2:
            return None
    else:
        mapped = []
        mapper = IncrementalMapper(data, opt, device)
        if not mapper.run():
            return None
    rec_dir = Path(output_dir) / "reconstruction"
    rec_dir.mkdir(parents=True, exist_ok=True)
    cameras, images, points3D = mapper.to_colmap_model(image_dir)
    if export_text:
        write_model(cameras, images, points3D, rec_dir, ext=".txt")
        # COLMAP writes EVERY model under models/N before the reference
        # picks the largest (reconstruction.py:81-89); mirror that so the
        # smaller components are not lost
        for ci, m in mapped:
            if m is mapper:
                continue
            mdir = rec_dir / "models" / str(ci)
            mdir.mkdir(parents=True, exist_ok=True)
            c2, i2, p2 = m.to_colmap_model(image_dir)
            write_model(c2, i2, p2, mdir, ext=".txt")
            logger.info(
                f"Secondary model (component {ci}): {len(i2)} images, "
                f"{len(p2)} points -> {mdir}"
            )
    if export_ply:
        write_ply(rec_dir / "model.ply", points3D)
    # per-image registration report artifact: why each absent image is
    # absent (reasons from the winning mapper; images in OTHER connected
    # components are named as such — COLMAP users get this by inspecting
    # the other models/N directories)
    try:
        report = dict(mapper.registration_report())
        if len(comps) > 1:
            kept = set(mapper.data.image_names)
            for ci, comp in enumerate(comps):
                if comp == kept or not (comp - kept):
                    continue
                for i in comp - kept:
                    report[data.image_names[i]] = (
                        f"in connected component {ci} (size {len(comp)}) — "
                        "mapped as a separate model; the largest model "
                        "was kept"
                    )
        lines = [
            f"registered {len(images)}/{len(data.image_names)} images, "
            f"{len(points3D)} 3D points",
        ]
        lines += [f"{name}: {reason}" for name, reason in sorted(report.items())]
        (rec_dir / "registration_report.txt").write_text(
            "\n".join(lines) + "\n"
        )
    except Exception as e:  # the report must never fail the reconstruction
        logger.debug(f"registration report write failed: {e}")
    logger.info(
        f"Native reconstruction written to {rec_dir} "
        f"({len(images)} images, {len(points3D)} points)"
    )
    return cameras, images, points3D
