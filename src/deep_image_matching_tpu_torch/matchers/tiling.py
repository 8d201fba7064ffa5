"""Tiled matching: tile-pair selection and the low-resolution probes
(port of ``deep_image_matching_tpu/matchers/tiling.py``).

Parity with the reference ``matchers/matcher_base.py:362-485``
(``_match_by_tile``) and ``:989-1342`` (``tile_selection``): EXHAUSTIVE =
every tile pair, GRID = same-index pairs, PRESELECTION = a low-resolution
probe's matches mapped into the tile rectangles (keep tile pairs with at
least ``min_matches``), PRESELECTION_AFFINE_TRANSFORM = an affine fitted to
the probe's matches maps image 0's tiles onto image 1's.

Features are extracted once per image with a ``tile_idx`` per keypoint; a
tile-pair job is the same batched matching program with each side's mask
restricted to one tile (``BatchedMatcher._match_all_tiled``). Indices stay
global, so the jobs' results are unioned and deduplicated on the query index.
``tile_grid_for``, ``points_in_tiles``, ``estimate_affine_ransac`` and
``select_tile_pairs`` are numpy copies of the JAX package's.
"""

from __future__ import annotations

import itertools
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..constants import TileSelection
from ..utils.tiling import Tiler

logger = logging.getLogger("dim_tpu_torch")


def tile_grid_for(image_wh, tile_size, overlap) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Recompute the tile origins used at extraction time for an image of
    (w, h). Returns (origins (N,2) x/y, (tile_w, tile_h))."""
    w, h = int(image_wh[0]), int(image_wh[1])
    tiler = Tiler()
    dummy = np.zeros((h, w), np.uint8)
    _, origins, _ = tiler.compute_tiles_array(dummy, tile_size, overlap)
    if isinstance(tile_size, int):
        tw = th = int(tile_size)
    else:
        tw, th = int(tile_size[0]), int(tile_size[1])
    return origins, (tw, th)


def points_in_tiles(pts: np.ndarray, origins: np.ndarray, tile_wh) -> np.ndarray:
    """(M, T) bool: point m falls inside tile t's rectangle."""
    tw, th = tile_wh
    x = pts[:, 0:1]
    y = pts[:, 1:2]
    x0 = origins[None, :, 0]
    y0 = origins[None, :, 1]
    return (x >= x0) & (x < x0 + tw) & (y >= y0) & (y < y0 + th)


def estimate_affine_ransac(
    src: np.ndarray, dst: np.ndarray, iters: int = 200, thresh: float = 8.0,
    seed: int = 0,
) -> Optional[np.ndarray]:
    """Least-squares 2-D affine (2x3) from point correspondences with a tiny
    RANSAC loop (numpy-only stand-in for the reference's
    ``cv2.estimateAffine2D``, ``matcher_base.py:1169-1243``)."""
    n = len(src)
    if n < 3:
        return None
    rng = np.random.default_rng(seed)
    ones = np.ones((n, 1), np.float32)
    X = np.concatenate([src.astype(np.float32), ones], 1)  # (n, 3)
    Y = dst.astype(np.float32)

    def solve(idx):
        A, *_ = np.linalg.lstsq(X[idx], Y[idx], rcond=None)
        return A  # (3, 2)

    best_inl, best_A = None, None
    for _ in range(iters):
        idx = rng.choice(n, size=3, replace=False)
        try:
            A = solve(idx)
        except np.linalg.LinAlgError:
            continue
        err = np.linalg.norm(X @ A - Y, axis=1)
        inl = err < thresh
        if best_inl is None or inl.sum() > best_inl.sum():
            best_inl, best_A = inl, A
    if best_inl is None or best_inl.sum() < 3:
        return None
    best_A = solve(np.nonzero(best_inl)[0])  # refit on inliers
    return best_A.T  # (2, 3) row-vector convention: p1 = A @ [x, y, 1]


def _rect_intersection_frac(b0: np.ndarray, rects1: np.ndarray) -> np.ndarray:
    """Fraction of each rect in ``rects1`` (N, 4 = x0 y0 x1 y1) covered by
    box ``b0`` (4,)."""
    ix0 = np.maximum(b0[0], rects1[:, 0])
    iy0 = np.maximum(b0[1], rects1[:, 1])
    ix1 = np.minimum(b0[2], rects1[:, 2])
    iy1 = np.minimum(b0[3], rects1[:, 3])
    inter = np.clip(ix1 - ix0, 0, None) * np.clip(iy1 - iy0, 0, None)
    area1 = (rects1[:, 2] - rects1[:, 0]) * (rects1[:, 3] - rects1[:, 1])
    return inter / np.maximum(area1, 1e-9)


def select_tile_pairs(
    mode: TileSelection,
    n_tiles0: int,
    n_tiles1: int,
    lowres_pts0: Optional[np.ndarray] = None,
    lowres_pts1: Optional[np.ndarray] = None,
    origins0: Optional[np.ndarray] = None,
    origins1: Optional[np.ndarray] = None,
    tile_wh0=None,
    tile_wh1=None,
    min_matches: int = 10,
) -> List[Tuple[int, int]]:
    if mode is TileSelection.EXHAUSTIVE:
        return list(itertools.product(range(n_tiles0), range(n_tiles1)))
    if mode is TileSelection.GRID:
        n = min(n_tiles0, n_tiles1)
        return [(t, t) for t in range(n)]
    if mode in (TileSelection.PRESELECTION, TileSelection.PRESELECTION_AFFINE_TRANSFORM):
        if lowres_pts0 is None or len(lowres_pts0) == 0:
            logger.debug("No low-res matches; falling back to exhaustive tiles")
            return list(itertools.product(range(n_tiles0), range(n_tiles1)))
        if mode is TileSelection.PRESELECTION_AFFINE_TRANSFORM:
            # Reference ``matcher_base.py:1169-1335``: fit an affine to the
            # low-res matches, project every image-0 tile rectangle into
            # image 1, keep tile pairs whose rectangles overlap. Falls back
            # to point-count preselection when the fit fails (``:1244-1258``).
            A = estimate_affine_ransac(lowres_pts0, lowres_pts1)
            if A is not None:
                tw0, th0 = tile_wh0
                tw1, th1 = tile_wh1
                rects1 = np.concatenate(
                    [origins1, origins1 + np.array([[tw1, th1]])], 1
                ).astype(np.float32)  # (T1, 4)
                pairs = []
                for t0, (x0, y0) in enumerate(np.asarray(origins0, np.float32)):
                    corners = np.array(
                        [[x0, y0], [x0 + tw0, y0], [x0, y0 + th0],
                         [x0 + tw0, y0 + th0]], np.float32
                    )
                    proj = corners @ A[:, :2].T + A[:, 2]
                    bbox = np.array(
                        [proj[:, 0].min(), proj[:, 1].min(),
                         proj[:, 0].max(), proj[:, 1].max()], np.float32
                    )
                    frac = _rect_intersection_frac(bbox, rects1)
                    for t1 in np.nonzero(frac > 0.05)[0]:
                        pairs.append((int(t0), int(t1)))
                if pairs:
                    return pairs
                logger.debug(
                    "Affine tile preselection found no overlapping tiles; "
                    "falling back to point counting"
                )
        in0 = points_in_tiles(lowres_pts0, origins0, tile_wh0)  # (M, T0)
        in1 = points_in_tiles(lowres_pts1, origins1, tile_wh1)  # (M, T1)
        counts = in0.astype(np.int32).T @ in1.astype(np.int32)  # (T0, T1)
        pairs = [tuple(p) for p in np.argwhere(counts >= min_matches)]
        if not pairs:
            pairs = [tuple(np.unravel_index(np.argmax(counts), counts.shape))]
        return [(int(a), int(b)) for a, b in pairs]
    raise ValueError(f"Unsupported tile selection {mode}")


class LowResProbe:
    """Low-resolution match probe for tile preselection (reference
    ``matcher_base.py:1095-1138``: SuperPoint+LightGlue at
    ``tile_preselection_size``).

    SuperPoint runs on ``device`` with the probe's own keypoint budget. The
    pair matches with LightGlue where pretrained SuperPoint-LightGlue weights
    are found (``utils/weights.py``'s lookup, the reference's behaviour);
    without them it takes symmetric mutual nearest neighbours of the raw
    descriptors (``nn_match_auto``, mode smnn, ratio 0.95: kernel 5 on
    CUDA), which are deterministic and shift-equivariant even under random
    extractor weights."""

    def __init__(self, preselection_size: int = 1000, max_keypoints: int = 1024,
                 device: torch.device = torch.device("cpu")):
        self.size = preselection_size
        self.max_keypoints = max_keypoints
        self.device = torch.device(device)
        self._runner = None
        self._lg = None
        self._lg_checked = False
        self._cache: Dict[str, dict] = {}

    def _get_runner(self):
        if self._runner is None:
            from ..models.superpoint import SuperPointRunner

            self._runner = SuperPointRunner(max_keypoints=self.max_keypoints,
                                            resize_max=self.size, device=self.device)
        return self._runner

    def _get_lightglue(self):
        """A LightGlueRunner iff pretrained SuperPoint-LightGlue weights
        exist."""
        if not self._lg_checked:
            self._lg_checked = True
            from ..models.lightglue import LightGlueRunner, load_default_model
            from ..utils import weights as W

            try:
                with W.strict():
                    model = load_default_model("superpoint")
            except W.MissingWeightsError:
                model = None
            if model is not None:
                self._lg = LightGlueRunner(model=model, features="superpoint",
                                           device=self.device)
        return self._lg

    def matches(self, path0, path1) -> Tuple[np.ndarray, np.ndarray]:
        """Matched full-resolution coordinates of an image pair."""
        from ..ops.nn_match import nn_match_auto

        feats = []
        for p in (path0, path1):
            key = str(p)
            if key not in self._cache:
                self._cache[key] = self._get_runner().extract_images([p])[0]
            feats.append(self._cache[key])
        f0, f1 = feats

        lg = self._get_lightglue()
        if lg is not None:
            idx = lg.match_pairs([f0, f1], [(0, 1)])[0]  # (M, 2)
            return (np.asarray(f0["keypoints"])[idx[:, 0]],
                    np.asarray(f1["keypoints"])[idx[:, 1]])

        cap = max(128, ((max(len(f0["keypoints"]), len(f1["keypoints"])) + 127) // 128) * 128)

        def pad(f):
            k = np.zeros((cap, 2), np.float32)
            d = np.zeros((cap, f["descriptors"].shape[-1]), np.float32)
            m = np.zeros((cap,), bool)
            n = len(f["keypoints"])
            k[:n], d[:n], m[:n] = f["keypoints"], f["descriptors"], True
            return k, d, m

        k0, d0, m0 = pad(f0)
        k1, d1, m1 = pad(f1)
        dev = self.device
        matches0, valid = nn_match_auto(
            torch.from_numpy(d0[None]).to(dev), torch.from_numpy(d1[None]).to(dev),
            torch.from_numpy(m0[None]).to(dev), torch.from_numpy(m1[None]).to(dev),
            mode="smnn", ratio_th=0.95)
        matches0, valid = matches0[0].cpu().numpy(), valid[0].cpu().numpy()
        rows = np.nonzero(valid)[0]
        return k0[rows], k1[matches0[rows]]


class RomaProbe:
    """RoMa preselection probe (reference ``matcher_base.py:1095-1110``:
    ``preselection_pipeline: roma`` matches the downsampled pair densely and
    samples 5000 correspondences). The symmetric coarse pass at 560 without
    the upsample refinement, as the JAX package runs it (the reference probe
    uses coarse 420 + upsample 560; the coarse grid needs multiples of 56)."""

    def __init__(self, num_points: int = 5000, device: torch.device = torch.device("cpu")):
        self._matcher = None
        self.num_points = num_points
        self.device = torch.device(device)

    def _get(self):
        if self._matcher is None:
            from .roma import RomaMatcher

            self._matcher = RomaMatcher({
                "matcher": {"name": "roma", "coarse_res": 560, "upsample_preds": False,
                            "num_sampled_points": self.num_points},
                "general": {"tpu": {"device": str(self.device)}},
            })
        return self._matcher

    def matches(self, path0, path1) -> Tuple[np.ndarray, np.ndarray]:
        return self._get()._match_images(path0, path1)
