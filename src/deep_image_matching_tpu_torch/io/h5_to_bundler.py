"""Export tie points as a Bundler v0.3 file, the Metashape import path (port
of ``deep_image_matching_tpu/io/h5_to_bundler.py``).

Multiview tracks come from the exact feature-index union-find of
``io/tracks.py``; a proximity pass (cKDTree candidates within
``px_tolerance``, optionally gated by descriptor cosine similarity) then
fuses near-duplicate observations within an image, resolving transitive
track merges. Orphan tracks are dropped, each image's observations get
sequential feature indices, each track its mean grey colour, and the camera
block comes from cameras.yaml (focal, k1, k2; a dummy otherwise). The h5
files are read through ``io/hdf5.py``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
from PIL import Image as PILImage

from . import hdf5
from .tracks import build_tracks

logger = logging.getLogger("dim_tpu_torch")


def _parse_camera_config(
    image_ids: List[str],
    image_shapes: Dict[str, tuple],
    config: Dict[str, Any],
) -> List[Dict[str, Any]]:
    """cameras.yaml -> per-image {focal_length, k1, k2, R, t} in image order
    (reference ``h5_to_bundler.py:146-213``: 'images' glob lists per camN
    entry; intrinsics = [f, cx, cy, k1, k2, ...]; 1.2*max_size focal prior)."""
    img_to_opts: Dict[str, dict] = {}
    for key, opts in config.items():
        if key == "general" or not isinstance(opts, dict):
            continue
        for pattern in str(opts.get("images", "")).split(","):
            pattern = pattern.strip()
            if pattern and pattern in image_ids:
                img_to_opts[pattern] = opts

    cameras = []
    for name in image_ids:
        w, h = image_shapes.get(name, (0, 0))
        focal = 1.2 * max(w, h) if max(w, h) > 0 else 1.0
        k1 = k2 = 0.0
        opts = img_to_opts.get(name)
        intr = (opts or {}).get("intrinsics") or []
        if len(intr) >= 1:
            focal = float(intr[0])
        if len(intr) > 3:
            k1 = float(intr[3])
        if len(intr) > 4:
            k2 = float(intr[4])
        cameras.append(
            {
                "focal_length": focal, "k1": k1, "k2": k2,
                "rotation_matrix": [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0],
                "translation_vector": [0.0, 0.0, 0.0],
            }
        )
    return cameras


def _chain_roots(mapping_pairs: np.ndarray) -> Dict[int, int]:
    """Resolve transitive (old -> new) track merges to their final roots
    (reference ``_resolve_mapping_chains :788-820``, union-find with path
    compression)."""
    parent: Dict[int, int] = {}
    for old, new in mapping_pairs:
        parent[int(old)] = int(new)

    def find(x: int) -> int:
        root = x
        while root in parent:
            root = parent[root]
        while x != root:
            parent[x], x = root, parent[x]
        return root

    return {old: find(old) for old in list(parent)}


def _merge_observations(
    x: np.ndarray, y: np.ndarray, img_idx: np.ndarray, track: np.ndarray,
    color: np.ndarray, desc: Optional[np.ndarray],
    image_sizes: np.ndarray,  # (n_images, 2) (w, h)
    px_tolerance: float, descriptor_threshold: float, max_merge_iters: int,
):
    """Iterative within-image observation merging (reference ``_merge_tracks
    :517-645``): spatially close observations (within px_tolerance, in
    max-dim-normalized coordinates) whose descriptors are cosine-similar
    (when available) unify their tracks; coordinates/colors/descriptors are
    averaged; transitive merges resolve via union-find; duplicate
    (image, track) observations collapse."""
    from scipy.spatial import cKDTree

    for it in range(max_merge_iters):
        mappings = []
        n_merged = 0
        for ii in np.unique(img_idx):
            sel = np.nonzero(img_idx == ii)[0]
            if len(sel) < 2:
                continue
            w, h = image_sizes[ii]
            scale = float(max(w, h))
            coords = np.stack([x[sel], y[sel]], 1) / scale
            pairs = cKDTree(coords).query_pairs(
                r=px_tolerance / scale, output_type="ndarray"
            )
            if pairs.size == 0:
                continue
            if desc is not None:
                d = desc[sel]
                di, dj = d[pairs[:, 0]], d[pairs[:, 1]]
                num = np.einsum("nd,nd->n", di, dj)
                den = np.linalg.norm(di, axis=1) * np.linalg.norm(dj, axis=1)
                sim = np.where(den > 1e-8, num / np.maximum(den, 1e-8), 0.0)
                pairs = pairs[sim >= descriptor_threshold]
                if pairs.size == 0:
                    continue
            # greedy one-merge-per-track-per-iteration (reference
            # processed_tracks semantics)
            used: set = set()
            for a, b in pairs:
                ga, gb = sel[a], sel[b]
                ta, tb = int(track[ga]), int(track[gb])
                if ta == tb or ta in used or tb in used:
                    continue
                lo, hi = (ta, tb) if ta < tb else (tb, ta)
                mx = 0.5 * (x[ga] + x[gb])
                my = 0.5 * (y[ga] + y[gb])
                mc = (int(color[ga]) + int(color[gb])) // 2
                x[ga] = x[gb] = mx
                y[ga] = y[gb] = my
                color[ga] = color[gb] = mc
                track[ga] = track[gb] = lo
                if desc is not None:
                    md = 0.5 * (desc[ga] + desc[gb])
                    n = np.linalg.norm(md)
                    md = md / n if n > 1e-8 else np.zeros_like(md)
                    desc[ga] = desc[gb] = md
                mappings.append((hi, lo))
                used.add(ta)
                used.add(tb)
                n_merged += 1
        if not mappings:
            if it:
                logger.debug(f"Track merging converged after {it} iterations")
            break
        roots = _chain_roots(np.asarray(mappings, np.int64))
        if roots:
            track = np.array([roots.get(int(t), int(t)) for t in track],
                             np.int64)
        # drop duplicate (image, track) observations
        _, keep = np.unique(
            np.stack([img_idx, track], 1), axis=0, return_index=True
        )
        keep = np.sort(keep)
        x, y, img_idx, track, color = (
            x[keep], y[keep], img_idx[keep], track[keep], color[keep]
        )
        if desc is not None:
            desc = desc[keep]
        logger.debug(f"Merge iteration {it + 1}: {n_merged} track pairs")
    return x, y, img_idx, track, color


def export_to_bundler(
    img_dir: Path,
    feature_path: Path,
    match_path: Path,
    out_dir: Path,
    out_name: str = "bundler",
    min_track_length: int = 2,
    px_tolerance: float = 1.0,
    use_descriptors: bool = False,
    descriptor_threshold: float = 0.8,
    max_merge_iters: int = 10,
    camera_config_path: Optional[Path] = None,
) -> Optional[Path]:
    img_dir = Path(img_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    names, tracks = build_tracks(match_path, min_track_length=min_track_length)
    if not tracks:
        logger.warning("No tracks built; skipping Bundler export")
        return None

    # keypoints, descriptors, image sizes, grayscale pixels for colors
    kpts: Dict[str, np.ndarray] = {}
    descs: Dict[str, Optional[np.ndarray]] = {}
    sizes = np.zeros((len(names), 2), np.int64)
    grays: Dict[str, Optional[np.ndarray]] = {}
    with hdf5.File(feature_path, "r") as fd:
        for i, name in enumerate(names):
            kpts[name] = np.asarray(fd[name]["keypoints"])
            if use_descriptors and "descriptors" in fd[name]:
                d = np.asarray(fd[name]["descriptors"], np.float32)
                # h5 schema stores (D, N); observations want rows
                if d.ndim == 2 and d.shape[0] != len(kpts[name]):
                    d = d.T
                descs[name] = d
            else:
                descs[name] = None
            if "image_size" in fd[name]:
                sizes[i] = np.asarray(fd[name]["image_size"])[:2]
            else:
                with PILImage.open(img_dir / name) as im:
                    sizes[i] = np.array(im.size)
            try:
                with PILImage.open(img_dir / name) as im:
                    grays[name] = np.asarray(im.convert("L"))
            except Exception:
                grays[name] = None

    have_desc = use_descriptors and all(d is not None for d in descs.values())
    if use_descriptors and not have_desc:
        logger.warning(
            "Descriptors requested but missing for some images; "
            "merging by proximity only"
        )

    # flatten tracks -> observation arrays
    n_obs = sum(len(t) for t in tracks)
    x = np.empty(n_obs, np.float64)
    y = np.empty(n_obs, np.float64)
    img_idx = np.empty(n_obs, np.int32)
    track_id = np.empty(n_obs, np.int64)
    color = np.empty(n_obs, np.int32)
    desc_dim = (
        next(iter(descs.values())).shape[1] if have_desc else 0
    )
    desc = np.empty((n_obs, desc_dim), np.float32) if have_desc else None
    k = 0
    for t, obs in enumerate(tracks):
        for ii, fi in obs:
            name = names[ii]
            px, py = kpts[name][fi][:2]
            x[k], y[k] = px, py
            img_idx[k] = ii
            track_id[k] = t
            g = grays[name]
            if g is not None:
                color[k] = int(
                    g[min(int(py), g.shape[0] - 1), min(int(px), g.shape[1] - 1)]
                )
            else:
                color[k] = 128
            if have_desc:
                desc[k] = descs[name][fi]
            k += 1

    if px_tolerance > 0:
        x, y, img_idx, track_id, color = _merge_observations(
            x, y, img_idx, track_id, color, desc, sizes,
            px_tolerance, descriptor_threshold, max_merge_iters,
        )

    # finalize (reference _finalize_bundler): drop orphan tracks, reindex,
    # per-image sequential feature indices, Bundler-centered coordinates
    uniq, inv = np.unique(track_id, return_inverse=True)
    # images per track
    pair_keys = np.unique(np.stack([inv, img_idx.astype(np.int64)], 1), axis=0)
    imgs_per_track = np.bincount(pair_keys[:, 0], minlength=len(uniq))
    keep_tracks = imgs_per_track >= 2
    keep_obs = keep_tracks[inv]
    n_drop = int((~keep_tracks).sum())
    if n_drop:
        logger.debug(f"Dropping {n_drop} orphan tracks (<2 images)")
    x, y, img_idx, color = x[keep_obs], y[keep_obs], img_idx[keep_obs], color[keep_obs]
    track_id = inv[keep_obs]
    uniq2, track_id = np.unique(track_id, return_inverse=True)
    n_tracks = len(uniq2)

    order = np.lexsort((track_id, img_idx))
    x, y, img_idx, track_id, color = (
        x[order], y[order], img_idx[order], track_id[order], color[order]
    )
    # per-image cumcount
    feature_idx = np.zeros(len(x), np.int64)
    for ii in np.unique(img_idx):
        sel = img_idx == ii
        feature_idx[sel] = np.arange(int(sel.sum()))

    w_arr = sizes[img_idx, 0].astype(np.float64)
    h_arr = sizes[img_idx, 1].astype(np.float64)
    bx = x - w_arr / 2.0
    by = h_arr / 2.0 - y

    # camera block
    camera_data = None
    if camera_config_path and Path(camera_config_path).exists():
        import yaml

        with open(camera_config_path) as f:
            camera_data = _parse_camera_config(
                names, {n: tuple(sizes[i]) for i, n in enumerate(names)},
                yaml.safe_load(f) or {},
            )
    if camera_data is None:
        camera_data = [
            {
                "focal_length": 1.0, "k1": 0.0, "k2": 0.0,
                "rotation_matrix": [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0],
                "translation_vector": [0.0, 0.0, 0.0],
            }
            for _ in names
        ]

    bundler_path = out_dir / f"{out_name}.out"
    list_path = out_dir / f"{out_name}_list.txt"
    with open(list_path, "w") as f:
        for name in names:
            f.write(f"{name}\n")

    # per-track mean color + observation lines
    sum_color = np.bincount(track_id, weights=color, minlength=n_tracks)
    cnt = np.bincount(track_id, minlength=n_tracks)
    avg_color = np.rint(sum_color / np.maximum(cnt, 1)).astype(int)

    obs_strs: List[List[str]] = [[] for _ in range(n_tracks)]
    for i in range(len(x)):
        obs_strs[track_id[i]].append(
            f"{img_idx[i]} {feature_idx[i]} {bx[i]:.4f} {by[i]:.4f}"
        )

    with open(bundler_path, "w") as f:
        f.write("# Bundle file v0.3\n")
        f.write(f"{len(names)} {n_tracks}\n")
        for cam in camera_data:
            f.write(f'{cam["focal_length"]} {cam["k1"]} {cam["k2"]}\n')
            R = cam["rotation_matrix"]
            f.write(" ".join(map(str, R[0:3])) + "\n")
            f.write(" ".join(map(str, R[3:6])) + "\n")
            f.write(" ".join(map(str, R[6:9])) + "\n")
            f.write(" ".join(map(str, cam["translation_vector"])) + "\n")
        for t in range(n_tracks):
            c = avg_color[t]
            f.write(f"0.0 0.0 0.0\n{c} {c} {c}\n")
            f.write(f"{int(cnt[t])} " + " ".join(obs_strs[t]) + "\n")
    logger.info(
        f"Bundler export: {len(names)} images, {n_tracks} tracks "
        f"-> {bundler_path}"
    )
    return bundler_path
