"""Merge per-pair dense matches into multiview-consistent keypoints (port of
``deep_image_matching_tpu/utils/dense_to_multiview.py``).

Detector-free matchers emit fresh keypoints per pair. For multiview SfM the
keypoints of each image are concatenated, rounded and deduplicated, the
matches are remapped onto the merged set, one match per keypoint is kept,
and new keypoint and match files plus the COLMAP database are written. The
files go through ``io/hdf5.py`` (no h5py).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from ..io import hdf5

logger = logging.getLogger("dim_tpu_torch")


def dense_to_multiview(
    feature_path: Path,
    match_path: Path,
    database_path: Path,
    img_dir: Path,
    camera_config_path=None,
    round_decimals: int = 0,
) -> Tuple[Path, Path]:
    """Writes ``multiview/features_multiview.h5`` and
    ``multiview/matches_multiview.h5`` beside ``feature_path`` and
    re-exports the COLMAP database from them. Returns their paths, or the
    inputs when no pair was verified."""
    feature_path = Path(feature_path)
    match_path = Path(match_path)
    if not match_path.exists():
        logger.warning(f"{match_path} does not exist (no verified pairs); "
                       "skipping multiview merge.")
        return feature_path, match_path
    # a directory of its own: the COLMAP export must not pick up
    # raw_matches.h5, whose indices do not apply to the merged keypoints
    out_dir = feature_path.parent / "multiview"
    out_dir.mkdir(parents=True, exist_ok=True)
    mv_features = out_dir / "features_multiview.h5"
    mv_matches = out_dir / "matches_multiview.h5"
    for p in (mv_features, mv_matches):
        if p.exists():
            p.unlink()

    pair_data = []
    per_image_kpts: Dict[str, list] = {}
    with hdf5.File(feature_path, "r") as feats, hdf5.File(match_path, "r") as matches:
        image_sizes = {name: np.asarray(feats[name]["image_size"])
                       for name in feats if "image_size" in feats[name]}
        for name0 in matches:
            for name1 in matches[name0]:
                m = np.asarray(matches[name0][name1])
                k0 = np.asarray(feats[name0]["keypoints"])[m[:, 0]]
                k1 = np.asarray(feats[name1]["keypoints"])[m[:, 1]]
                pair_data.append((name0, name1, k0, k1))
                per_image_kpts.setdefault(name0, []).append(k0)
                per_image_kpts.setdefault(name1, []).append(k1)

    # round and deduplicate per image, in order of first appearance
    merged: Dict[str, np.ndarray] = {}
    index_of: Dict[str, Dict[Tuple, int]] = {}
    for name, chunks in per_image_kpts.items():
        rounded = np.round(np.concatenate(chunks, axis=0), round_decimals)
        uniq, first = np.unique(rounded, axis=0, return_index=True)
        uniq = uniq[np.argsort(first)]
        merged[name] = uniq.astype(np.float32)
        index_of[name] = {tuple(row): i for i, row in enumerate(uniq)}

    with hdf5.File(mv_features, "w") as fd:
        for name, kpts in merged.items():
            grp = fd.create_group(name)
            grp.create_dataset("keypoints", data=kpts)
            if name in image_sizes:
                grp.create_dataset("image_size", data=image_sizes[name])

    # remap the matches onto the merged indices, one match per keypoint on
    # both sides (the first one kept)
    n_pairs = 0
    with hdf5.File(mv_matches, "w") as fd:
        for name0, name1, k0, k1 in pair_data:
            i0 = np.array([index_of[name0][tuple(r)] for r in np.round(k0, round_decimals)],
                          np.int64)
            i1 = np.array([index_of[name1][tuple(r)] for r in np.round(k1, round_decimals)],
                          np.int64)
            _, keep0 = np.unique(i0, return_index=True)
            mask = np.zeros(len(i0), bool)
            mask[keep0] = True
            _, keep1 = np.unique(i1[mask], return_index=True)
            sel = np.nonzero(mask)[0][keep1]
            mm = np.stack([i0[sel], i1[sel]], axis=1)
            if len(mm) == 0:
                continue
            fd.require_group(name0).create_dataset(name1, data=mm.astype(np.int32))
            n_pairs += 1

    logger.info(f"Multiview merge: {len(merged)} images, {n_pairs} pairs "
                f"-> {mv_features.name}, {mv_matches.name}")

    from ..io.h5_to_db import export_to_colmap

    export_to_colmap(
        img_dir=img_dir,
        feature_path=mv_features,
        match_path=mv_matches,
        database_path=database_path,
        camera_config_path=camera_config_path,
    )
    return mv_features, mv_matches
