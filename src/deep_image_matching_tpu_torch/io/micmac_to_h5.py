"""Import MicMac Homol tie points back into features.h5 / matches.h5 (port of
``deep_image_matching_tpu/io/micmac_to_h5.py``), the inverse of
``h5_to_micmac.export_tie_points``: each ``Homol/Pastis{img0}/{img1}.txt``
holds "x0 y0 x1 y1 w" lines; the keypoints of each image are deduplicated on
their coordinates rounded to 1e-3 px across pairs, and the files are written
through ``io/hdf5.py``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from . import hdf5

logger = logging.getLogger("dim_tpu_torch")


def read_homol_matches(file: Path) -> Tuple[np.ndarray, np.ndarray]:
    """One Homol tie-point file -> (N, 2) coords in image0, (N, 2) in
    image1 (the trailing weight column is ignored)."""
    pts0: List[List[float]] = []
    pts1: List[List[float]] = []
    with open(file) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            x0, y0, x1, y1 = (float(v) for v in parts[:4])
            pts0.append([x0, y0])
            pts1.append([x1, y1])
    return (
        np.asarray(pts0, np.float32).reshape(-1, 2),
        np.asarray(pts1, np.float32).reshape(-1, 2),
    )


def micmac_to_h5(
    homol_dir: Path, feature_path: Path, match_path: Path
) -> Tuple[Path, Path]:
    """Rebuild features.h5 + matches.h5 from a Homol directory tree.

    Keypoints are deduplicated per image on exact (rounded to 1e-3 px)
    coordinates so the same tie point observed in several pairs becomes one
    keypoint row, which keeps track building consistent.
    """
    homol_dir = Path(homol_dir)
    if not homol_dir.exists():
        raise FileNotFoundError(f"Homol directory {homol_dir} does not exist")

    pair_pts: Dict[Tuple[str, str], Tuple[np.ndarray, np.ndarray]] = {}
    for sub in sorted(homol_dir.glob("Pastis*")):
        if not sub.is_dir():
            continue
        name0 = sub.name[len("Pastis"):]
        for f in sorted(sub.glob("*.txt")):
            name1 = f.stem  # strips only the trailing .txt (img.jpg.txt -> img.jpg)
            if (name1, name0) in pair_pts:
                continue  # symmetric duplicate
            p0, p1 = read_homol_matches(f)
            if len(p0):
                pair_pts[(name0, name1)] = (p0, p1)

    # unique keypoints per image
    kpt_index: Dict[str, Dict[Tuple[int, int], int]] = {}
    kpts: Dict[str, List[Tuple[float, float]]] = {}

    def kid(name: str, xy) -> int:
        key = (round(float(xy[0]) * 1000), round(float(xy[1]) * 1000))
        table = kpt_index.setdefault(name, {})
        if key not in table:
            table[key] = len(table)
            kpts.setdefault(name, []).append((float(xy[0]), float(xy[1])))
        return table[key]

    matches: Dict[Tuple[str, str], np.ndarray] = {}
    for (n0, n1), (p0, p1) in pair_pts.items():
        idx = np.array(
            [[kid(n0, a), kid(n1, b)] for a, b in zip(p0, p1)], np.int64
        ).reshape(-1, 2)
        # one match per keypoint (first observation wins)
        _, keep = np.unique(idx[:, 0], return_index=True)
        idx = idx[np.sort(keep)]
        _, keep = np.unique(idx[:, 1], return_index=True)
        matches[(n0, n1)] = idx[np.sort(keep)]

    feature_path = Path(feature_path)
    match_path = Path(match_path)
    feature_path.parent.mkdir(parents=True, exist_ok=True)
    with hdf5.File(feature_path, "w") as fd:
        for name, pts in kpts.items():
            arr = np.asarray(pts, np.float32).reshape(-1, 2)
            g = fd.create_group(name)
            g.create_dataset("keypoints", data=arr)
            g.create_dataset("scores", data=np.ones((len(arr),), np.float32))
            size = np.ceil(arr.max(axis=0) + 1).astype(np.int64) if len(arr) else np.zeros(2, np.int64)
            g.create_dataset("image_size", data=size)
    with hdf5.File(match_path, "w") as fd:
        for (n0, n1), idx in matches.items():
            fd.require_group(n0).create_dataset(n1, data=idx)
    logger.info(
        f"Imported {sum(len(v) for v in matches.values())} tie points over "
        f"{len(matches)} pairs from {homol_dir}"
    )
    return feature_path, match_path
