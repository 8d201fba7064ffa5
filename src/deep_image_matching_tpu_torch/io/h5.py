"""HDF5 feature/match stores — the inter-stage contract of the pipeline.

Schema parity with the reference so downstream tools interoperate:
- features.h5: one group per image name with datasets ``keypoints (N,2)``,
  ``descriptors (D,N)``, ``scores (N,)``, ``tile_idx (N,)``,
  ``image_size (2,)`` (reference ``extractors/extractor_base.py:56-99``,
  ``io/h5.py:45-89``).
- matches.h5: group ``name0`` -> dataset ``name1`` = (M,2) int index pairs
  (reference ``matchers/matcher_base.py:281-341``).

The writers here accept the fixed-capacity padded arrays and trim
by the validity count before writing, so the datasets stay those of the
reference (variable-length, no padding). Files go through ``io/hdf5.py``
(no h5py needed), which reads h5py's files, gzip included, and writes
uncompressed.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

from . import hdf5

logger = logging.getLogger("dim_tpu_torch")


def names_to_pair(name0: str, name1: str, separator: str = "/") -> str:
    return separator.join((name0.replace("/", "-"), name1.replace("/", "-")))


def list_h5_names(path) -> List[str]:
    """Names of the groups that hold datasets (the images of features.h5)."""
    names: List[str] = []

    def walk(group, prefix):
        for key, obj in group.items():
            if isinstance(obj, hdf5.Dataset):
                names.append(prefix.strip("/"))
            else:
                walk(obj, f"{prefix}/{key}")

    with hdf5.File(path, "r") as fd:
        walk(fd, "")
    return sorted(set(names))


def write_features(
    fd: "hdf5.Group",
    name: str,
    keypoints: np.ndarray,
    descriptors: Optional[np.ndarray] = None,
    scores: Optional[np.ndarray] = None,
    tile_idx: Optional[np.ndarray] = None,
    image_size: Optional[np.ndarray] = None,
    n_valid: Optional[int] = None,
    as_half: bool = True,
) -> None:
    """Write one image's features into an open file, trimming padded arrays
    to ``n_valid``.

    ``descriptors`` are (N, D) rows of the keypoints (padded with them where
    ``n_valid`` is given), stored as (D, N) to match the reference schema.
    The layout is not guessed from the shape, which is square for an image
    with exactly D keypoints.
    """
    keypoints = np.asarray(keypoints)
    if n_valid is None:
        n_valid = len(keypoints)
    kpts = keypoints[:n_valid].astype(np.float32)
    data: Dict[str, np.ndarray] = {"keypoints": kpts}
    if descriptors is not None:
        desc = np.asarray(descriptors)
        if desc.ndim != 2 or desc.shape[0] != keypoints.shape[0]:
            raise ValueError(f"descriptors {desc.shape}: expected (N, D) rows of the "
                             f"{keypoints.shape[0]} keypoints")
        data["descriptors"] = np.ascontiguousarray(desc[:n_valid].T)
    if scores is not None:
        data["scores"] = np.asarray(scores)[:n_valid].astype(np.float32)
    if tile_idx is not None:
        data["tile_idx"] = np.asarray(tile_idx)[:n_valid].astype(np.float32)
    if image_size is not None:
        data["image_size"] = np.asarray(image_size).astype(np.int64)
    if as_half:
        for k in ("descriptors", "scores"):
            if k in data and data[k].dtype == np.float32:
                data[k] = data[k].astype(np.float16)
    if name in fd:
        del fd[name]
    grp = fd.create_group(name)
    for k, v in data.items():
        grp.create_dataset(k, data=v)


def save_features(path, name: str, **arrays) -> None:
    """``write_features`` into the file at ``path`` (created if missing)."""
    with hdf5.File(path, "a") as fd:
        write_features(fd, name, **arrays)


def get_features(path, name: str) -> Dict[str, np.ndarray]:
    with hdf5.File(path, "r") as fd:
        if name not in fd:
            raise ValueError(f"Image '{name}' not found in {path}")
        grp = fd[name]
        if "keypoints" not in grp:
            raise KeyError(f"No keypoints for '{name}' in {path}")
        out = {"keypoints": np.asarray(grp["keypoints"], dtype=np.float32)}
        if "descriptors" in grp:
            out["descriptors"] = np.asarray(grp["descriptors"], dtype=np.float32)
        for k in ("scores", "tile_idx"):
            if k in grp:
                out[k] = np.asarray(grp[k], dtype=np.float32)
        if "image_size" in grp:
            out["image_size"] = np.asarray(grp["image_size"], dtype=np.int32)
    return out


def get_keypoints(path, name: str) -> np.ndarray:
    with hdf5.File(path, "r") as fd:
        return np.asarray(fd[name]["keypoints"], dtype=np.float32)


def save_matches(path, name0: str, name1: str, matches: np.ndarray) -> None:
    """Write the (M,2) match index array for a pair."""
    matches = np.asarray(matches, dtype=np.int32).reshape(-1, 2)
    with hdf5.File(path, "a") as fd:
        grp = fd.require_group(name0)
        if name1 in grp:
            del grp[name1]
        grp.create_dataset(name1, data=matches)


def get_matches(path, name0: str, name1: str) -> np.ndarray:
    with hdf5.File(path, "r") as fd:
        if name0 in fd and name1 in fd[name0]:
            return np.asarray(fd[name0][name1], dtype=np.int64)
        if name1 in fd and name0 in fd[name1]:
            return np.asarray(fd[name1][name0], dtype=np.int64)[:, ::-1]
    raise ValueError(f"Pair ({name0}, {name1}) not found in {path}")


def list_pairs(path) -> List:
    pairs = []
    with hdf5.File(path, "r") as fd:
        for name0 in fd:
            for name1 in fd[name0]:
                pairs.append((name0, name1))
    return pairs
