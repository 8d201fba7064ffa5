"""Multiview track building from pairwise matches.

Parity: reference ``io/h5_to_bundler.py:517-810`` (``_merge_tracks``, chain
resolution, per-track consistency filtering). Implementation: every
(image, feature) observation is a node; each pairwise match is an edge;
tracks are connected components computed by the native C++ union-find
(``native/unionfind.cpp``). Tracks observing the same image
twice are conflicting and dropped (reference keeps the consistent subset).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Tuple

import numpy as np

from ..native import connected_components
from . import hdf5

logger = logging.getLogger("dim_tpu_torch")


def build_tracks(
    match_path: Path,
    min_track_length: int = 2,
) -> Tuple[List[str], List[List[Tuple[int, int]]]]:
    """Build tracks from matches.h5.

    Returns (image_names, tracks) where each track is a list of
    (image_index, feature_index) observations.
    """
    pairs = []
    with hdf5.File(match_path, "r") as fd:
        for name0 in fd:
            for name1 in fd[name0]:
                pairs.append((name0, name1, np.asarray(fd[name0][name1])))
    names = sorted({n for p in pairs for n in p[:2]})
    name_idx = {n: i for i, n in enumerate(names)}

    # node id = image_idx * stride + feature_idx (stride = max feat id + 1)
    max_feat = 1
    for _, _, m in pairs:
        if len(m):
            max_feat = max(max_feat, int(m.max()) + 1)
    stride = max_feat

    edge_list = []
    for name0, name1, m in pairs:
        if not len(m):
            continue
        i0, i1 = name_idx[name0], name_idx[name1]
        e = np.empty((len(m), 2), np.int64)
        e[:, 0] = i0 * stride + m[:, 0]
        e[:, 1] = i1 * stride + m[:, 1]
        edge_list.append(e)
    if not edge_list:
        return names, []
    edges = np.concatenate(edge_list, axis=0)

    # only nodes that appear in an edge matter; compact them
    nodes, inv = np.unique(edges.reshape(-1), return_inverse=True)
    compact_edges = inv.reshape(-1, 2)
    roots = connected_components(len(nodes), compact_edges)

    # group observations by component
    order = np.argsort(roots, kind="stable")
    sorted_roots = roots[order]
    boundaries = np.nonzero(np.diff(sorted_roots))[0] + 1
    groups = np.split(order, boundaries)

    tracks: List[List[Tuple[int, int]]] = []
    n_conflicting = 0
    for grp in groups:
        obs_nodes = nodes[grp]
        img_idx = obs_nodes // stride
        feat_idx = obs_nodes % stride
        if len(np.unique(img_idx)) < min_track_length:
            continue
        if len(np.unique(img_idx)) != len(img_idx):
            # conflicting track: same image observed twice; keep the first
            # observation per image (reference drops inconsistent chains)
            _, first = np.unique(img_idx, return_index=True)
            img_idx = img_idx[first]
            feat_idx = feat_idx[first]
            n_conflicting += 1
        tracks.append(list(zip(img_idx.tolist(), feat_idx.tolist())))
    logger.info(
        f"Built {len(tracks)} tracks from {len(pairs)} pairs "
        f"({n_conflicting} conflicting tracks trimmed)"
    )
    return names, tracks
