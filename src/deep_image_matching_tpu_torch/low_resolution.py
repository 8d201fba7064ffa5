"""Low-resolution matching probe for pair selection (port of
``deep_image_matching_tpu/low_resolution.py``).

SuperPoint at max-1000 px on every image, LightGlue on every brute-force
pair in padded pair batches, and the pairs with more than ``min_matches``
raw matches are kept. Where SuperPoint/LightGlue weights are missing but an
ALIKED checkpoint exists, the probe runs ALIKED instead and counts mutual
nearest neighbours with the ratio test (``_nn_count_pairs``, kernel 5 on the
GPU), as the JAX package does; without either, random-init
SuperPoint+LightGlue where the weights policy allows it.
"""

from __future__ import annotations

import functools
import itertools
import logging
from typing import List, Tuple

import numpy as np
import torch

from .utils.device import resolve_device
from .utils.image import ImageList

logger = logging.getLogger("dim_tpu_torch")


def _nn_count_pairs(feats: list, pairs: List[Tuple[int, int]], batch_size: int = 64,
                    device: torch.device = torch.device("cpu")) -> List[int]:
    """Mutual-nearest-neighbour raw-match counts (mode smnn, ratio 0.95) of
    padded descriptor batches: every image's descriptors upload once, and each
    pair chunk gathers from that table on the device."""
    from .ops.nn_match import nn_match_auto

    cap = max(max(len(f["keypoints"]) for f in feats), 8)
    cap = -(-cap // 64) * 64
    dim = feats[0]["descriptors"].shape[-1]
    desc = np.zeros((len(feats), cap, dim), np.float32)
    mask = np.zeros((len(feats), cap), bool)
    for i, f in enumerate(feats):
        n = len(f["keypoints"])
        desc[i, :n] = f["descriptors"]
        mask[i, :n] = True
    desc, mask = torch.from_numpy(desc).to(device), torch.from_numpy(mask).to(device)
    counts: List[int] = []
    for start in range(0, len(pairs), batch_size):
        chunk = pairs[start:start + batch_size]
        i0 = torch.tensor([i for i, _ in chunk], device=device)
        i1 = torch.tensor([j for _, j in chunk], device=device)
        _, valid = nn_match_auto(desc[i0], desc[i1], mask[i0], mask[i1],
                                 mode="smnn", ratio_th=0.95)
        counts.extend(int(c) for c in valid.sum(1).cpu())
    return counts


def _probe_backend(max_keypoints: int, resize_max: int, device):
    """SuperPoint+LightGlue with real weights when both checkpoints exist;
    else the ALIKED probe with mutual-nearest-neighbour counting where its
    weights exist; else, only when random weights are allowed, random-init
    SuperPoint+LightGlue."""
    from .models.lightglue import LightGlueRunner
    from .models.lightglue import load_default_model as lg_model
    from .models.superpoint import SuperPointRunner
    from .models.superpoint import load_default_model as sp_model
    from .utils import weights as W

    with W.strict():
        try:
            sp = SuperPointRunner(model=sp_model(), max_keypoints=max_keypoints,
                                  resize_max=resize_max, device=device)
            lg = LightGlueRunner(model=lg_model("superpoint"), features="superpoint",
                                 device=device)
            return sp, lg.count_matches_pairs
        except W.MissingWeightsError:
            pass
        try:
            from .upright import _AlikedProbe

            probe = _AlikedProbe(max_keypoints=max_keypoints, resize_max=resize_max,
                                 device=device)
            logger.info("Low-res probe: no SuperPoint/LightGlue checkpoints; using the "
                        "ALIKED weights + mutual-NN counting.")
            return probe, functools.partial(_nn_count_pairs, device=device)
        except FileNotFoundError:
            pass
    logger.warning(
        "Low-res probe: no SuperPoint/ALIKED checkpoints found; falling "
        "back to random-init SuperPoint+LightGlue (policy-gated)."
    )
    sp = SuperPointRunner(max_keypoints=max_keypoints, resize_max=resize_max, device=device)
    return sp, LightGlueRunner(features="superpoint", device=device).count_matches_pairs


def lowres_pair_probe(
    image_list: ImageList,
    resize_max: int = 1000,
    min_matches: int = 20,
    max_keypoints: int = 1024,
    config=None,
) -> List[Tuple[str, str]]:
    device = "auto"
    if config is not None:
        g = getattr(config, "general", None) or {}
        resize_max = g.get("lowres_probe_size", resize_max)
        min_matches = g.get("lowres_min_matches", min_matches)
        max_keypoints = g.get("lowres_max_keypoints", max_keypoints)
        device = g.get("tpu", {}).get("device", "auto")
    names = image_list.img_names
    brute = list(itertools.combinations(range(len(names)), 2))

    sp, count_pairs = _probe_backend(max_keypoints, resize_max, resolve_device(device))
    feats = sp.extract_images([im.path for im in image_list])
    counts = count_pairs(feats, brute)

    pairs = [(names[i], names[j]) for (i, j), c in zip(brute, counts) if c > min_matches]
    logger.info(f"Low-res probe kept {len(pairs)}/{len(brute)} pairs (>{min_matches} matches)")
    if not pairs:
        logger.warning("Low-res probe found no pairs; falling back to bruteforce")
        pairs = [(names[i], names[j]) for i, j in brute]
    return pairs
