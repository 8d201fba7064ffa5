"""Low-resolution matching probe for pair selection (port of
``deep_image_matching_tpu/low_resolution.py``).

SuperPoint at max-1000 px on every image, LightGlue on every brute-force
pair in padded pair batches, and the pairs with more than ``min_matches``
raw matches are kept. The JAX package falls back to an ALIKED probe when
ALIKED weights exist but SuperPoint/LightGlue ones do not; that branch is
not ported yet and raises.
"""

from __future__ import annotations

import itertools
import logging
import os
from pathlib import Path
from typing import List, Tuple

from .utils.device import resolve_device
from .utils.image import ImageList

logger = logging.getLogger("dim_tpu_torch")


def _aliked_checkpoint_exists(name: str = "aliked-n16rot") -> bool:
    wdir = os.environ.get("DIM_TPU_WEIGHTS_DIR")
    cands = ([Path(wdir) / f"{name}.pth"] if wdir else []) + [
        Path.home() / f".cache/dim_tpu/{name}.pth"
    ]
    return any(c.exists() for c in cands)


def _probe_backend(max_keypoints: int, resize_max: int, device):
    """SuperPoint+LightGlue with real weights when both checkpoints exist;
    else the ALIKED probe where its weights exist (not ported: raises);
    else, only when random weights are allowed, random-init
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
    if _aliked_checkpoint_exists():
        raise NotImplementedError(
            "The ALIKED low-res probe is not ported to the PyTorch package yet "
            "(ROADMAP.md, queue 1: ALIKED/ALIKE)"
        )
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
