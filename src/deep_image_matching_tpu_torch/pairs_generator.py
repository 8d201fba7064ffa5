"""Image-pair generation strategies (port of
``deep_image_matching_tpu/pairs_generator.py``).

Strategies ``bruteforce`` (all combinations), ``sequential`` (sliding
window), ``matching_lowres`` (low-res SuperPoint+LightGlue probe over all
brute-force pairs, keep pairs with > min_matches), ``retrieval``
(global-descriptor top-k on ``general.tpu.device``), ``covisibility`` (top-k
co-observed from an existing COLMAP model) and ``custom_pairs`` (file).
Writes ``pairs.txt`` ("name0 name1" per line).
"""

from __future__ import annotations

import itertools
import logging
from pathlib import Path
from typing import List, Optional, Tuple

from .utils.image import ImageList

logger = logging.getLogger("dim_tpu_torch")

Pair = Tuple[str, str]


def pairs_from_bruteforce(img_names: List[str]) -> List[Pair]:
    return list(itertools.combinations(img_names, 2))


def pairs_from_sequential(img_names: List[str], overlap: int) -> List[Pair]:
    pairs = []
    n = len(img_names)
    for i in range(n):
        for j in range(i + 1, min(i + overlap + 1, n)):
            pairs.append((img_names[i], img_names[j]))
    return pairs


def pairs_from_file(pair_file) -> List[Pair]:
    pairs = []
    with open(pair_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                pairs.append((parts[0], parts[1]))
    return pairs


def pairs_from_lowres(
    image_list: ImageList,
    resize_max: int = 1000,
    min_matches: int = 20,
    config=None,
) -> List[Pair]:
    """Probe all brute-force pairs with a low-res SuperPoint+LightGlue pass
    and keep pairs with more than ``min_matches`` raw matches (see
    ``low_resolution.py``)."""
    from .low_resolution import lowres_pair_probe

    return lowres_pair_probe(
        image_list, resize_max=resize_max, min_matches=min_matches, config=config
    )


def pairs_from_retrieval(
    image_list: ImageList,
    retrieval: str,
    image_dir,
    num_matched: int = 10,
    device=None,
) -> List[Pair]:
    from .image_retrieval import retrieval_pairs

    return retrieval_pairs(image_list, retrieval, num_matched=num_matched, device=device)


def pairs_from_covisibility(db_path, img_names: List[str], top_k: int = 10) -> List[Pair]:
    """Top-k co-observed pairs from an existing COLMAP model/database
    (reference ``pairs_generator.py:238-288``)."""
    from .io.colmap_read_write_model import read_model
    import numpy as np

    cameras, images, points3d = read_model(db_path)
    name_by_id = {im.id: im.name for im in images.values()}
    ids = sorted(images.keys())
    idx_of = {iid: k for k, iid in enumerate(ids)}
    co = np.zeros((len(ids), len(ids)), dtype=np.int64)
    for pt in points3d.values():
        obs = sorted(set(int(i) for i in pt.image_ids))
        for a, b in itertools.combinations(obs, 2):
            if a in idx_of and b in idx_of:
                co[idx_of[a], idx_of[b]] += 1
                co[idx_of[b], idx_of[a]] += 1
    wanted = set(img_names)
    pairs = set()
    for k, iid in enumerate(ids):
        name0 = name_by_id[iid]
        if name0 not in wanted:
            continue
        order = np.argsort(-co[k])
        taken = 0
        for j in order:
            if j == k or co[k, j] <= 0:
                continue
            name1 = name_by_id[ids[j]]
            if name1 not in wanted:
                continue
            pairs.add(tuple(sorted((name0, name1))))
            taken += 1
            if taken >= top_k:
                break
    return sorted(pairs)


class PairsGenerator:
    """Strategy dispatcher + pairs.txt writer (reference
    ``pairs_generator.py:291-368``)."""

    def __init__(
        self,
        image_list: ImageList,
        matching_strategy: str,
        output_dir,
        overlap: Optional[int] = None,
        pair_file=None,
        retrieval: Optional[str] = None,
        db_path=None,
        config=None,
    ):
        self.image_list = image_list
        self.strategy = matching_strategy
        self.output_dir = Path(output_dir)
        self.overlap = overlap
        self.pair_file = pair_file
        self.retrieval = retrieval
        self.db_path = db_path
        self.config = config

    def run(self) -> List[Pair]:
        names = self.image_list.img_names
        if self.strategy == "bruteforce":
            pairs = pairs_from_bruteforce(names)
        elif self.strategy == "sequential":
            if self.overlap is None:
                raise ValueError("sequential strategy needs overlap")
            pairs = pairs_from_sequential(names, self.overlap)
        elif self.strategy == "custom_pairs":
            pairs = pairs_from_file(self.pair_file)
            known = set(names)
            pairs = [p for p in pairs if p[0] in known and p[1] in known]
        elif self.strategy == "matching_lowres":
            pairs = pairs_from_lowres(self.image_list, config=self.config)
        elif self.strategy == "retrieval":
            general = getattr(self.config, "general", None) or {}
            pairs = pairs_from_retrieval(
                self.image_list, self.retrieval, self.image_list[0].path.parent,
                device=general.get("tpu", {}).get("device", "auto"),
            )
        elif self.strategy == "covisibility":
            pairs = pairs_from_covisibility(self.db_path, names)
        else:
            raise ValueError(f"Unknown matching strategy '{self.strategy}'")
        logger.info(f"Generated {len(pairs)} pairs with strategy '{self.strategy}'")
        self.save(pairs)
        return pairs

    def save(self, pairs: List[Pair]) -> Path:
        out = self.output_dir / "pairs.txt"
        with open(out, "w") as f:
            for a, b in pairs:
                f.write(f"{a} {b}\n")
        return out
