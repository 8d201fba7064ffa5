"""Whether what the timed jobs wrote is correct, judged against the plain
reference (``portbench/reference/<model>.py``, the models that the
configuration's ``reference`` names) and the traffic's ground truth.

One job of the window is drawn from the seed, and in it images and pairs.
Every number is "lower is better" and is held to its limit in
``portbench/limits/<cell>.json``:

- extraction, per drawn image (the worst image counts): ``kpt_miss``, the
  share of the reference extractor's keypoints that features.h5 lacks
  (positions are whole pixels, compared exactly); ``desc_gap``, the
  largest L2 distance between the two descriptors of a keypoint both
  have; ``score_gap``, the largest difference of their detection scores
  over the image's best score;
- matching, per drawn pair (the worst pair counts): the reference matcher
  runs on the pair's features as features.h5 holds them (the matcher's
  own input), so it follows the program from its extraction, which the
  numbers above judge by themselves. ``match_gap``: over the raw matches
  written, the widest gap (nats) by which the reference's log assignment
  of the match lies below the best of its row or of its column;
  ``match_shortfall``: how far the matches written over all drawn pairs
  fall short of the reference's number, as a share of it (which matches
  are mutual flips on near-ties, their number does not);
  ``prune_flip``: the share of written matches on points that the
  reference's adaptive width pruned;
- pairs: ``pairs_missing``, pairs of the traffic's strategy absent from
  raw_matches.h5 or written there without a match (at a threshold of 0
  every pair has one: the largest entry of an assignment is a mutual
  argmax), and pairs written but not asked for;
- verification, over every pair of the job: ``gate_breaks``, verified
  pairs whose matches are not raw matches of the pair, or are fewer than
  ``min_inliers`` or than ``min_ratio`` of the raw matches;
  ``planted_lost``, pairs of two shifted views (known translation t) with
  no verified matches; ``planted_miss``, per such pair, the share of its
  true raw matches (x1 within ``truth_px`` of x0 + t) not verified;
  ``planted_false``, the share of its verified matches that are not true;
- database: ``db_breaks``, keypoints, raw matches and verified matches in
  database.db that differ from the h5 files, or pairs one has and the
  other lacks.
"""

from __future__ import annotations

import sqlite3
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from harness import h5read, plugins
from harness.traffic import expected_pairs, true_shift
from reference.lowp import PRECISIONS, no_tf32

MAX_IMAGE_ID = 2**31 - 1


# ---------------------------------------------------------------- files

def read_features(path: Path, names=None) -> Dict[str, dict]:
    out = {}
    with h5read.File(path, "r") as fd:
        for name in (names if names is not None else list(fd)):
            g = fd[name]
            out[name] = {
                "keypoints": np.asarray(g["keypoints"], dtype=np.float32),
                "scores": np.asarray(g["scores"], dtype=np.float32),
                "descriptors": np.asarray(g["descriptors"], dtype=np.float32).T,
            }
    return out


def read_matches(path: Path) -> Dict[Tuple[str, str], np.ndarray]:
    out = {}
    if not Path(path).exists():
        return out
    with h5read.File(path, "r") as fd:
        for a in fd:
            for b in fd[a]:
                out[(a, b)] = np.asarray(fd[a][b], dtype=np.int64).reshape(-1, 2)
    return out


def lookup(matches: dict, a: str, b: str) -> Optional[np.ndarray]:
    """The (M, 2) matches of (a, b) in either orientation, as a -> b."""
    if (a, b) in matches:
        return matches[(a, b)]
    if (b, a) in matches:
        return matches[(b, a)][:, ::-1]
    return None


def _blob(data, dtype, rows, cols):
    return np.frombuffer(data, dtype=dtype).reshape(rows, cols)


def db_breaks(db_path: Path, feats: Dict[str, dict], raw: dict, verified: dict) -> int:
    """Entries of database.db that differ from the h5 files (see the
    module's docstring)."""
    con = sqlite3.connect(str(db_path))
    try:
        ids = dict(con.execute("SELECT name, image_id FROM images"))
        kp = {i: _blob(d, np.float32, r, c)
              for i, r, c, d in con.execute("SELECT image_id, rows, cols, data FROM keypoints")}
        tables = {}
        for table in ("matches", "two_view_geometries"):
            tables[table] = {p: _blob(d, np.uint32, r, c).astype(np.int64) for p, r, c, d in
                             con.execute(f"SELECT pair_id, rows, cols, data FROM {table}")
                             if r > 0}
    finally:
        con.close()
    breaks = len(set(ids) ^ set(feats))
    for name, f in feats.items():
        got = kp.get(ids.get(name))
        if got is None or got.shape != f["keypoints"].shape or not np.array_equal(got, f["keypoints"]):
            breaks += 1
    for table, h5 in (("matches", raw), ("two_view_geometries", verified)):
        seen = set()
        for (a, b), m in h5.items():
            if a not in ids or b not in ids:
                breaks += 1
                continue
            i, j = ids[a], ids[b]
            if i > j:
                i, j, m = j, i, m[:, ::-1]
            pid = i * MAX_IMAGE_ID + j
            seen.add(pid)
            got = tables[table].get(pid)
            if len(m) == 0:
                continue
            if got is None or got.shape != m.shape or not np.array_equal(got, m):
                breaks += 1
        breaks += len(set(tables[table]) - seen)
    return breaks


# ------------------------------------------------------------ reference

def image_size(path: Path) -> tuple:
    """(width, height) of an image file."""
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise OSError(f"cannot read {path}")
    return img.shape[1], img.shape[0]


def reference_features(model: str, sd, path: Path, conf: dict, device, rnd) -> dict:
    """The reference extractor ``model`` on one image file (f32 or, as the
    control, ``rnd``); numpy outputs."""
    with no_tf32():
        f = plugins.reference(model).extract_image(sd, path, conf, device, rnd)
    return {k: v.cpu().numpy() for k, v in f.items()}


def as_stored(f: dict) -> dict:
    """Features as features.h5 stores them: descriptors and scores in float16."""
    return {"keypoints": f["keypoints"].astype(np.float32),
            "scores": f["scores"].astype(np.float16).astype(np.float32),
            "descriptors": f["descriptors"].astype(np.float16).astype(np.float32)}


def reference_match(model: str, conf: dict, sd, f0: dict, f1: dict, size0, size1, device,
                    rnd) -> dict:
    """The reference matcher ``model`` with the configuration's matcher
    options ``conf`` on one pair of features (f32 or, as the control,
    ``rnd``); numpy outputs."""
    t0, t1 = ({k: torch.as_tensor(v, device=device) for k, v in f.items()} for f in (f0, f1))
    sz0 = torch.tensor(size0, dtype=torch.float32, device=device)
    sz1 = torch.tensor(size1, dtype=torch.float32, device=device)
    with no_tf32():
        out = plugins.reference(model).match_pair(sd, conf, t0, t1, sz0, sz1, rnd)
    return {k: (v.cpu().numpy() if torch.is_tensor(v) else v) for k, v in out.items()}


# -------------------------------------------------------------- numbers

def extraction_numbers(ref: dict, cand: dict) -> dict:
    rk = {(int(x), int(y)): i for i, (x, y) in enumerate(ref["keypoints"])}
    common = [(rk[(int(x), int(y))], j) for j, (x, y) in enumerate(cand["keypoints"])
              if (int(x), int(y)) in rk and x == int(x) and y == int(y)]
    miss = 1.0 - len(common) / max(len(rk), 1)
    if not common:
        return {"kpt_miss": miss, "desc_gap": 2.0, "score_gap": 1.0}
    ri, ci = (np.asarray(v) for v in zip(*common))
    desc_gap = float(np.linalg.norm(ref["descriptors"][ri] - cand["descriptors"][ci], axis=1).max())
    top = float(np.abs(ref["scores"]).max()) or 1.0
    score_gap = float(np.abs(ref["scores"][ri] - cand["scores"][ci]).max() / top)
    return {"kpt_miss": float(miss), "desc_gap": desc_gap, "score_gap": score_gap}


def matching_numbers(ref: dict, cand: np.ndarray) -> dict:
    """``ref``: the reference's ``scores`` (M, N) with -inf on pruned rows
    and columns, its ``matches``; ``cand``: the (K, 2) matches written."""
    S = ref["scores"]
    counts = (len(cand), len(ref["matches"]))
    if len(cand) == 0:
        return {"match_gap": 0.0, "counts": counts, "prune_flip": 0.0}
    i, j = cand[:, 0], cand[:, 1]
    if i.max() >= S.shape[0] or j.max() >= S.shape[1] or i.min() < 0 or j.min() < 0:
        return {"match_gap": float("inf"), "counts": counts, "prune_flip": 1.0}
    s = S[i, j]
    live = np.isfinite(s)
    flip = 1.0 - live.mean()
    if not live.any():
        return {"match_gap": 0.0, "counts": counts, "prune_flip": float(flip)}
    row = S.max(1)[i[live]]
    col = S.max(0)[j[live]]
    gap = np.maximum(row - s[live], col - s[live]).max()
    return {"match_gap": float(gap), "counts": counts, "prune_flip": float(flip)}


def verification_numbers(pairs, raw: dict, verified: dict, feats: dict, offsets: dict,
                         general: dict, truth_px: float) -> dict:
    gate = lost = 0
    miss, false = [0.0], [0.0]
    for a, b in pairs:
        r = lookup(raw, a, b)
        v = lookup(verified, a, b)
        if v is not None and len(v):
            rset = {tuple(x) for x in (r if r is not None else [])}
            if (not {tuple(x) for x in v} <= rset or len(v) < general["min_inliers_per_pair"]
                    or len(v) < general["min_inlier_ratio_per_pair"] * len(rset)):
                gate += 1
        t = true_shift(offsets, a, b)
        if t is None:
            continue
        if v is None or len(v) == 0:
            lost += 1
            continue
        k0, k1 = feats[a]["keypoints"], feats[b]["keypoints"]

        def true_rows(m):
            return np.linalg.norm(k1[m[:, 1]] - (k0[m[:, 0]] + t), axis=1) <= truth_px

        true_raw = {tuple(x) for x in r[true_rows(r)]} if r is not None and len(r) else set()
        vset = {tuple(x) for x in v}
        miss.append(len(true_raw - vset) / max(len(true_raw), 1))
        false.append(1.0 - true_rows(v).mean())
    return {"gate_breaks": gate, "planted_lost": lost, "planted_miss": float(max(miss)),
            "planted_false": float(max(false))}


def _worst(rows: List[dict]) -> dict:
    """The worst of each number over the rows; matching rows' ``counts``
    (written, reference) pool into ``match_shortfall``."""
    out = {}
    for r in rows:
        for k, v in r.items():
            if k != "counts":
                out[k] = max(out.get(k, 0.0), v)
    counts = [r["counts"] for r in rows if "counts" in r]
    if counts:
        written, ref = (sum(c) for c in zip(*counts))
        out["match_shortfall"] = max(0.0, 1.0 - written / max(ref, 1))
    return out


# -------------------------------------------------------------- the job

def draw(rng, job_images: List[str], pairs, offsets, n_images: int, n_pairs: int):
    """The images and pairs a check looks at: ``n_images`` images, and
    ``n_pairs`` pairs of which up to half are pairs of shifted views."""
    def choose(pool, k):
        return [pool[i] for i in sorted(rng.choice(len(pool), size=min(k, len(pool)),
                                                   replace=False))]

    imgs = choose(sorted(job_images), n_images)
    planted = [p for p in pairs if true_shift(offsets, *p) is not None]
    take = choose(planted, n_pairs // 2)
    take += choose([p for p in pairs if p not in take and true_shift(offsets, *p) is None],
                    n_pairs - len(take))
    take += choose([p for p in planted if p not in take], n_pairs - len(take))
    return imgs, take


def on_device(sds: dict, device) -> dict:
    return {m: {k: v.to(device) for k, v in sd.items()} for m, sd in sds.items()}


def check_job(out_dir: Path, project: dict, traffic: dict, config: dict, sds: dict, rng,
              device) -> dict:
    """The numbers of one job's files (see the module's docstring)."""
    sds = on_device(sds, device)
    images = project["images"]
    pairs = expected_pairs(images, traffic)
    imgs, sample = draw(rng, images, pairs, project["offsets"], traffic["check"]["images"],
                        traffic["check"]["pairs"])
    feats = read_features(out_dir / "features.h5")
    raw = read_matches(out_dir / "raw_matches.h5")
    verified = read_matches(out_dir / "matches.h5")
    numbers = {}
    extractor = {**config["extractor"], "max_keypoints": traffic["max_keypoints"]}
    ref_x, ref_m = config["reference"]["extractor"], config["reference"]["matcher"]
    rnd = PRECISIONS["f32"]
    rows = []
    for name in imgs:
        ref = reference_features(ref_x, sds[ref_x], project["dir"] / "images" / name,
                                 extractor, device, rnd)
        if name not in feats:
            rows.append({"kpt_miss": 1.0, "desc_gap": 2.0, "score_gap": 1.0})
            continue
        rows.append(extraction_numbers(ref, feats[name]))
    numbers.update(_worst(rows))
    rows = []
    for a, b in sample:
        m = lookup(raw, a, b)
        if a not in feats or b not in feats or m is None:
            rows.append({"match_gap": float("inf"), "counts": (0, 1), "prune_flip": 1.0})
            continue
        size = [image_size(project["dir"] / "images" / n) for n in (a, b)]
        ref = reference_match(ref_m, config["matcher"], sds[ref_m], feats[a], feats[b],
                              size[0], size[1], device, rnd)
        rows.append(matching_numbers(ref, m))
    numbers.update(_worst(rows))
    want = {frozenset(p) for p in pairs}
    have = {frozenset(p) for p, m in raw.items() if len(m)}
    numbers["pairs_missing"] = len(want ^ have)
    numbers.update(verification_numbers(pairs, raw, verified, feats, project["offsets"],
                                        config["general"], traffic["check"]["truth_px"]))
    numbers["db_breaks"] = db_breaks(out_dir / "database.db", feats, raw, verified)
    return numbers


def control_numbers(project: dict, traffic: dict, config: dict, sds: dict, rng, device,
                    precision: str = "fp8") -> dict:
    """The extraction and matching numbers of the reference computed in
    ``precision`` and put in the program's place, at the job's draw."""
    sds = on_device(sds, device)
    images = project["images"]
    pairs = expected_pairs(images, traffic)
    imgs, sample = draw(rng, images, pairs, project["offsets"], traffic["check"]["images"],
                        traffic["check"]["pairs"])
    extractor = {**config["extractor"], "max_keypoints": traffic["max_keypoints"]}
    ref_x, ref_m = config["reference"]["extractor"], config["reference"]["matcher"]
    low, f32 = PRECISIONS[precision], PRECISIONS["f32"]
    need = sorted(set(imgs) | {n for p in sample for n in p})
    path = {n: project["dir"] / "images" / n for n in need}
    cand = {n: as_stored(reference_features(ref_x, sds[ref_x], path[n], extractor, device, low))
            for n in need}
    rows = [extraction_numbers(reference_features(ref_x, sds[ref_x], path[n], extractor, device,
                                                  f32), cand[n]) for n in imgs]
    numbers = _worst(rows)
    rows = []
    for a, b in sample:
        size = [image_size(path[n]) for n in (a, b)]
        got = reference_match(ref_m, config["matcher"], sds[ref_m], cand[a], cand[b], size[0],
                              size[1], device, low)
        ref = reference_match(ref_m, config["matcher"], sds[ref_m], cand[a], cand[b], size[0],
                              size[1], device, f32)
        rows.append(matching_numbers(ref, got["matches"]))
    numbers.update(_worst(rows))
    return numbers
