"""The one general generator of image projects, driven by a traffic file.

A traffic file (``portbench/traffic/<name>.json``) names its ``kind`` and
its parameters; ``make_project`` writes one project from ``(seed,
index)`` and returns, for the views whose content is a pure shift of a
common frame, that shift (``offsets``): the ground truth that
verification is judged by.

- ``views``: ``views`` views of one textured plane, PNG, ``size`` (w, h):
  random homographies (small rotation, scale, shear and shift), except
  that the views ``planted`` names (index from the end -> (dx, dy) in
  whole SuperPoint cells) are view 0 shifted. Copied from
  ``chip_smoke.py::_synthetic_project``, with the seed a pair.
- ``frames``: ``views`` crops of ``size`` from one larger texture, each the
  previous shifted by whole 8-pixel cells (at most ``step_cells`` cells
  along each axis) along a seeded walk: the frames of a camera drifting
  over a plane, as ``scripts/frames_from_video.py`` cuts a video.

The same seed gives the same files. Every seed gives the same sizes and
counts, so the work per job is the same from seed to seed.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parents[1] / "traffic"


def load(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def _texture(rng, big_w: int, big_h: int, blobs_per_4mp: int = 300) -> np.ndarray:
    """Blurred noise with blobs and strokes: corners at several scales,
    about as many per pixel as ``chip_smoke.py``'s 2048 x 2048 texture."""
    import cv2

    tex = rng.integers(0, 256, (big_h, big_w), dtype=np.uint8)
    tex = cv2.GaussianBlur(tex, (0, 0), 4)
    big = max(big_w, big_h)
    for _ in range(max(blobs_per_4mp, blobs_per_4mp * big * big // (2048 * 2048))):
        c = tuple(int(v) for v in rng.integers(0, big, 2))
        col = int(rng.integers(0, 256))
        if rng.random() < 0.5:
            cv2.circle(tex, c, int(rng.integers(4, 40)), col, -1)
        else:
            d = tuple(int(v) for v in rng.integers(0, big, 2))
            cv2.line(tex, c, d, col, int(rng.integers(1, 6)))
    return cv2.normalize(tex, None, 0, 255, cv2.NORM_MINMAX)


def _views(img_dir: Path, rng, n: int, w: int, h: int, planted: Dict[int, Tuple[int, int]]):
    import cv2

    big_w, big_h = 2 * w, 2 * h
    tex = _texture(rng, big_w, big_h)
    center = np.array([big_w / 2, big_h / 2])
    spread = 200 * max(w, h) / 1024
    png = [cv2.IMWRITE_PNG_COMPRESSION, 1]
    offsets: Dict[str, Tuple[int, int]] = {}
    H0 = None
    for i in range(n):
        name = f"view_{i:02d}.png"
        if i - n in planted and H0 is not None:
            shift = np.eye(3)
            shift[:2, 2] = planted[i - n]
            view = cv2.warpPerspective(tex, H0 @ shift, (w, h),
                                       flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
            cv2.imwrite(str(img_dir / name), view, png)
            offsets[name] = tuple(int(v) for v in planted[i - n])
            continue
        ang = rng.uniform(-0.2, 0.2)
        s = rng.uniform(0.8, 1.2)
        R = s * np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
        R = R + rng.normal(0, 0.03, (2, 2))
        t = center - R @ np.array([w / 2, h / 2]) + rng.uniform(-spread, spread, 2)
        H = np.eye(3)
        H[:2, :2], H[:2, 2] = R, t
        H[2, :2] = rng.normal(0, 5e-5 * 1024 / max(w, h), 2)
        if i == 0:
            H[2, :2] = 0.0  # affine, so a shifted copy is an exact pixel shift
            H0 = H
            offsets[name] = (0, 0)
        view = cv2.warpPerspective(tex, H, (w, h), flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
        cv2.imwrite(str(img_dir / name), view, png)
    return offsets


def _frames(img_dir: Path, rng, n: int, w: int, h: int, step_cells: int):
    import cv2

    steps = rng.integers(-step_cells, step_cells + 1, (n - 1, 2)) * 8
    path = np.concatenate([np.zeros((1, 2), np.int64), np.cumsum(steps, 0)])
    path -= path.min(0)
    span = path.max(0)
    tex = _texture(rng, int(w + span[0]), int(h + span[1]))
    png = [cv2.IMWRITE_PNG_COMPRESSION, 1]
    offsets = {}
    for i, (x, y) in enumerate(path):
        name = f"frame_{i:03d}.png"
        cv2.imwrite(str(img_dir / name), tex[y:y + h, x:x + w], png)
        offsets[name] = (int(x), int(y))
    return offsets


def make_project(root: Path, traffic: dict, seed: int, index: int) -> dict:
    """Write project ``index`` of ``seed`` under ``root`` (``root/images``);
    returns {"dir", "images" (sorted names), "offsets" (name -> (dx, dy))}."""
    rng = np.random.default_rng([int(seed) % 2**63, int(index)])
    img_dir = Path(root) / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    w, h = traffic["size"]
    if traffic["kind"] == "views":
        planted = {int(k): tuple(v) for k, v in traffic.get("planted", {}).items()}
        offsets = _views(img_dir, rng, traffic["views"], w, h, planted)
    elif traffic["kind"] == "frames":
        offsets = _frames(img_dir, rng, traffic["views"], w, h, traffic["step_cells"])
    else:
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
    return {"dir": Path(root), "images": sorted(p.name for p in img_dir.iterdir()),
            "offsets": offsets}


def expected_pairs(images: List[str], traffic: dict) -> List[Tuple[str, str]]:
    """The pairs the traffic's strategy asks for, by its definition:
    ``bruteforce`` every unordered pair, ``sequential`` each image with
    the next ``overlap``."""
    images = sorted(images)
    if traffic["strategy"] == "bruteforce":
        return [(a, b) for i, a in enumerate(images) for b in images[i + 1:]]
    if traffic["strategy"] == "sequential":
        k = int(traffic["overlap"])
        return [(images[i], images[j]) for i in range(len(images))
                for j in range(i + 1, min(i + k + 1, len(images)))]
    raise ValueError(f"unknown strategy {traffic['strategy']!r}")


def true_shift(offsets: dict, a: str, b: str) -> Optional[np.ndarray]:
    """Where both views are pure shifts of one frame: t with x_b = x_a + t."""
    if a in offsets and b in offsets:
        return np.asarray(offsets[a], np.float64) - np.asarray(offsets[b], np.float64)
    return None
