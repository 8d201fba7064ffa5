"""Upright rotation: make every image approximately upright before matching
(port of ``deep_image_matching_tpu/upright.py``).

Each image's rotation in {0, 90, 180, 270} degrees (clockwise) comes from
(a) its EXIF ``Orientation`` tag (``exif``), (b) ``rotations.txt`` in the
image folder (``custom``), or (c) ``2clusters``: a low-resolution probe that
matches all four rotations of each image against the first image in one
batch and keeps the one with the most verified matches. Rotated copies are
written for extraction, and ``rotate_back_features`` moves the keypoints in
features.h5 back into the original frames afterwards.

The probe extracts on ``general.tpu.device`` (SuperPoint, else the ALIKED
probe ``_AlikedProbe``, else random-init SuperPoint where the weights policy
allows it) and matches through ``ops/nn_match.py::nn_match_auto``: kernel 5
(``nn_match_fused``) on the card, the dense ``nn_match_batch`` on the CPU;
the JAX package takes the dense route on every device, and the two compute
the same function. Geometric verification is OpenCV's MAGSAC on the host, as
in the JAX package.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict

import cv2
import numpy as np
import torch

logger = logging.getLogger("dim_tpu_torch")

ROTATIONS = (0, 90, 180, 270)
PROBE_CAPACITY = 512


def rotate_image(img: np.ndarray, deg: int) -> np.ndarray:
    if deg == 0:
        return img
    code = {
        90: cv2.ROTATE_90_CLOCKWISE,
        180: cv2.ROTATE_180,
        270: cv2.ROTATE_90_COUNTERCLOCKWISE,
    }[deg % 360]
    return cv2.rotate(img, code)


def rotate_keypoints_back(kpts: np.ndarray, deg: int, rotated_wh) -> np.ndarray:
    """Map keypoints found on an image rotated by ``deg`` (clockwise) back
    into the original image's coordinates; ``rotated_wh`` is the rotated
    image's (w, h)."""
    w, h = rotated_wh
    x, y = kpts[:, 0], kpts[:, 1]
    if deg % 360 == 0:
        return kpts
    if deg % 360 == 90:  # original -> rotated was 90 CW; invert
        return np.stack([y, (w - 1) - x], axis=1)
    if deg % 360 == 180:
        return np.stack([(w - 1) - x, (h - 1) - y], axis=1)
    if deg % 360 == 270:
        return np.stack([(h - 1) - y, x], axis=1)
    raise ValueError(f"Unsupported rotation {deg}")


def _exif_rotation(img) -> int:
    """EXIF Orientation -> degrees the image must be rotated clockwise to be
    upright (subset: 1, 3, 6, 8)."""
    ori = img.exif.get("Orientation", 1)
    return {1: 0, 3: 180, 6: 90, 8: 270}.get(int(ori) if ori else 1, 0)


def _custom_rotations(image_dir: Path) -> Dict[str, int]:
    path = Path(image_dir) / "rotations.txt"
    if not path.exists():
        raise FileNotFoundError(
            f"upright_strategy 'custom' needs {path} ('name degrees' lines)"
        )
    out = {}
    for line in path.read_text().splitlines():
        parts = line.split()
        if len(parts) >= 2:
            out[parts[0]] = int(float(parts[1])) % 360
    return out


class _AlikedProbe:
    """Probe extractor on the ALIKED checkpoint, with SuperPointRunner's
    ``extract_images`` / ``extract_arrays`` surface. Raises
    FileNotFoundError where no ``aliked-n16rot.pth`` exists."""

    def __init__(self, max_keypoints: int = 512, resize_max: int = 512,
                 device: torch.device = torch.device("cpu")):
        from .extractors.aliked import load_params
        from .models.aliked import tree_map

        self.device = torch.device(device)
        self.params = tree_map(lambda t: t.to(self.device), load_params("aliked-n16rot"))
        self.max_keypoints = max_keypoints
        self.resize_max = resize_max

    def extract_images(self, paths) -> list:
        prepped = []
        for p in paths:
            img = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
            h, w = img.shape
            scale = 1.0
            if self.resize_max and max(h, w) > self.resize_max:
                scale = self.resize_max / max(h, w)
                img = cv2.resize(img, (round(w * scale), round(h * scale)),
                                 interpolation=cv2.INTER_AREA)
            prepped.append((img, scale, (w, h)))
        return self.extract_arrays(prepped)

    def extract_arrays(self, prepped) -> list:
        """prepped: list of (grayscale image (h, w), scale, orig (w, h));
        keypoints come back divided by ``scale``. Every image is padded to one
        square of side ceil(resize_max / 32) * 32 (or its own, if larger), and
        the images go in chunks of 8 (4 above 768 px); a chunk that runs out
        of device memory is bisected, every other error propagates."""
        from .models import aliked as aliked_model

        results = [None] * len(prepped)
        pad_to = 32
        side = -(-self.resize_max // pad_to) * pad_to
        for img, _, _ in prepped:
            h, w = img.shape[:2]
            side = max(side, -(-h // pad_to) * pad_to, -(-w // pad_to) * pad_to)
        chunk = 8 if side <= 768 else 4

        def run_chunk(sub):
            batch = np.zeros((len(sub), side, side, 3), np.float32)
            vhw = np.zeros((len(sub), 2), np.int64)
            for j, i in enumerate(sub):
                img = prepped[i][0]
                if img.dtype == np.uint8:
                    img = img.astype(np.float32) / 255.0
                h, w = img.shape[:2]
                batch[j, :h, :w] = img[..., None]
                vhw[j] = (h, w)
            out = aliked_model.extract(
                self.params, torch.from_numpy(batch).to(self.device),
                torch.from_numpy(vhw).to(self.device), max_keypoints=self.max_keypoints,
                detection_threshold=0.2, nms_radius=3)
            out = {k: v.cpu().numpy() for k, v in out.items()}
            for j, i in enumerate(sub):
                m = out["mask"][j]
                results[i] = {"keypoints": out["keypoints"][j][m] / prepped[i][1],
                              "descriptors": out["descriptors"][j][m],
                              "scores": out["scores"][j][m]}

        def run_resilient(sub):
            try:
                run_chunk(sub)
            except torch.cuda.OutOfMemoryError:
                if len(sub) <= 1:
                    raise
                torch.cuda.empty_cache()
                logger.warning(f"ALIKED probe batch of {len(sub)} at {side}x{side} ran out "
                               "of device memory; bisecting")
                mid = len(sub) // 2
                run_resilient(sub[:mid])
                run_resilient(sub[mid:])

        for s in range(0, len(prepped), chunk):
            run_resilient(list(range(s, min(s + chunk, len(prepped)))))
        return results


def _make_probe(max_size: int = 512, device: torch.device = torch.device("cpu")):
    """SuperPoint where its checkpoint exists, else the ALIKED probe where
    ALIKED's does, else (only where random weights are allowed)
    random-init SuperPoint; on ``device``."""
    from .models.superpoint import SuperPointRunner, load_default_model
    from .utils import weights as W

    with W.strict():
        try:
            return SuperPointRunner(model=load_default_model(), max_keypoints=PROBE_CAPACITY,
                                    resize_max=max_size, device=device)
        except W.MissingWeightsError:
            pass
        try:
            return _AlikedProbe(max_keypoints=PROBE_CAPACITY, resize_max=max_size, device=device)
        except FileNotFoundError:
            pass
    logger.warning(
        "upright probe: no SuperPoint or ALIKED checkpoints found; "
        "falling back to random-init SuperPoint (policy-gated)."
    )
    return SuperPointRunner(max_keypoints=PROBE_CAPACITY, resize_max=max_size, device=device)


def _pad(f: dict, cap: int = PROBE_CAPACITY):
    k = np.zeros((cap, 2), np.float32)
    d = np.zeros((cap, f["descriptors"].shape[-1]), np.float32)
    m = np.zeros((cap,), bool)
    n = len(f["keypoints"])
    k[:n], d[:n], m[:n] = f["keypoints"], f["descriptors"], True
    return k, d, m


def _probe_rotations(image_list, max_size: int = 512, device=None) -> Dict[str, int]:
    """Greedy growth from the first image at 0 degrees: each other image's
    four rotations, padded to 512 keypoints, are matched in one batch
    against the first image (mutual nearest neighbours with Lowe's ratio
    0.95), verified by MAGSAC, and the rotation with the most inliers wins
    (the first on a tie)."""
    from .constants import GeometricVerification
    from .ops.nn_match import nn_match_auto
    from .utils.device import resolve_device
    from .utils.geometric_verification import geometric_verification

    device = resolve_device(device)
    sp = _make_probe(max_size, device)
    names = image_list.img_names
    rotations = {names[0]: 0}
    rk, rd, rm = _pad(sp.extract_images([image_list[0].path])[0])
    n_rot = len(ROTATIONS)
    ref_d = torch.from_numpy(np.tile(rd[None], (n_rot, 1, 1))).to(device)
    ref_m = torch.from_numpy(np.tile(rm[None], (n_rot, 1))).to(device)
    for img in image_list[1:]:
        gray = cv2.imread(str(img.path), cv2.IMREAD_GRAYSCALE)
        scale = max_size / max(gray.shape)
        if scale < 1:
            gray = cv2.resize(gray, None, fx=scale, fy=scale, interpolation=cv2.INTER_AREA)
        arrs = []
        for deg in ROTATIONS:
            rot = rotate_image(gray, deg).astype(np.float32) / 255.0
            arrs.append((rot, 1.0, (rot.shape[1], rot.shape[0])))
        k4, d4, m4 = (np.stack(a) for a in zip(*(_pad(f) for f in sp.extract_arrays(arrs))))
        matches0, valid = nn_match_auto(ref_d, torch.from_numpy(d4).to(device), ref_m,
                                        torch.from_numpy(m4).to(device),
                                        mode="smnn", ratio_th=0.95)
        matches0, valid = matches0.cpu().numpy(), valid.cpu().numpy()
        best_deg, best_inl = 0, -1
        for i, deg in enumerate(ROTATIONS):
            rows = np.nonzero(valid[i])[0]
            if len(rows) < 8:
                inl = len(rows)
            else:
                _, mask = geometric_verification(
                    rk[rows], k4[i][matches0[i][rows]],
                    method=GeometricVerification.MAGSAC, threshold=4.0, quiet=True,
                )
                inl = int(mask.sum())
            if inl > best_inl:
                best_deg, best_inl = deg, inl
        rotations[img.name] = best_deg
        logger.debug(f"upright: {img.name} -> {best_deg} deg ({best_inl} inliers)")
    return rotations


def rotate_upright_images(image_list, output_dir, config) -> Dict[str, dict]:
    """Find the rotations, write the rotated copies under
    ``output_dir/upright_images`` and point the image list at them, so that
    extraction reads the upright copies. Returns {name: {"deg": d,
    "rotated_wh": (w, h)}} for ``rotate_back_features``."""
    general = getattr(config, "general", None) or {}
    strategy = general.get("upright_strategy", "2clusters")
    if strategy == "exif":
        rotations = {im.name: _exif_rotation(im) for im in image_list}
    elif strategy == "custom":
        rotations = _custom_rotations(image_list[0].path.parent)
    else:
        rotations = _probe_rotations(image_list,
                                     device=general.get("tpu", {}).get("device", "auto"))

    up_dir = Path(output_dir) / "upright_images"
    up_dir.mkdir(parents=True, exist_ok=True)
    info: Dict[str, dict] = {}
    for im in image_list:
        deg = rotations.get(im.name, 0)
        rot = rotate_image(cv2.imread(str(im.path), cv2.IMREAD_UNCHANGED), deg)
        out_path = up_dir / im.name
        cv2.imwrite(str(out_path), rot)
        im._path = out_path  # extraction now reads the upright copy
        info[im.name] = {"deg": deg, "rotated_wh": (rot.shape[1], rot.shape[0])}
    n_rot = sum(1 for v in info.values() if v["deg"] != 0)
    logger.info(f"Upright rotation: {n_rot}/{len(info)} images rotated")
    return info


def rotate_back_features(feature_path, rotated: Dict[str, dict]) -> None:
    """Move the keypoints in features.h5 back into the original frames, in
    their order and dtype, and swap ``image_size`` (int64 (w, h)) at 90 and
    270 degrees, in place: the old datasets are unlinked, the new ones
    appended."""
    from .io import hdf5

    with hdf5.File(feature_path, "a") as fd:
        for name, meta in rotated.items():
            if meta["deg"] == 0 or name not in fd:
                continue
            grp = fd[name]
            kpts = np.asarray(grp["keypoints"])
            back = rotate_keypoints_back(kpts.astype(np.float32), meta["deg"], meta["rotated_wh"])
            del grp["keypoints"]
            grp.create_dataset("keypoints", data=back.astype(kpts.dtype))
            if "image_size" in grp and meta["deg"] % 180 == 90:
                w, h = np.asarray(grp["image_size"])
                del grp["image_size"]
                grp.create_dataset("image_size", data=np.array([h, w], np.int64))
