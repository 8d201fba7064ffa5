"""Export tie points to the MicMac Homol format (port of
``deep_image_matching_tpu/io/h5_to_micmac.py``): per-pair files
``Homol/Pastis{img0}/{img1}.txt`` of "x0 y0 x1 y1 1.000000" lines in both
directions, the images copied beside the tree, and MicMac's ``Tapas``
relative orientation where asked for and an ``mm3d`` executable is found
(otherwise a warning, and the project is left for external processing). The
h5 files are read through ``io/hdf5.py``.
"""

from __future__ import annotations

import logging
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from . import hdf5

logger = logging.getLogger("dim_tpu_torch")


def _coords(feats, matches, key0: str, key1: str):
    if key0 in matches and key1 in matches[key0]:
        m = np.asarray(matches[key0][key1])
    elif key1 in matches and key0 in matches[key1]:
        m = np.asarray(matches[key1][key0])[:, ::-1]
    else:
        return None, None
    k0 = np.asarray(feats[key0]["keypoints"])[m[:, 0]]
    k1 = np.asarray(feats[key1]["keypoints"])[m[:, 1]]
    return k0, k1


def get_matched_coords(
    feature_path: Path, match_path: Path, key0: str, key1: str
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """The matched keypoints of a pair, (k0, k1), in either stored order;
    (None, None) where the pair has no matches."""
    with hdf5.File(feature_path, "r") as feats, hdf5.File(match_path, "r") as matches:
        return _coords(feats, matches, key0, key1)


def _write_homol(file: Path, x0y0: np.ndarray, x1y1: np.ndarray) -> None:
    with open(file, "w") as f:
        for (x0, y0), (x1, y1) in zip(x0y0, x1y1):
            f.write(f"{x0:6f} {y0:6f} {x1:6f} {y1:6f} 1.000000\n")


def export_tie_points(
    feature_path: Path, match_path: Path, out_dir: Path
) -> None:
    """Write the symmetric Homol tree for every matched pair."""
    out_dir = Path(out_dir)
    with hdf5.File(feature_path, "r") as feats, hdf5.File(match_path, "r") as matches:
        pairs = [(a, b) for a in matches for b in matches[a]]
        names = sorted({n for p in pairs for n in p})
        for name in names:
            (out_dir / f"Pastis{name}").mkdir(parents=True, exist_ok=True)
        for key0, key1 in pairs:
            _export_pair(out_dir, key0, key1, *_coords(feats, matches, key0, key1))


def _export_pair(out_dir: Path, key0: str, key1: str, x0y0, x1y1) -> None:
    f01 = out_dir / f"Pastis{key0}" / f"{key1}.txt"
    f10 = out_dir / f"Pastis{key1}" / f"{key0}.txt"
    if x0y0 is None or len(x0y0) == 0:
        # MicMac crashes on empty files: write one dummy point that the
        # bundle adjustment discards as an outlier (reference behavior)
        x0y0 = x1y1 = np.zeros((1, 2))
    _write_homol(f01, x0y0, x1y1)
    _write_homol(f10, x1y1, x0y0)


def export_to_micmac(
    image_dir: Path,
    feature_path: Path,
    match_path: Path,
    out_dir: Path = "micmac",
    img_ext: str = ".jpg",
    run_Tapas: bool = False,
    micmac_path: Optional[Path] = None,
) -> Path:
    image_dir = Path(image_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    # copy images next to the Homol tree (MicMac expects them together)
    for img in sorted(image_dir.iterdir()):
        if img.is_file():
            dst = out_dir / img.name
            if not dst.exists():
                shutil.copy(img, dst)
    export_tie_points(feature_path, match_path, out_dir / "Homol")
    logger.info(f"MicMac project written to {out_dir}")

    if run_Tapas:
        exe = micmac_path or shutil.which("mm3d")
        if exe is None:
            logger.warning("MicMac (mm3d) not found - skipping Tapas")
            return out_dir
        cmd = [str(exe), "Tapas", "FraserBasic", f".*{img_ext}", "Out=Relative"]
        logger.info(f"Running: {' '.join(cmd)}")
        result = subprocess.run(cmd, cwd=out_dir, capture_output=True, text=True)
        if result.returncode != 0:
            logger.error(f"MicMac Tapas failed:\n{result.stderr}")
    return out_dir
