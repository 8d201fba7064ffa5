"""Export for Agisoft Metashape (port of
``deep_image_matching_tpu/io/h5_to_metashape.py``): ``export_to_metashape``
writes the Bundler file of ``h5_to_bundler.py`` (``metashape.out``,
``metashape_list.txt``) with a README on the import; beside it the Homol
helpers of the reference module's surface (``read_Homol_matches``,
``get_matches``, ``show_micmac_matches``, ``execute``, and the MicMac
exporters of ``h5_to_micmac.py``).
"""

from __future__ import annotations

import logging
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .h5_to_bundler import export_to_bundler
from .h5_to_micmac import (  # noqa: F401 — reference function surface
    export_tie_points,
    export_to_micmac,
    get_matched_coords,
)

logger = logging.getLogger("dim_tpu_torch")


def execute(cmd, cwd=None):
    """Stream a subprocess's stdout line by line (reference
    ``h5_to_metashape.py:21-35``)."""
    popen = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, universal_newlines=True, cwd=cwd
    )
    yield from iter(popen.stdout.readline, "")
    popen.stdout.close()
    code = popen.wait()
    if code:
        raise subprocess.CalledProcessError(code, cmd)


def read_Homol_matches(file: Path) -> Tuple[np.ndarray, np.ndarray]:
    """Read a MicMac Homol tie-point file back into (x0y0, x1y1) arrays
    (reference ``h5_to_metashape.py:38-54``)."""
    data = np.loadtxt(file, ndmin=2)
    if data.size == 0:
        return np.zeros((0, 2)), np.zeros((0, 2))
    return data[:, 0:2], data[:, 2:4]


def get_matches(
    feature_path: Path, match_path: Path, key0: str, key1: str
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Matched pixel coordinates for a pair (reference
    ``h5_to_metashape.py:57-99``); alias of the MicMac accessor."""
    return get_matched_coords(feature_path, match_path, key0, key1)


def show_micmac_matches(
    file: Path, image_dir: Path, out: Optional[Path] = None
):
    """Visualize a Homol tie-point file side by side (reference
    ``h5_to_metashape.py:102-150``)."""
    import cv2

    from ..visualization import viz_matches_cv2

    file = Path(file)
    x0y0, x1y1 = read_Homol_matches(file)
    name1 = file.stem
    name0 = file.parent.name.replace("Pastis", "")
    img0 = cv2.imread(str(Path(image_dir) / name0))
    img1 = cv2.imread(str(Path(image_dir) / name1))
    vis = viz_matches_cv2(img0, img1, x0y0, x1y1)
    if out is not None:
        cv2.imwrite(str(out), vis)
    return vis


_README = """Metashape import
================
1. Add the photos listed in metashape_list.txt to a new chunk.
2. Load metashape.out with scripts/metashape/metashape_from_dim.py
   (Metashape Python API: cameras_from_bundler) — Bundler v0.3 format,
   tracks with per-image keypoint observations, origin at image center,
   y up.
3. Align photos with "Source" preselection to triangulate from the
   imported tie points.
"""


def export_to_metashape(
    img_dir: Path,
    feature_path: Path,
    match_path: Path,
    out_dir: Path,
    min_track_length: int = 2,
    px_tolerance: float = 1.0,
    use_descriptors: bool = False,
    descriptor_threshold: float = 0.8,
    camera_config_path: Optional[Path] = None,
) -> Optional[Path]:
    out_dir = Path(out_dir)
    path = export_to_bundler(
        img_dir, feature_path, match_path, out_dir,
        out_name="metashape", min_track_length=min_track_length,
        px_tolerance=px_tolerance, use_descriptors=use_descriptors,
        descriptor_threshold=descriptor_threshold,
        camera_config_path=camera_config_path,
    )
    if path is not None:
        (out_dir / "README_metashape.txt").write_text(_README)
    return path
