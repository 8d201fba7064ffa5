"""Export features.h5 + matches.h5 to a COLMAP SQLite database.

Parity: reference ``io/h5_to_db.py:44-453`` — camera grouping from a
cameras.yaml (glob patterns per cam group, single_camera logic), EXIF
35mm-focal prior (1.2*max_size fallback), raw matches -> ``matches`` table,
verified matches -> ``two_view_geometries``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import yaml
from PIL import ExifTags, Image as PILImage

from . import hdf5
from .colmap_db import COLMAPDatabase, image_ids_to_pair_id

logger = logging.getLogger("dim_tpu_torch")

DEFAULT_CAM_OPTIONS = {
    "general": {
        "single_camera": False,
        "camera_model": "simple-radial",
    },
}

_CAMERA_MODELS = {
    # name -> (colmap model id, params builder)
    "simple-pinhole": (0, lambda f, w, h: [f, w / 2, h / 2]),
    "pinhole": (1, lambda f, w, h: [f, f, w / 2, h / 2]),
    "simple-radial": (2, lambda f, w, h: [f, w / 2, h / 2, 0.1]),
    "opencv": (4, lambda f, w, h: [f, f, w / 2, h / 2, 0.0, 0.0, 0.0, 0.0]),
}


def get_focal(image_path: Path, err_on_default: bool = False) -> float:
    """Focal prior in pixels from EXIF FocalLengthIn35mmFilm, else
    1.2 * max(width, height) (the COLMAP prior)."""
    with PILImage.open(image_path) as image:
        max_size = max(image.size)
        exif = image.getexif()
    focal = None
    if exif:
        for tag, value in exif.items():
            if ExifTags.TAGS.get(tag) == "FocalLengthIn35mmFilm":
                try:
                    f35 = float(value)
                    if f35 > 0:
                        focal = f35 / 35.0 * max_size
                except (TypeError, ValueError):
                    pass
                break
    if focal is None:
        if err_on_default:
            raise RuntimeError(f"No EXIF focal for {image_path}")
        focal = 1.2 * max_size
    return focal


def create_camera(
    db: COLMAPDatabase,
    image_path: Path,
    camera_model: str,
    param_arr=None,
) -> int:
    with PILImage.open(image_path) as image:
        width, height = image.size
    if camera_model not in _CAMERA_MODELS:
        raise RuntimeError(f"Invalid camera model {camera_model}")
    model_id, default_params = _CAMERA_MODELS[camera_model]
    if param_arr is None:
        focal = get_focal(image_path)
        param_arr = default_params(focal, width, height)
    return db.add_camera(model_id, width, height, np.asarray(param_arr, np.float64))


def parse_camera_options(
    camera_options: dict, db: COLMAPDatabase, image_path: Path
) -> Dict[str, dict]:
    """Group images into cameras by the cam{i} glob patterns; create one
    camera per group seeded from its first image."""
    grouped: Dict[str, dict] = {}
    cam_keys = [k for k in camera_options if k.startswith("cam")]
    for idx, cam_key in enumerate(sorted(cam_keys)):
        cam_opt = camera_options[cam_key]
        images = []
        for pattern in str(cam_opt["images"]).split(","):
            images.extend(p.name for p in Path(image_path).glob(pattern.strip()))
        images = sorted(set(images))
        for i, img in enumerate(images):
            grouped[img] = {"camera_id": idx + 1}
            if i == 0:
                try:
                    create_camera(
                        db, Path(image_path) / img,
                        cam_opt["camera_model"], cam_opt.get("intrinsics"),
                    )
                except Exception:
                    logger.warning(f"Could not initialize camera group {cam_key}")
    return grouped


def add_keypoints(
    db: COLMAPDatabase,
    h5_path: Path,
    image_path: Path,
    camera_options: Optional[dict] = None,
) -> Dict[str, int]:
    if not camera_options:
        camera_options = DEFAULT_CAM_OPTIONS
    grouped = parse_camera_options(camera_options, db, image_path)
    general = camera_options.get("general", DEFAULT_CAM_OPTIONS["general"])
    fname_to_id: Dict[str, int] = {}
    single_camera_id = None
    with hdf5.File(h5_path, "r") as fd:
        for filename in fd:
            keypoints = np.asarray(fd[filename]["keypoints"])
            path = Path(image_path) / filename
            if not path.exists():
                raise OSError(f"Invalid image path {path}")
            if filename in grouped:
                camera_id = grouped[filename]["camera_id"]
            elif general.get("single_camera", False):
                if single_camera_id is None:
                    single_camera_id = create_camera(
                        db, path, general["camera_model"]
                    )
                camera_id = single_camera_id
            else:
                camera_id = create_camera(db, path, general["camera_model"])
            image_id = db.add_image(filename, camera_id)
            fname_to_id[filename] = image_id
            if keypoints.ndim >= 2 and len(keypoints) > 0:
                db.add_keypoints(image_id, keypoints)
    return fname_to_id


def _add_match_groups(db, h5_path, fname_to_id, two_view: bool) -> None:
    added = set()
    with hdf5.File(h5_path, "r") as fd:
        for key1 in fd:
            group = fd[key1]
            if not hasattr(group, "keys"):
                continue
            for key2 in group:
                id1, id2 = fname_to_id[key1], fname_to_id[key2]
                pair_id = image_ids_to_pair_id(id1, id2)
                if pair_id in added:
                    logger.warning(f"Pair ({key1}, {key2}) already added, skipping")
                    continue
                matches = np.asarray(group[key2])
                if two_view:
                    db.add_two_view_geometry(id1, id2, matches)
                else:
                    db.add_matches(id1, id2, matches)
                added.add(pair_id)


def export_to_colmap(
    img_dir: Union[str, Path],
    feature_path: Path,
    match_path: Path,
    database_path: Union[str, Path] = "database.db",
    camera_config_path: Optional[Path] = None,
) -> None:
    """Create a COLMAP database from the pipeline's h5 artifacts."""
    database_path = Path(database_path)
    if database_path.exists():
        logger.warning(f"Database {database_path} exists - deleting it")
        database_path.unlink()
    if camera_config_path is not None:
        with open(camera_config_path) as f:
            camera_options = yaml.safe_load(f)
    else:
        camera_options = DEFAULT_CAM_OPTIONS
    db = COLMAPDatabase.connect(database_path)
    try:
        db.create_tables()
        fname_to_id = add_keypoints(db, Path(feature_path), Path(img_dir), camera_options)
        raw_match_path = Path(match_path).parent / "raw_matches.h5"
        if raw_match_path.exists():
            _add_match_groups(db, raw_match_path, fname_to_id, two_view=False)
        if Path(match_path).exists():
            _add_match_groups(db, match_path, fname_to_id, two_view=True)
        db.commit()
    finally:
        db.close()
