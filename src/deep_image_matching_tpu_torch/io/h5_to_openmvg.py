"""Export features and matches to an OpenMVG project (port of
``deep_image_matching_tpu/io/h5_to_openmvg.py``): ``matches/sfm_data.json``
(views and intrinsics in cereal's pointer-counter layout), one ``.feat`` file
per image ("x y scale orientation" lines) and the binary putative matches
``matches.putative.bin``, copied to ``matches.f.bin``, which
``openMVG_main_SfM`` reads. The h5 files are read through ``io/hdf5.py``.
"""

from __future__ import annotations

import json
import logging
import shutil
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import yaml
from PIL import Image as PILImage

from . import hdf5
from .h5_to_db import DEFAULT_CAM_OPTIONS, get_focal

logger = logging.getLogger("dim_tpu_torch")

_DIST_PARAM_NAME = {
    "pinhole": None,
    "pinhole_radial_k3": "disto_k3",
    "pinhole_brown_t2": "disto_t2",
}
_DIST_PARAM_LEN = {"pinhole_radial_k3": 3, "pinhole_brown_t2": 5}


def _views_and_intrinsics(img_dir: Path, camera_options: dict) -> dict:
    """Build the OpenMVG sfm_data dict (views + intrinsics)."""
    from ..constants import IMAGE_EXTENSIONS

    images = sorted(
        p.name for p in Path(img_dir).iterdir() if p.suffix in IMAGE_EXTENSIONS
    )
    general = camera_options.get("general", DEFAULT_CAM_OPTIONS["general"])
    model = general.get("openmvg_camera_model", "pinhole_radial_k3")

    # camera grouping: cam{i} glob patterns, else single/per-image cameras
    cam_of: Dict[str, int] = {}
    next_cam = 0
    group_model: Dict[int, str] = {}
    for key in sorted(k for k in camera_options if k.startswith("cam")):
        opt = camera_options[key]
        for pattern in str(opt["images"]).split(","):
            for p in Path(img_dir).glob(pattern.strip()):
                cam_of[p.name] = next_cam
        group_model[next_cam] = opt.get("openmvg_camera_model", model)
        next_cam += 1
    single = general.get("single_camera", False)
    single_id = None
    for name in images:
        if name in cam_of:
            continue
        if single:
            if single_id is None:
                single_id = next_cam
                group_model[single_id] = model
                next_cam += 1
            cam_of[name] = single_id
        else:
            cam_of[name] = next_cam
            group_model[next_cam] = model
            next_cam += 1

    ptr = 2147483649
    views = []
    for vid, name in enumerate(images):
        with PILImage.open(Path(img_dir) / name) as im:
            w, h = im.size
        views.append(
            {
                "key": vid,
                "value": {
                    "polymorphic_id": 1073741824,
                    "ptr_wrapper": {
                        "id": ptr,
                        "data": {
                            "local_path": "",
                            "filename": name,
                            "width": w,
                            "height": h,
                            "id_view": vid,
                            "id_intrinsic": cam_of[name],
                            "id_pose": vid,
                        },
                    },
                },
            }
        )
        ptr += 1

    # one intrinsic per camera group, seeded from its first image
    intrinsics = []
    for cam_id in sorted(set(cam_of.values())):
        first = next(n for n in images if cam_of[n] == cam_id)
        path = Path(img_dir) / first
        with PILImage.open(path) as im:
            w, h = im.size
        cam_model = group_model.get(cam_id, model)
        data = {
            "width": w,
            "height": h,
            "focal_length": get_focal(path),
            "principal_point": [w / 2.0, h / 2.0],
        }
        dist = _DIST_PARAM_NAME.get(cam_model)
        if dist:
            data[dist] = [0.0] * _DIST_PARAM_LEN[cam_model]
        intrinsics.append(
            {
                "key": cam_id,
                "value": {
                    "polymorphic_id": 2147483649,
                    "polymorphic_name": cam_model,
                    "ptr_wrapper": {"id": ptr, "data": data},
                },
            }
        )
        ptr += 1

    return {
        "sfm_data_version": "0.3",
        "root_path": str(Path(img_dir).resolve()),
        "views": views,
        "intrinsics": intrinsics,
        "extrinsics": [],
        "structure": [],
        "control_points": [],
    }


def _save_feat(matches_dir: Path, stem: str, keypoints: np.ndarray) -> None:
    with open(matches_dir / f"{stem}.feat", "w") as f:
        for x, y in keypoints[:, :2]:
            f.write(f"{x} {y} 1.0 0.0\n")


def _save_matches_bin(matches_dir: Path, putative) -> None:
    """OpenMVG PairWiseMatches binary serialization."""
    with open(matches_dir / "matches.putative.bin", "wb") as f:
        f.write((1).to_bytes(1, "little"))
        f.write(len(putative).to_bytes(8, "little"))
        for id1, id2, idxs in putative:
            f.write(np.int32(id1).tobytes())
            f.write(np.int32(id2).tobytes())
            f.write(len(idxs).to_bytes(8, "little"))
            f.write(idxs.astype(np.int32).tobytes())
    shutil.copyfile(
        matches_dir / "matches.putative.bin", matches_dir / "matches.f.bin"
    )


def export_to_openmvg(
    img_dir,
    feature_path: Path,
    match_path: Path,
    openmvg_out_path: Path,
    camera_config_path: Optional[Path] = None,
) -> Path:
    img_dir = Path(img_dir)
    openmvg_out_path = Path(openmvg_out_path)
    if openmvg_out_path.exists():
        shutil.rmtree(openmvg_out_path)
    matches_dir = openmvg_out_path / "matches"
    matches_dir.mkdir(parents=True)

    if camera_config_path:
        with open(camera_config_path) as f:
            camera_options = yaml.safe_load(f)
    else:
        camera_options = DEFAULT_CAM_OPTIONS

    sfm_data = _views_and_intrinsics(img_dir, camera_options)
    with open(matches_dir / "sfm_data.json", "w") as f:
        json.dump(sfm_data, f, indent=2)

    view_ids = {
        v["value"]["ptr_wrapper"]["data"]["filename"]: v["key"]
        for v in sfm_data["views"]
    }

    with hdf5.File(feature_path, "r") as fd:
        for name in fd:
            kpts = np.asarray(fd[name]["keypoints"])
            if kpts.ndim == 2:
                _save_feat(matches_dir, Path(name).stem, kpts)

    putative = []
    with hdf5.File(match_path, "r") as fd:
        for name0 in fd:
            for name1 in fd[name0]:
                putative.append(
                    (view_ids[name0], view_ids[name1], np.asarray(fd[name0][name1]))
                )
    _save_matches_bin(matches_dir, putative)
    logger.info(f"OpenMVG project written to {openmvg_out_path}")
    return openmvg_out_path
