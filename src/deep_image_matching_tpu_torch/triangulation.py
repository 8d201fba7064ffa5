"""Triangulation from known poses: rebuild a database and triangulate.

Parity: reference ``triangulation.py:31-306`` — given an existing COLMAP
model (known poses) plus fresh features/matches, build a new database
(``create_db_from_model``), import keypoints with the +0.5 COLMAP pixel-origin
offset, import matches, verify them by epipolar error against the known
two-view geometry (``import_verifed_matches``), and run point triangulation
(pycolmap when available). Epipolar errors are computed with numpy from the
model poses — no C++ dependency for the verification path.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .io.colmap_db import COLMAPDatabase
from .io.colmap_read_write_model import (
    CAMERA_MODEL_IDS,
    read_model,
    qvec2rotmat,
)
from .io.h5 import get_features, get_matches, list_h5_names, list_pairs

logger = logging.getLogger("dim_tpu_torch")


def _camera_calibration_matrix(camera) -> np.ndarray:
    p = camera.params
    if camera.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                        "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
        f, cx, cy = p[0], p[1], p[2]
        fx = fy = f
    else:
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])


def _fundamental_from_poses(cam0, im0, cam1, im1) -> np.ndarray:
    """F from two posed images (world-to-camera qvec/tvec, COLMAP convention)."""
    R0, t0 = qvec2rotmat(im0.qvec), im0.tvec
    R1, t1 = qvec2rotmat(im1.qvec), im1.tvec
    # relative pose: x1 = R x0 + t with R = R1 R0^T
    R = R1 @ R0.T
    t = t1 - R @ t0
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = tx @ R
    K0 = _camera_calibration_matrix(cam0)
    K1 = _camera_calibration_matrix(cam1)
    return np.linalg.inv(K1).T @ E @ np.linalg.inv(K0)


def compute_epipolar_errors(F: np.ndarray, p0: np.ndarray, p1: np.ndarray):
    """Symmetric epipolar (line) distances for (M, 2) correspondences
    (reference ``utils/utils.py:88-108``)."""
    x0 = np.concatenate([p0, np.ones_like(p0[:, :1])], axis=1)
    x1 = np.concatenate([p1, np.ones_like(p1[:, :1])], axis=1)
    l1 = x0 @ F.T  # epipolar lines in image 1
    l0 = x1 @ F    # epipolar lines in image 0
    num = np.abs(np.sum(x1 * l1, axis=1))
    d1 = num / np.maximum(np.linalg.norm(l1[:, :2], axis=1), 1e-12)
    d0 = num / np.maximum(np.linalg.norm(l0[:, :2], axis=1), 1e-12)
    return d0, d1


def create_db_from_model(model_path: Path, database_path: Path) -> Dict[str, int]:
    """Fresh database with the model's cameras and images; returns
    name -> image_id (reference ``triangulation.py:31-68``)."""
    cameras, images, _ = read_model(model_path)
    database_path = Path(database_path)
    if database_path.exists():
        database_path.unlink()
    db = COLMAPDatabase.connect(database_path)
    db.create_tables()
    for cam in cameras.values():
        model_id, _ = CAMERA_MODEL_IDS[cam.model]
        db.add_camera(
            model_id, cam.width, cam.height, cam.params,
            prior_focal_length=True, camera_id=cam.id,
        )
    for im in images.values():
        db.add_image(
            im.name, im.camera_id,
            prior_q=tuple(im.qvec), prior_t=tuple(im.tvec),
            image_id=im.id,
        )
    db.commit()
    db.close()
    return {im.name: im.id for im in images.values()}


def import_keypoints(
    database_path: Path, feature_path: Path, name_to_id: Dict[str, int]
) -> None:
    """Keypoints shifted by +0.5 into COLMAP's center-of-pixel convention
    (reference ``triangulation.py:117-133``)."""
    db = COLMAPDatabase.connect(database_path)
    for name in list_h5_names(feature_path):
        if name not in name_to_id:
            continue
        kpts = get_features(feature_path, name)["keypoints"] + 0.5
        db.add_keypoints(name_to_id[name], kpts)
    db.commit()
    db.close()


def import_matches(
    database_path: Path,
    match_path: Path,
    name_to_id: Dict[str, int],
    pairs,
    add_two_view_geometry: bool = False,
) -> None:
    db = COLMAPDatabase.connect(database_path)
    for name0, name1 in pairs:
        try:
            matches = get_matches(match_path, name0, name1)
        except ValueError:
            continue
        id0, id1 = name_to_id[name0], name_to_id[name1]
        db.add_matches(id0, id1, matches)
        if add_two_view_geometry:
            db.add_two_view_geometry(id0, id1, matches)
    db.commit()
    db.close()


def import_verified_matches(
    database_path: Path,
    model_path: Path,
    feature_path: Path,
    match_path: Path,
    pairs,
    max_error: float = 4.0,
) -> None:
    """Verify matches against the known two-view geometry from poses and
    write inliers to two_view_geometries (reference
    ``triangulation.py:167-252``)."""
    cameras, images, _ = read_model(model_path)
    by_name = {im.name: im for im in images.values()}
    db = COLMAPDatabase.connect(database_path)
    kept = 0
    for name0, name1 in pairs:
        if name0 not in by_name or name1 not in by_name:
            continue
        try:
            matches = get_matches(match_path, name0, name1)
        except ValueError:
            continue
        if len(matches) == 0:
            continue
        im0, im1 = by_name[name0], by_name[name1]
        F = _fundamental_from_poses(
            cameras[im0.camera_id], im0, cameras[im1.camera_id], im1
        )
        k0 = get_features(feature_path, name0)["keypoints"][matches[:, 0]] + 0.5
        k1 = get_features(feature_path, name1)["keypoints"][matches[:, 1]] + 0.5
        d0, d1 = compute_epipolar_errors(F, k0, k1)
        valid = (d0 <= max_error) & (d1 <= max_error)
        if valid.sum() == 0:
            continue
        db.add_two_view_geometry(im0.id, im1.id, matches[valid], F=F, config=3)
        kept += 1
    db.commit()
    db.close()
    logger.info(f"Verified matches imported for {kept} pairs")


def db_from_existing_poses(
    model_path: Path,
    feature_path: Path,
    match_path: Path,
    database_path: Path,
    pairs=None,
    max_error: float = 4.0,
) -> Path:
    """Full rebuild: model poses + fresh features/matches -> database ready
    for point triangulation (reference ``triangulation.py:255-306``)."""
    if pairs is None:
        pairs = list_pairs(match_path)
    name_to_id = create_db_from_model(model_path, database_path)
    # matches may cover images the model never registered; only pairs of
    # registered images can triangulate against the known poses
    kept = [(a, b) for a, b in pairs if a in name_to_id and b in name_to_id]
    if len(kept) < len(pairs):
        logger.warning(
            f"Skipping {len(pairs) - len(kept)} pairs with images not in "
            f"the model ({len(kept)} remain)"
        )
    pairs = kept
    import_keypoints(database_path, feature_path, name_to_id)
    import_matches(database_path, match_path, name_to_id, pairs)
    import_verified_matches(
        database_path, model_path, feature_path, match_path, pairs, max_error
    )
    return Path(database_path)


def triangulate_points(
    model_path: Path,
    database_path: Path,
    image_dir: Path,
    output_dir: Path,
    backend: str = "auto",
    device=None,
) -> Optional[object]:
    """Point triangulation with known poses (pycolmap or the native mapper).

    ``backend``: "auto" prefers pycolmap, falling back to the native
    triangulator (``sfm.native_triangulate_points``, which refines the points
    on ``device``); or force one with "pycolmap" / "native".
    """
    have_pycolmap = True
    try:
        import pycolmap
    except ImportError:
        have_pycolmap = False
    if backend == "native" or (backend == "auto" and not have_pycolmap):
        from .sfm.incremental import native_triangulate_points

        return native_triangulate_points(
            model_path, database_path, image_dir, output_dir, device=device
        )
    if not have_pycolmap:
        logger.warning("pycolmap not installed - database is ready for "
                       "external 'colmap point_triangulator'")
        return None
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    rec = pycolmap.triangulate_points(
        pycolmap.Reconstruction(str(model_path)),
        str(database_path), str(image_dir), str(output_dir),
    )
    logger.info(f"Triangulated {rec.num_points3D()} points")
    return rec
