"""COLMAP SQLite database layer.

Implements the standard COLMAP database schema (cameras, images, keypoints,
descriptors, matches, two_view_geometries) so reconstructions can run with
stock COLMAP/pycolmap. Parity: reference ``utils/database.py:34-372``.
Schema and pair-id convention follow the public COLMAP format spec
(pair_id = image_id1 * 2147483647 + image_id2, ids swapped so id1 <= id2).
"""

from __future__ import annotations

import sqlite3
from typing import Optional, Tuple

import numpy as np

MAX_IMAGE_ID = 2**31 - 1

_CREATE_CAMERAS = """CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    params BLOB,
    prior_focal_length INTEGER NOT NULL)"""

_CREATE_IMAGES = f"""CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < {MAX_IMAGE_ID}),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id))"""

_CREATE_KEYPOINTS = """CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE)"""

_CREATE_DESCRIPTORS = """CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE)"""

_CREATE_MATCHES = """CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB)"""

_CREATE_TWO_VIEW_GEOMETRIES = """CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL,
    cols INTEGER NOT NULL,
    data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB,
    qvec BLOB, tvec BLOB)"""

_CREATE_NAME_INDEX = "CREATE UNIQUE INDEX IF NOT EXISTS index_name ON images(name)"


def image_ids_to_pair_id(image_id1: int, image_id2: int) -> int:
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def pair_id_to_image_ids(pair_id: int) -> Tuple[int, int]:
    image_id2 = pair_id % MAX_IMAGE_ID
    image_id1 = (pair_id - image_id2) // MAX_IMAGE_ID
    return int(image_id1), int(image_id2)


def array_to_blob(array: np.ndarray) -> bytes:
    return np.ascontiguousarray(array).tobytes()


def blob_to_array(blob, dtype, shape=(-1,)) -> np.ndarray:
    if blob is None:
        return np.zeros(shape, dtype=dtype)
    return np.frombuffer(blob, dtype=dtype).reshape(*shape)


class COLMAPDatabase(sqlite3.Connection):
    @staticmethod
    def connect(database_path) -> "COLMAPDatabase":
        return sqlite3.connect(str(database_path), factory=COLMAPDatabase)

    def create_tables(self) -> None:
        for stmt in (
            _CREATE_CAMERAS,
            _CREATE_IMAGES,
            _CREATE_KEYPOINTS,
            _CREATE_DESCRIPTORS,
            _CREATE_MATCHES,
            _CREATE_TWO_VIEW_GEOMETRIES,
            _CREATE_NAME_INDEX,
        ):
            self.executescript(stmt)

    def add_camera(
        self,
        model,
        width: int,
        height: int,
        params,
        prior_focal_length: bool = False,
        camera_id: Optional[int] = None,
    ) -> int:
        params = np.asarray(params, np.float64)
        cursor = self.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, int(model), int(width), int(height),
             array_to_blob(params), int(prior_focal_length)),
        )
        return cursor.lastrowid

    def add_image(
        self,
        name: str,
        camera_id: int,
        prior_q=(None, None, None, None),
        prior_t=(None, None, None),
        image_id: Optional[int] = None,
    ) -> int:
        cursor = self.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, *prior_q, *prior_t),
        )
        return cursor.lastrowid

    def add_keypoints(self, image_id: int, keypoints: np.ndarray) -> None:
        keypoints = np.asarray(keypoints, np.float32)
        assert keypoints.ndim == 2 and keypoints.shape[1] in (2, 4, 6)
        self.execute(
            "INSERT INTO keypoints VALUES (?, ?, ?, ?)",
            (image_id,) + keypoints.shape + (array_to_blob(keypoints),),
        )

    def add_descriptors(self, image_id: int, descriptors: np.ndarray) -> None:
        descriptors = np.ascontiguousarray(descriptors, np.uint8)
        self.execute(
            "INSERT INTO descriptors VALUES (?, ?, ?, ?)",
            (image_id,) + descriptors.shape + (array_to_blob(descriptors),),
        )

    def add_matches(self, image_id1: int, image_id2: int, matches: np.ndarray) -> None:
        assert matches.ndim == 2 and matches.shape[1] == 2
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        pair_id = image_ids_to_pair_id(image_id1, image_id2)
        matches = np.asarray(matches, np.uint32)
        self.execute(
            "INSERT INTO matches VALUES (?, ?, ?, ?)",
            (pair_id,) + matches.shape + (array_to_blob(matches),),
        )

    def add_two_view_geometry(
        self,
        image_id1: int,
        image_id2: int,
        matches: np.ndarray,
        F=np.eye(3),
        E=np.eye(3),
        H=np.eye(3),
        qvec=np.array([1.0, 0.0, 0.0, 0.0]),
        tvec=np.zeros(3),
        config: int = 2,
    ) -> None:
        assert matches.ndim == 2 and matches.shape[1] == 2
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        pair_id = image_ids_to_pair_id(image_id1, image_id2)
        matches = np.asarray(matches, np.uint32)
        self.execute(
            "INSERT INTO two_view_geometries VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (pair_id,) + matches.shape + (
                array_to_blob(matches), config,
                array_to_blob(np.asarray(F, np.float64)),
                array_to_blob(np.asarray(E, np.float64)),
                array_to_blob(np.asarray(H, np.float64)),
                array_to_blob(np.asarray(qvec, np.float64)),
                array_to_blob(np.asarray(tvec, np.float64)),
            ),
        )
