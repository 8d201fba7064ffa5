"""COLMAP sparse-model reader/writer (text and binary).

Parity: reference ``io/colmap_read_write_model.py:55-584`` — cameras /
images / points3D in the standard COLMAP text and binary formats (format
spec: colmap.github.io/format.html). Own compact implementation.
"""

from __future__ import annotations

import struct
from collections import namedtuple
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

Camera = namedtuple("Camera", ["id", "model", "width", "height", "params"])
BaseImage = namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"]
)
Point3D = namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"]
)


class Image(BaseImage):
    def qvec2rotmat(self):
        return qvec2rotmat(self.qvec)


CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}


def qvec2rotmat(qvec):
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x**2 - 2 * y**2],
        ]
    )


def rotmat2qvec(R):
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


# ---------------------------------------------------------------------------
# Text IO
# ---------------------------------------------------------------------------

def read_cameras_text(path) -> Dict[int, Camera]:
    cameras = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        elems = line.split()
        cameras[int(elems[0])] = Camera(
            id=int(elems[0]), model=elems[1],
            width=int(elems[2]), height=int(elems[3]),
            params=np.array(list(map(float, elems[4:]))),
        )
    return cameras


def read_images_text(path) -> Dict[int, Image]:
    images = {}
    # keep empty lines: an image with zero points has an empty second line
    lines = [
        l.strip() for l in Path(path).read_text().splitlines()
        if not l.startswith("#")
    ]
    i = 0
    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        elems = lines[i].split()
        image_id = int(elems[0])
        qvec = np.array(list(map(float, elems[1:5])))
        tvec = np.array(list(map(float, elems[5:8])))
        camera_id = int(elems[8])
        name = elems[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        i += 2
        xys = np.array(
            [list(map(float, pts[j : j + 2])) for j in range(0, len(pts), 3)]
        ).reshape(-1, 2)
        ids = np.array([int(pts[j + 2]) for j in range(0, len(pts), 3)], dtype=np.int64)
        images[image_id] = Image(
            id=image_id, qvec=qvec, tvec=tvec, camera_id=camera_id,
            name=name, xys=xys, point3D_ids=ids,
        )
    return images


def read_points3D_text(path) -> Dict[int, Point3D]:
    points = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        e = line.split()
        pid = int(e[0])
        points[pid] = Point3D(
            id=pid,
            xyz=np.array(list(map(float, e[1:4]))),
            rgb=np.array([int(float(v)) for v in e[4:7]]),
            error=float(e[7]),
            image_ids=np.array(list(map(int, e[8::2]))),
            point2D_idxs=np.array(list(map(int, e[9::2]))),
        )
    return points


def write_cameras_text(cameras: Dict[int, Camera], path) -> None:
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        f.write(f"# Number of cameras: {len(cameras)}\n")
        for cam in cameras.values():
            params = " ".join(map(str, cam.params))
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def write_images_text(images: Dict[int, Image], path) -> None:
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for im in images.values():
            q = " ".join(map(str, im.qvec))
            t = " ".join(map(str, im.tvec))
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            pts = " ".join(
                f"{x} {y} {pid}"
                for (x, y), pid in zip(im.xys, im.point3D_ids)
            )
            f.write(pts + "\n")


def write_points3D_text(points3D: Dict[int, Point3D], path) -> None:
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write("#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for pt in points3D.values():
            xyz = " ".join(map(str, pt.xyz))
            rgb = " ".join(str(int(v)) for v in pt.rgb)
            track = " ".join(
                f"{iid} {pidx}" for iid, pidx in zip(pt.image_ids, pt.point2D_idxs)
            )
            f.write(f"{pt.id} {xyz} {rgb} {pt.error} {track}\n")


# ---------------------------------------------------------------------------
# Binary IO
# ---------------------------------------------------------------------------

def _read(fid, fmt):
    return struct.unpack(fmt, fid.read(struct.calcsize(fmt)))


def read_cameras_binary(path) -> Dict[int, Camera]:
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cameras[cam_id] = Camera(cam_id, name, int(w), int(h), params)
    return cameras


def read_images_binary(path) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            image_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            camera_id = _read(f, "<i")[0]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (n_pts,) = _read(f, "<Q")
            data = _read(f, "<" + "ddq" * n_pts)
            xys = np.array(data).reshape(-1, 3)[:, :2] if n_pts else np.zeros((0, 2))
            ids = np.array(data[2::3], dtype=np.int64) if n_pts else np.zeros(0, np.int64)
            images[image_id] = Image(
                image_id, qvec, tvec, camera_id, name.decode(), xys, ids
            )
    return images


def read_points3D_binary(path) -> Dict[int, Point3D]:
    points = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pid = _read(f, "<Q")[0]
            xyz = np.array(_read(f, "<3d"))
            rgb = np.array(_read(f, "<3B"))
            error = _read(f, "<d")[0]
            (track_len,) = _read(f, "<Q")
            track = _read(f, "<" + "ii" * track_len)
            points[pid] = Point3D(
                pid, xyz, rgb, error,
                np.array(track[0::2]), np.array(track[1::2]),
            )
    return points


def write_cameras_binary(cameras: Dict[int, Camera], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model_id, _ = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, model_id, cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_binary(images: Dict[int, Image], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", x, y, int(pid)))


def write_points3D_binary(points3D: Dict[int, Point3D], path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points3D)))
        for pt in points3D.values():
            f.write(struct.pack("<Q", int(pt.id)))
            f.write(struct.pack("<3d", *pt.xyz))
            f.write(struct.pack("<3B", *np.asarray(pt.rgb, np.uint8)))
            f.write(struct.pack("<d", float(pt.error)))
            f.write(struct.pack("<Q", len(pt.image_ids)))
            for iid, pidx in zip(pt.image_ids, pt.point2D_idxs):
                f.write(struct.pack("<ii", int(iid), int(pidx)))


# ---------------------------------------------------------------------------
# Model-level helpers
# ---------------------------------------------------------------------------

def detect_model_format(path, ext: str = "") -> str:
    path = Path(path)
    if (path / "cameras.bin").exists():
        return ".bin"
    if (path / "cameras.txt").exists():
        return ".txt"
    raise FileNotFoundError(f"No COLMAP model found at {path}")


def read_model(path, ext: str = "") -> Tuple[dict, dict, dict]:
    path = Path(path)
    if not ext:
        ext = detect_model_format(path)
    if ext == ".txt":
        cameras = read_cameras_text(path / "cameras.txt")
        images = read_images_text(path / "images.txt")
        points3D = read_points3D_text(path / "points3D.txt")
    else:
        cameras = read_cameras_binary(path / "cameras.bin")
        images = read_images_binary(path / "images.bin")
        points3D = read_points3D_binary(path / "points3D.bin")
    return cameras, images, points3D


def write_model(cameras, images, points3D, path, ext: str = ".txt") -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    if ext == ".txt":
        write_cameras_text(cameras, path / "cameras.txt")
        write_images_text(images, path / "images.txt")
        write_points3D_text(points3D, path / "points3D.txt")
    else:
        write_cameras_binary(cameras, path / "cameras.bin")
        write_images_binary(images, path / "images.bin")
        write_points3D_binary(points3D, path / "points3D.bin")
