"""Image metadata + lazy loading and the sorted image list.

Parity: reference ``utils/image.py:68-453`` (lazy ``Image`` with EXIF —
size, datetime, focal length, intrinsics-from-EXIF via a sensor-width
database — and ``ImageList`` directory scan filtered by extension). EXIF is
read with Pillow instead of exifread (not in this environment).
"""

from __future__ import annotations

import logging
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np
from PIL import ExifTags, Image as PILImage

from ..constants import IMAGE_EXTENSIONS
from .sensor_width_database import SensorWidthDatabase

logger = logging.getLogger("dim_tpu_torch")

DATE_FMT = "%Y:%m:%d %H:%M:%S"


def read_image(path, grayscale: bool = True) -> np.ndarray:
    """Read an image with OpenCV; RGB channel order for color."""
    flag = cv2.IMREAD_GRAYSCALE if grayscale else cv2.IMREAD_COLOR
    img = cv2.imread(str(path), flag)
    if img is None:
        raise ValueError(f"Cannot read image {path}")
    if not grayscale and img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img


def resize_image(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Resize to (width, height); area interpolation when shrinking."""
    h, w = img.shape[:2]
    interp = cv2.INTER_AREA if (size[0] < w or size[1] < h) else cv2.INTER_CUBIC
    return cv2.resize(img, size, interpolation=interp)


class Image:
    """Lazy image: path + cached EXIF metadata; pixel data read on demand."""

    def __init__(self, path, image_id: Optional[int] = None):
        self._path = Path(path)
        if not self._path.exists():
            raise FileNotFoundError(f"Image not found: {self._path}")
        self._id = image_id
        self._width: Optional[int] = None
        self._height: Optional[int] = None
        self._exif: Dict = {}
        self._date_time: Optional[datetime] = None
        self._focal_length: Optional[float] = None
        self._camera_make: Optional[str] = None
        self._camera_model: Optional[str] = None
        self._read_exif()

    def __repr__(self) -> str:
        return f"Image({self.name})"

    @property
    def path(self) -> Path:
        return self._path

    @property
    def name(self) -> str:
        return self._path.name

    @property
    def stem(self) -> str:
        return self._path.stem

    @property
    def id(self) -> Optional[int]:
        return self._id

    @property
    def width(self) -> int:
        if self._width is None:
            self._read_size()
        return self._width

    @property
    def height(self) -> int:
        if self._height is None:
            self._read_size()
        return self._height

    @property
    def size(self) -> Tuple[int, int]:
        return (self.width, self.height)

    @property
    def exif(self) -> Dict:
        return self._exif

    @property
    def date_time(self) -> Optional[datetime]:
        return self._date_time

    @property
    def focal_length(self) -> Optional[float]:
        return self._focal_length

    def _read_size(self) -> None:
        with PILImage.open(self._path) as im:
            self._width, self._height = im.size

    def _read_exif(self) -> None:
        try:
            with PILImage.open(self._path) as im:
                self._width, self._height = im.size
                raw = im.getexif()
                if not raw:
                    return
                exif = {ExifTags.TAGS.get(t, t): v for t, v in raw.items()}
                # focal length lives in the EXIF IFD
                try:
                    ifd = raw.get_ifd(ExifTags.IFD.Exif)
                    exif.update({ExifTags.TAGS.get(t, t): v for t, v in ifd.items()})
                except Exception:
                    pass
                self._exif = exif
        except Exception as e:  # EXIF is best-effort
            logger.debug(f"No EXIF for {self.name}: {e}")
            return
        dt = self._exif.get("DateTimeOriginal") or self._exif.get("DateTime")
        if dt:
            try:
                self._date_time = datetime.strptime(str(dt).strip(), DATE_FMT)
            except ValueError:
                pass
        fl = self._exif.get("FocalLength")
        if fl is not None:
            try:
                self._focal_length = float(fl)
            except (TypeError, ZeroDivisionError):
                pass
        self._camera_make = self._exif.get("Make")
        self._camera_model = self._exif.get("Model")

    def read_image(self, grayscale: bool = True) -> np.ndarray:
        return read_image(self._path, grayscale=grayscale)

    def get_intrinsics_from_exif(self) -> Optional[np.ndarray]:
        """Approximate pinhole K from EXIF focal length + sensor-width DB
        (reference ``utils/image.py:312-359``). Falls back to the
        1.2*max(w,h) prior when EXIF is missing."""
        w, h = self.size
        focal_px = None
        if self._focal_length and self._camera_model:
            try:
                db = SensorWidthDatabase()
                sensor_w = db.lookup(self._camera_make or "", self._camera_model)
                focal_px = self._focal_length / sensor_w * max(w, h)
            except Exception:
                focal_px = None
        if focal_px is None:
            focal_px = 1.2 * max(w, h)
        return np.array(
            [[focal_px, 0.0, w / 2.0], [0.0, focal_px, h / 2.0], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )


class ImageList:
    """Sorted list of the images in a directory (reference
    ``utils/image.py:362-453``)."""

    def __init__(self, image_dir, extensions=IMAGE_EXTENSIONS):
        image_dir = Path(image_dir)
        if not image_dir.is_dir():
            raise FileNotFoundError(f"Not a directory: {image_dir}")
        paths = sorted(
            p for p in image_dir.iterdir()
            if p.is_file() and p.suffix in extensions
        )
        if not paths:
            raise ValueError(f"No images found in {image_dir}")
        self.images: List[Image] = [Image(p, image_id=i) for i, p in enumerate(paths)]

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i: int) -> Image:
        return self.images[i]

    def __iter__(self):
        return iter(self.images)

    @property
    def img_names(self) -> List[str]:
        return [im.name for im in self.images]

    @property
    def img_paths(self) -> List[Path]:
        return [im.path for im in self.images]
