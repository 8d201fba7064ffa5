"""Camera-model -> CCD sensor width lookup.

Parity: reference ``utils/sensor_width_database.py`` (semicolon CSV
"Model;width_mm", openMVG database). The CSV is not vendored here (no network
egress to fetch it and no need to duplicate the reference's data file); the
lookup resolves a database file from, in order: an explicit path, the
``DIM_TPU_SENSOR_DB`` env var, or a ``sensor_width_camera_database.csv``
placed next to this package. Missing database -> KeyError, and callers fall
back to the EXIF-free focal prior.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path
from typing import Dict, Optional


class SensorWidthDatabase:
    def __init__(self, csv_path: Optional[str] = None):
        candidates = []
        if csv_path:
            candidates.append(Path(csv_path))
        env = os.environ.get("DIM_TPU_SENSOR_DB")
        if env:
            candidates.append(Path(env))
        candidates.append(
            Path(__file__).resolve().parents[1] / "data" / "sensor_width_camera_database.csv"
        )
        self._db: Dict[str, float] = {}
        for cand in candidates:
            if cand.exists():
                self._load(cand)
                break

    def _load(self, path: Path) -> None:
        with open(path, newline="") as f:
            for row in csv.reader(f, delimiter=";"):
                if len(row) >= 2:
                    try:
                        self._db[_norm(row[0])] = float(row[1])
                    except ValueError:
                        continue

    def lookup(self, make: str, model: str) -> float:
        """Return sensor width in mm for a camera model string."""
        if not self._db:
            raise KeyError("No sensor-width database available")
        keys = [_norm(f"{make} {model}"), _norm(model)]
        for k in keys:
            if k in self._db:
                return self._db[k]
        # fuzzy: model tokens contained in a db key
        for k, v in self._db.items():
            if _norm(model) and _norm(model) in k:
                return v
        raise KeyError(f"Camera '{make} {model}' not in sensor database")


def _norm(s: str) -> str:
    return " ".join(str(s).lower().split())
