"""HDF5 writers of the match and extraction stages.

``MatchWriter`` keeps raw_matches.h5 and matches.h5 open for a whole match
stage; ``AsyncFeatureWriter`` moves features.h5 writes to one background
thread so extraction batches overlap the host-side file work. Both write
through ``io/hdf5.py``, which builds a file in memory and writes it once on
close.
"""

from __future__ import annotations

import logging
import queue
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from . import hdf5
from .h5 import write_features

logger = logging.getLogger("dim_tpu_torch")


class MatchWriter:
    """Persistent-handle writer for ``raw_matches.h5`` + ``matches.h5``.

    ``save_matches`` opens, rebuilds and closes the file per call; this
    writer keeps both files open for the duration of a match stage
    (single-threaded) and writes each once at the end. The per-pair dataset
    semantics are identical to ``save_matches`` (group per first image,
    overwrite-on-rewrite)."""

    def __init__(self, matches_path):
        self.matches_path = Path(matches_path)
        self.raw_path = self.matches_path.parent / "raw_matches.h5"
        self._files = {}

    def _fd(self, path) -> "hdf5.File":
        key = str(path)
        fd = self._files.get(key)
        if fd is None:
            fd = hdf5.File(key, "a")
            self._files[key] = fd
        return fd

    @staticmethod
    def _write(fd, name0: str, name1: str, matches) -> None:
        matches = np.asarray(matches, dtype=np.int32).reshape(-1, 2)
        grp = fd.require_group(name0)
        if name1 in grp:
            del grp[name1]
        grp.create_dataset(name1, data=matches)

    def save_raw(self, name0: str, name1: str, matches) -> None:
        self._write(self._fd(self.raw_path), name0, name1, matches)

    def save_verified(self, name0: str, name1: str, matches) -> None:
        self._write(self._fd(self.matches_path), name0, name1, matches)

    def close(self) -> None:
        for fd in self._files.values():
            fd.close()
        self._files.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class AsyncFeatureWriter:
    """features.h5 writes on one background thread; ``close()`` joins it,
    writes the file and re-raises any error of the thread."""

    def __init__(self, feature_path, maxsize: int = 32):
        self.feature_path = feature_path
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        fd = None
        try:
            fd = hdf5.File(self.feature_path, "a")
            while True:
                item = self._q.get()
                if item is None:
                    return
                write_features(fd, **item)
        except Exception as e:  # surfaced at close()
            self._error = e
            logger.error(f"Async feature write failed: {e}")
            while self._q.get() is not None:  # drain so put() never blocks
                pass
        finally:
            if fd is not None:
                try:
                    fd.close()
                except Exception as e:
                    self._error = self._error or e

    def put(self, name: str, **arrays) -> None:
        if self._error is not None:
            raise RuntimeError("Async writer failed earlier") from self._error
        self._q.put({"name": name, **arrays})

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        if self._error is not None:
            raise RuntimeError("Async feature write failed") from self._error

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
