"""HDF5 writers of the match and extraction stages.

``MatchWriter`` keeps raw_matches.h5 and matches.h5 open for a whole match
stage; ``AsyncFeatureWriter`` moves features.h5 writes to one background
thread so extraction batches overlap the host-side file work, and takes
whole batches still on the device (``put_device_batch``: the deferred write
of the extract -> match handoff, one device -> host copy of the f16 batch
on the writer thread while matching runs). Both write through
``io/hdf5.py``, which appends each dataset to the file as it is created and
writes the group indexes on close. The writer thread's items are ``write``
spans, its wait for a download ``sync.download``, and a ``put`` that blocks
on the full queue ``wait.writer`` (``utils/profiler.py``).
"""

from __future__ import annotations

import logging
import queue
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.profiler import span
from . import hdf5
from .h5 import write_features

logger = logging.getLogger("dim_tpu_torch")


class MatchWriter:
    """Persistent-handle writer for ``raw_matches.h5`` + ``matches.h5``.

    ``save_matches`` opens and closes the file per call; this writer keeps
    both files open for the duration of a match stage (single-threaded), so
    their group indexes are written once, at the end. The per-pair dataset
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


class _DeviceBatch:
    """One extraction batch for the writer: host keypoints (n, K, 2), counts
    and image sizes (and ``tile_idx`` (n, K) where tiled), the f16
    descriptors (n, K, D) and scores (n, K) still on the device, and the
    event after which they are complete (None on the CPU)."""

    def __init__(self, names, kpts, desc_f16, scores_f16, image_size, counts, tile_idx,
                 ready):
        self.names = list(names)
        self.kpts, self.desc_f16, self.scores_f16 = kpts, desc_f16, scores_f16
        self.image_size, self.counts, self.tile_idx = image_size, counts, tile_idx
        self.ready = ready


_DOWNLOAD_STREAMS = {}


def _download(t, ready) -> np.ndarray:
    """A device tensor on the host. On CUDA the copy runs on a stream of its
    own, after ``ready`` (not behind the match stage's kernels queued since),
    into pinned memory, and this thread waits for it."""
    import torch

    if not t.is_cuda:
        return t.numpy()
    stream = _DOWNLOAD_STREAMS.get(t.device)
    if stream is None:
        stream = _DOWNLOAD_STREAMS.setdefault(t.device, torch.cuda.Stream(device=t.device))
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with torch.cuda.device(t.device), torch.cuda.stream(stream):
        if ready is not None:
            stream.wait_event(ready)
        host.copy_(t, non_blocking=True)
    with span("sync.download"):
        stream.synchronize()
    return host.numpy()


class AsyncFeatureWriter:
    """features.h5 writes on one background thread; ``close()`` joins it,
    closes the file and re-raises any error of the thread."""

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
                with span("write"):
                    if isinstance(item, _DeviceBatch):
                        self._write_device_batch(fd, item)
                    else:
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

    @staticmethod
    def _write_device_batch(fd, b: _DeviceBatch) -> None:
        """A whole batch: one device -> host copy each of the f16
        descriptors and scores (the values ``write_features`` would store),
        then one group per image, trimmed to its count."""
        desc, scores = _download(b.desc_f16, b.ready), _download(b.scores_f16, b.ready)
        for i, name in enumerate(b.names):
            write_features(fd, name, keypoints=b.kpts[i], descriptors=desc[i],
                           scores=scores[i],
                           tile_idx=None if b.tile_idx is None else b.tile_idx[i],
                           image_size=b.image_size[i], n_valid=int(b.counts[i]))

    def put(self, name: str, **arrays) -> None:
        if self._error is not None:
            raise RuntimeError("Async writer failed earlier") from self._error
        with span("wait.writer"):
            self._q.put({"name": name, **arrays})

    def put_device_batch(self, names, kpts, desc_f16, scores_f16, image_size, counts,
                         tile_idx=None, ready=None) -> None:
        """Queue one whole batch whose descriptors and scores are still on the
        device (f16); the writer thread copies them to the host once. Each
        queued batch holds its device tensors until written."""
        if self._error is not None:
            raise RuntimeError("Async writer failed earlier") from self._error
        batch = _DeviceBatch(names, kpts, desc_f16, scores_f16, image_size, counts, tile_idx,
                             ready)
        with span("wait.writer"):
            self._q.put(batch)

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
