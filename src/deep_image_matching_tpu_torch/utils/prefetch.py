"""Threaded decode -> upload prefetch for the extraction batches (port of
``deep_image_matching_tpu/utils/prefetch.py``, without its device image
cache: no stage of the port reads an image twice).

A pool of ``WORKERS`` threads decodes and resizes each image (OpenCV
releases the GIL) and uploads it to the device as soon as it is ready, at
most ``DEPTH`` images ahead of the consumer, so decoding, uploads and the
model overlap while the device holds only the images in flight. On CUDA an
upload runs on a side stream from pinned host memory and records an event;
the consumer's stream waits on that event on the device, not on the host.
Each image's decode is a ``decode`` span on its worker thread, and the
consumer's block on the pool a ``wait.decode`` span (``utils/profiler.py``).
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

from .image import Image, read_image
from .profiler import span

WORKERS = 4
DEPTH = 8

_POOL = None
_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}
_LOCK = threading.Lock()


def _pool() -> ThreadPoolExecutor:
    global _POOL
    with _LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(max_workers=WORKERS, thread_name_prefix="dim-decode")
        return _POOL


def _upload_stream(device: torch.device) -> "torch.cuda.Stream":
    with _LOCK:
        if device not in _STREAMS:
            _STREAMS[device] = torch.cuda.Stream(device=device)
        return _STREAMS[device]


def upload(host_array: np.ndarray, device: torch.device):
    """One host array on ``device`` -> (tensor, the copy's event or None).
    On CUDA: staged in pinned memory (a fresh buffer each time; the caching
    host allocator keeps a buffer until the copy that reads it has
    finished) and copied without blocking on the device's upload stream."""
    device = torch.device(device)
    src = torch.from_numpy(np.ascontiguousarray(host_array))
    if device.type != "cuda":
        return src.to(device), None
    pinned = src.pin_memory()
    stream = _upload_stream(device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        dev = pinned.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return dev, event


def _take(tensor: torch.Tensor, event) -> torch.Tensor:
    """The uploaded tensor for use on the calling thread's current stream:
    the stream waits for the copy and the tensor's memory is marked in use
    by it."""
    if event is not None:
        stream = torch.cuda.current_stream(tensor.device)
        stream.wait_event(event)
        tensor.record_stream(stream)
    return tensor


def prefetch_device_images(images: Sequence[Image], grayscale: bool,
                           resize_fn: Callable[[np.ndarray], np.ndarray], device: torch.device,
                           ) -> Iterator[Tuple[torch.Tensor, Tuple[int, int], Tuple[int, int]]]:
    """Yield, in order, each image decoded, resized (``resize_fn``) and on
    ``device`` as (uint8 tensor, (cur_h, cur_w), (w0, h0)): the resized
    size and the file's. The pool works at most ``DEPTH`` images ahead; a
    failure in a worker raises here, and closing the generator cancels the
    work not yet started."""
    device = torch.device(device)

    def task(img: Image):
        with span("decode"):
            arr = read_image(img.path, grayscale=grayscale)
            h0, w0 = arr.shape[:2]
            arr = resize_fn(arr)
            return upload(arr, device), tuple(arr.shape[:2]), (w0, h0)

    todo = iter(images)
    pending = deque(_pool().submit(task, img) for img in itertools.islice(todo, DEPTH))
    try:
        while pending:
            with span("wait.decode"):
                (tensor, event), cur_hw, orig_wh = pending.popleft().result()
            for img in itertools.islice(todo, 1):
                pending.append(_pool().submit(task, img))
            yield _take(tensor, event), cur_hw, orig_wh
    finally:
        for fut in pending:
            fut.cancel()
