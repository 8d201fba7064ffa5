"""Device mesh: the rows of a batch split over a list of devices (port of
``deep_image_matching_tpu/parallel/mesh.py``).

The JAX package shards the batch axis of one program over a 1-D device mesh
(GSPMD) and replicates the weights, so every decision that covers the batch
covers every shard at once. Here each mesh slot runs its share of the rows
on its own device, launched one slot after the other (launches are
asynchronous, so slots on distinct devices overlap), and the callers take
those decisions over the whole batch: LightGlue's depth exit
(``models/lightglue.py::forward_shards``), device RANSAC's and AdaLAM's
draws. A sharded batch gives the one-device output bit for bit.

- ``MeshRunner(devices)``: a device may appear more than once (one card
  named twice runs two slots on it); a CUDA device that is not visible
  raises.
- ``pad_batch``: rows up to a multiple of the mesh size, the last row
  repeated (callers trim: padding rows are never written); ``slots`` gives
  each slot its device and its slice of the padded rows, ``shard`` moves
  each slice to its slot's device.
- ``replicate``: one copy of a tree per distinct device, the tree itself on
  its own device (``cuda:0`` named twice holds one copy); the caller keeps
  the copies for as long as it runs.
- ``gather``: the slots' results in row order on one device, padding
  trimmed.

``_DEFAULT_MESH``, where set, is the mesh of every run: tests and
``chip_smoke.py`` inject a device list there, as the JAX package's tests do.
Otherwise ``get_default_mesh(tpu)`` takes the devices that
``general.tpu.mesh_devices`` and ``general.tpu.device`` name
(``mesh_devices``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device, to_device

_DEFAULT_MESH: Optional["MeshRunner"] = None


def _visible(dev: torch.device) -> torch.device:
    """``dev`` with its CUDA index filled in; raise if it is not visible."""
    if dev.type != "cuda":
        return dev
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    index = 0 if dev.index is None else dev.index
    if index >= count:
        raise RuntimeError(f"mesh device cuda:{index} is missing: {count} CUDA device(s) visible")
    return torch.device("cuda", index)


class MeshRunner:
    def __init__(self, devices: Sequence):
        self.devices: List[torch.device] = [_visible(torch.device(d)) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> List[torch.device]:
        """The mesh's devices, each once, in mesh order."""
        return list(dict.fromkeys(self.devices))

    def padded(self, n: int) -> int:
        """``n`` rows rounded up to a multiple of the mesh size."""
        return -(-n // self.n_devices) * self.n_devices

    def pad_batch(self, batch):
        """An array or tensor, or a dict of them, padded along the first axis
        to a multiple of the mesh size by repeating the last row."""
        if isinstance(batch, dict):
            return {k: self.pad_batch(v) for k, v in batch.items()}
        n = batch.shape[0]
        extra = self.padded(n) - n
        if extra == 0:
            return batch
        if isinstance(batch, torch.Tensor):
            return torch.cat([batch, batch[-1:].expand(extra, *batch.shape[1:])])
        return np.concatenate([batch, np.repeat(batch[-1:], extra, axis=0)])

    def slots(self, n: int) -> List[Tuple[torch.device, slice]]:
        """Each slot's device and its slice of ``n`` rows padded."""
        per = self.padded(n) // self.n_devices
        return [(d, slice(i * per, (i + 1) * per)) for i, d in enumerate(self.devices)]

    def real_rows(self, n: int) -> List[int]:
        """How many of each slot's rows are real (not padding)."""
        return [max(0, min(s.stop, n) - s.start) for _, s in self.slots(n)]

    def shard(self, x) -> list:
        """``x`` (an array or tensor) padded, one slice per slot on the
        slot's device."""
        x = self.pad_batch(x)
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return [x[s].to(d) for d, s in self.slots(x.shape[0])]

    def replicate(self, tree, home: torch.device,
                  copy: Callable = to_device) -> Dict[torch.device, object]:
        """``tree`` (living on ``home``) on every distinct mesh device: the
        tree itself on ``home``, elsewhere ``copy(tree, device)``."""
        return {d: tree if d == home else copy(tree, d) for d in self.distinct}

    @staticmethod
    def gather(parts: Sequence[torch.Tensor], n: int, device: torch.device) -> torch.Tensor:
        """The slots' row blocks concatenated in slot order on ``device``,
        trimmed to the ``n`` real rows."""
        return torch.cat([p.to(device) for p in parts])[:n]


def mesh_devices(tpu: Optional[dict] = None) -> List[torch.device]:
    """The devices of ``general.tpu``'s mesh. ``mesh_devices`` None (the
    default): every visible CUDA device where ``device`` is "auto" or
    "cuda" (raising without one), else the one device ``device`` names
    ("cuda:N", "cpu"), so one card keeps its one-device path. An integer N:
    the first N CUDA devices, raising when fewer are visible or when
    ``device`` asks for the CPU."""
    tpu = tpu or {}
    spec = tpu.get("device", "auto")
    n = tpu.get("mesh_devices")
    if n is None:
        if spec is None or str(spec).lower() in ("auto", "cuda"):
            resolve_device(spec)
            return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return [resolve_device(spec)]
    if isinstance(n, bool) or not isinstance(n, (int, np.integer)) or n < 1:
        raise ValueError(f"tpu.mesh_devices must be a positive integer or null, not {n!r}")
    if resolve_device(spec).type != "cuda":
        raise ValueError(f"tpu.mesh_devices: {n} counts CUDA devices, but tpu.device is {spec!r}")
    if torch.cuda.device_count() < n:
        raise RuntimeError(f"tpu.mesh_devices: {n}, but {torch.cuda.device_count()} CUDA "
                           "device(s) are visible")
    return [torch.device("cuda", i) for i in range(int(n))]


def get_default_mesh(tpu: Optional[dict] = None) -> MeshRunner:
    """``_DEFAULT_MESH`` where set, else the mesh of ``general.tpu``
    (``mesh_devices``)."""
    if _DEFAULT_MESH is not None:
        return _DEFAULT_MESH
    return MeshRunner(mesh_devices(tpu))
