"""LightGlue matcher (port of ``deep_image_matching_tpu/matchers/lightglue.py``).

The config surface is the reference's (n_layers, depth_confidence,
width_confidence, filter_threshold; ``mp`` and ``flash`` are accepted and
ignored). Each pair batch runs one ``models/lightglue.py::forward`` on the
device in ``tpu.dtype`` (bf16 by default, or f32; on CUDA the kernels take
those two, so another dtype fails at start; f32 runs under ``full_f32``,
so no global TF32 setting lowers its plain products). With the default
0.95 / 0.99 the
adaptive path runs: the batch exits once every pair is token-confident, and
confident-but-unmatchable points are masked out of later layers.

``tpu.attn_impl`` is read as the JAX package reads it: "bidir" runs the
cross attention on the shared-score bidirectional kernel; "flash", "xla" and
the default keep two attention calls (the JAX package's two XLA routes have
one counterpart here); any other value raises. ``tpu.ffn_impl`` ("auto",
the default, "fused" or "xla") is resolved as the JAX package resolves it:
"auto" is the fused kernel under "flash" or "bidir" attention and the JAX
package's unfused arithmetic under "xla". ``tpu.assignment_impl`` is
"fused" (kernel 3, the default) or "dense" (the (B, M, N) log assignment).
Any other value of either raises. ``DIM_TPU_FUSED_PROLOGUE=1`` fuses the
attention prologue (``models/lightglue.py``).

On a device mesh the chunk's slots run as one batch through
``forward_shards`` (each slot on its device's copy of the model, made once),
so the depth exit is decided over every pair of the chunk, as on one device.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, Tuple

import torch

from ..models.lightglue import (check_assignment_impl, check_attn_impl, forward_shards,
                                load_default_model, resolve_ffn_impl)
from ..utils.device import check_matcher_dtype, full_f32
from .matcher_base import BatchedMatcher


class LightGlueMatcher(BatchedMatcher):
    default_conf = {
        "n_layers": 9,
        "mp": False,
        "flash": True,
        "depth_confidence": 0.95,
        "width_confidence": 0.99,
        "filter_threshold": 0.1,
        "features": "superpoint",
    }

    def __init__(self, config: dict):
        super().__init__(config)
        self.n_layers = int(self.conf.get("n_layers", 9))
        self.filter_threshold = float(self.conf.get("filter_threshold", 0.1))
        self.depth_confidence = float(self.conf.get("depth_confidence", -1))
        self.width_confidence = float(self.conf.get("width_confidence", -1))
        self.compute_dtype = check_matcher_dtype(
            self.device, getattr(torch, str(self.tpu.get("dtype", "bfloat16"))))
        self.attn_impl = check_attn_impl(str(self.tpu.get("attn_impl", "flash")))
        self.ffn_impl = resolve_ffn_impl(str(self.tpu.get("ffn_impl", "auto")), self.attn_impl)
        self.assignment_impl = check_assignment_impl(
            str(self.tpu.get("assignment_impl", "fused")))
        self.model = load_default_model(
            str(self.conf.get("features", "superpoint")), self.n_layers
        ).to(self.device)

    def _move_weights(self, device: torch.device) -> None:
        self.model = copy.deepcopy(self.model).to(device)
        self.model._prologue.clear()

    def _match_batch_arrays(
        self, batch0: Dict[str, torch.Tensor], batch1: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._match_shards([(self.device, batch0, batch1)], None)[0]

    def _match_shards(self, shards, n_real) -> list:
        with full_f32() if self.compute_dtype == torch.float32 else contextlib.nullcontext():
            outs = forward_shards(
                [(self._replica(dev).model,
                  b0["keypoints"], b1["keypoints"], b0["descriptors"], b1["descriptors"],
                  b0["mask"], b1["mask"], b0["image_size"].float(), b1["image_size"].float())
                 for dev, b0, b1 in shards],
                n_real,
                filter_threshold=self.filter_threshold,
                depth_confidence=self.depth_confidence,
                width_confidence=self.width_confidence,
                compute_dtype=self.compute_dtype,
                attn_impl=self.attn_impl,
                ffn_impl=self.ffn_impl,
                assignment_impl=self.assignment_impl,
            )
        return [(out["matches0"], out["valid0"]) for out in outs]
