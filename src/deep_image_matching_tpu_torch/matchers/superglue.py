"""SuperGlue matcher (port of ``deep_image_matching_tpu/matchers/superglue.py``).

The reference's config surface: ``weights`` (indoor / outdoor, read from
``superglue_{weights}.pth``), ``match_threshold`` and
``sinkhorn_iterations``. Each pair batch runs one
``models/superglue.py::forward`` on the device in ``tpu.dtype`` (bf16 by
default, or f32; on CUDA the attention and FFN kernels take those two, so
another dtype fails at start; f32 runs under ``full_f32``, so no global TF32
setting lowers its plain products), with the folded parameters (and in f32
the FFN weights' TF32 halves) made once at start, and once per other device
of a device mesh.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch

from ..models.superglue import forward, load_default_model
from ..utils.device import check_matcher_dtype, full_f32, to_device
from .matcher_base import BatchedMatcher


class SuperGlueMatcher(BatchedMatcher):
    default_conf = {
        "weights": "outdoor",
        "match_threshold": 0.3,
        "sinkhorn_iterations": 100,
    }

    def __init__(self, config: dict):
        super().__init__(config)
        self.sinkhorn_iterations = int(self.conf.get("sinkhorn_iterations", 100))
        self.match_threshold = float(self.conf.get("match_threshold", 0.3))
        self.compute_dtype = check_matcher_dtype(
            self.device, getattr(torch, str(self.tpu.get("dtype", "bfloat16"))))
        self.model = load_default_model(str(self.conf.get("weights", "outdoor"))).to(self.device)
        # BatchNorm folded and weights cast once, not per pair batch
        self.params = self.model.folded_params(self.compute_dtype)

    def _move_weights(self, device: torch.device) -> None:
        # ``forward`` reads its tensors from the folded parameters; the
        # module gives it only the shapes
        self.params = to_device(self.params, device)

    def _match_batch_arrays(
        self, batch0: Dict[str, torch.Tensor], batch1: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        with full_f32() if self.compute_dtype == torch.float32 else contextlib.nullcontext():
            out = forward(
                self.model,
                batch0["keypoints"], batch1["keypoints"],
                batch0["scores"], batch1["scores"],
                batch0["descriptors"], batch1["descriptors"],
                batch0["mask"], batch1["mask"],
                batch0["image_size"].float(), batch1["image_size"].float(),
                sinkhorn_iterations=self.sinkhorn_iterations,
                match_threshold=self.match_threshold,
                compute_dtype=self.compute_dtype,
                params=self.params,
            )
        return out["matches0"], out["valid0"]
