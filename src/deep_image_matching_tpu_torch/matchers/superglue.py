"""SuperGlue matcher (port of ``deep_image_matching_tpu/matchers/superglue.py``).

The reference's config surface: ``weights`` (indoor / outdoor, read from
``superglue_{weights}.pth``), ``match_threshold`` and
``sinkhorn_iterations``. Each pair batch runs one
``models/superglue.py::forward`` on the device in ``tpu.dtype`` (bf16 by
default; on CUDA the attention and FFN kernels take bf16 only, so another
dtype fails at start), with the folded parameters made once at start.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.superglue import forward, load_default_model
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
        self.compute_dtype = getattr(torch, str(self.tpu.get("dtype", "bfloat16")))
        if self.device.type == "cuda" and self.compute_dtype != torch.bfloat16:
            raise ValueError(
                f"tpu.dtype {self.compute_dtype} on CUDA: the attention and FFN "
                "kernels take bfloat16 (float32 runs on the CPU only)"
            )
        self.model = load_default_model(str(self.conf.get("weights", "outdoor"))).to(self.device)
        # BatchNorm folded and weights cast once, not per pair batch
        self.params = self.model.folded_params(self.compute_dtype)

    def _match_batch_arrays(
        self, batch0: Dict[str, torch.Tensor], batch1: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
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
