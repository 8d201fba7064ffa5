"""LighterGlue matcher (port of ``deep_image_matching_tpu/matchers/lighterglue.py``).

LightGlue at XFeat's size (``models/lightglue.py`` with 6 layers, width 96,
one head, 64-d input descriptors), run as the JAX package runs it: the fixed
depth (no adaptive exit or pruning), ``filter_threshold`` from the config,
``tpu.dtype`` (bf16 by default, or f32 under ``full_f32``), and always the
default attention route: ``tpu.attn_impl`` is not read, as the JAX matcher
does not read it. On CUDA the attention runs on kernel 1's head-dim-96 form
and the assignment on kernel 3 at width 96; the FFN takes the unfused
arithmetic (``ops/ffn.py::ffn_xla``), since the JAX package keeps its Pallas
FFN to widths that are multiples of 128. Weights: ``xfeat-lighterglue.pt``
(the ``net.`` prefix stripped) in DIM_TPU_WEIGHTS_DIR or ~/.cache/dim_tpu,
else seeded random weights under the weights policy.
"""

from __future__ import annotations

import contextlib
import logging
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ..models.lightglue import LightGlue, forward, truncate_layers
from ..utils.device import check_matcher_dtype, full_f32
from .matcher_base import BatchedMatcher

logger = logging.getLogger("dim_tpu_torch")

N_LAYERS, DIM, NUM_HEADS, INPUT_DIM = 6, 96, 1, 64
_MODEL: Optional[LightGlue] = None
_MODEL_RANDOM = False


def strip_net_prefix(state_dict: dict) -> dict:
    """The checkpoint's keys without their leading ``net.``."""
    return {(k[4:] if k.startswith("net.") else k): v for k, v in state_dict.items()}


def load_model() -> LightGlue:
    """``xfeat-lighterglue.pt`` if present, else seeded random weights (the
    weights policy decides); cached random weights re-consult the policy."""
    global _MODEL, _MODEL_RANDOM
    from ..utils.weights import missing_weights, reject_cached_random

    if _MODEL is not None:
        if _MODEL_RANDOM:
            reject_cached_random("LighterGlue", ["xfeat-lighterglue.pt"])
        return _MODEL
    model = LightGlue(n_layers=N_LAYERS, dim=DIM, num_heads=NUM_HEADS, input_dim=INPUT_DIM)
    wdir = os.environ.get("DIM_TPU_WEIGHTS_DIR")
    for base in ([Path(wdir)] if wdir else []) + [Path.home() / ".cache/dim_tpu"]:
        cand = base / "xfeat-lighterglue.pt"
        if cand.exists():
            sd = strip_net_prefix(torch.load(str(cand), map_location="cpu"))
            model.load_state_dict(truncate_layers(sd, N_LAYERS))
            logger.info(f"Loaded LighterGlue weights from {cand}")
            _MODEL = model.eval()
            return _MODEL
    missing_weights("LighterGlue", ["xfeat-lighterglue.pt"])
    _MODEL = model.reset_random(torch.Generator().manual_seed(11)).eval()
    _MODEL_RANDOM = True
    return _MODEL


class LighterGlueMatcher(BatchedMatcher):
    default_conf = {
        "filter_threshold": 0.1,
    }

    def __init__(self, config: dict):
        super().__init__(config)
        self.filter_threshold = float(self.conf.get("filter_threshold", 0.1))
        self.compute_dtype = check_matcher_dtype(
            self.device, getattr(torch, str(self.tpu.get("dtype", "bfloat16"))))
        self.model = load_model().to(self.device)

    def _match_batch_arrays(
        self, batch0: Dict[str, torch.Tensor], batch1: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        with full_f32() if self.compute_dtype == torch.float32 else contextlib.nullcontext():
            out = forward(
                self.model,
                batch0["keypoints"], batch1["keypoints"],
                batch0["descriptors"], batch1["descriptors"],
                batch0["mask"], batch1["mask"],
                batch0["image_size"].float(), batch1["image_size"].float(),
                filter_threshold=self.filter_threshold,
                compute_dtype=self.compute_dtype,
            )
        return out["matches0"], out["valid0"]
