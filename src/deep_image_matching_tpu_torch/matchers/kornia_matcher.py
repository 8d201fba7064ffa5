"""Nearest-neighbour descriptor matcher (port of
``deep_image_matching_tpu/matchers/kornia_matcher.py``).

The registry keeps the reference's ``kornia_matcher`` name and config
surface (``match_mode`` nn / mnn / snn / smnn, Lowe ratio ``th``). Each pair
batch is one ``ops/nn_match.py::nn_match_auto`` call over the device store's
(B, K, D) f32 descriptors and masks: on CUDA the kernel route (kernel 5,
twice for the mutual modes), on the CPU the dense distance matrix.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..ops.nn_match import nn_match_auto
from .matcher_base import BatchedMatcher


class NNMatcher(BatchedMatcher):
    default_conf = {
        "match_mode": "smnn",
        "th": 0.95,
    }

    def _match_batch_arrays(
        self, batch0: Dict[str, torch.Tensor], batch1: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return nn_match_auto(
            batch0["descriptors"], batch1["descriptors"], batch0["mask"], batch1["mask"],
            mode=str(self.conf["match_mode"]), ratio_th=float(self.conf["th"]),
        )
