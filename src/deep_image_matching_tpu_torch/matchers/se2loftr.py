"""SE2-LoFTR detector-free matcher (port of
``deep_image_matching_tpu/matchers/se2loftr.py``).

LoFTR with the C8 rotation-equivariant backbone in its exported form
(``models/se2loftr.py``). Weights: ``8rot.ckpt`` or ``se2loftr_8rot.ckpt``
(e2cnn modules, expanded at load in numpy) or ``se2loftr_8rot_exported.pth``
or ``8rot_exported.ckpt`` (exported) from DIM_TPU_WEIGHTS_DIR or
~/.cache/dim_tpu. With them, every batch runs the SE2 backbone, and only
that checkpoint is loaded. Without one the weights policy applies: the
strict policy raises; under ``allow_random_weights`` the matcher warns and
runs standard LoFTR (its checkpoint or random weights), as the JAX package
does. The configuration keys are LoFTR's.
"""

from __future__ import annotations

import logging

from ..models import se2loftr as se2_model
from ..utils.weights import find_checkpoint, missing_weights
from .loftr import LOFTRMatcher, cached_load

logger = logging.getLogger("dim_tpu_torch")

SE2_NAMES = ["8rot.ckpt", "se2loftr_8rot.ckpt", "se2loftr_8rot_exported.pth",
             "8rot_exported.ckpt"]


def load_se2_params():
    """SE2-LoFTR's parameters on the CPU from its checkpoint, or None."""
    path = find_checkpoint(SE2_NAMES)
    return None if path is None else cached_load(path, se2_model.params_from_torch)


class SE2LOFTRMatcher(LOFTRMatcher):
    default_conf = dict(LOFTRMatcher.default_conf)

    def _load_model(self):
        params = load_se2_params()
        if params is not None:
            return params, self._se2_batch
        missing_weights(
            "SE2-LoFTR", ["8rot.ckpt", "se2loftr_8rot_exported.pth"],
            note="The published 8rot.ckpt converts directly (the e2cnn C8 basis "
                 "expansion runs at load time in numpy).")
        logger.warning("se2loftr: running standard LoFTR instead "
                       "(use --upright for rotated imagery).")
        return super()._load_model()

    def _se2_batch(self, params, img0, img1):
        return se2_model.match_pair(
            params, img0, img1, max_matches=self.max_matches, threshold=self.match_threshold,
            compute_dtype=self.compute_dtype, coarse_impl=self.coarse_impl,
            temperature=self.temperature)
