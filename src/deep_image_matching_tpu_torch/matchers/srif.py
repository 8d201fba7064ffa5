"""SRIF matcher (port of ``deep_image_matching_tpu/matchers/srif.py``).

The upstream SRIF package is an empty placeholder and its wrapper mirrors
LoFTR's, so the preset runs the LoFTR detector-free pipeline, with a
warning, as the JAX package does.
"""

from __future__ import annotations

import logging

from .loftr import LOFTRMatcher

logger = logging.getLogger("dim_tpu_torch")


class SRIFMatcher(LOFTRMatcher):
    default_conf = dict(LOFTRMatcher.default_conf)

    def __init__(self, config: dict):
        logger.warning(
            "SRIF: the upstream implementation is an empty placeholder; "
            "running the LoFTR detector-free pipeline for API compatibility.")
        super().__init__(config)
