"""Model FLOPs of one superpoint-lightglue job, each part at the peak of
the precision it runs in on the card: SuperPoint's convolutions at each
image's size and LightGlue at the keypoints written to features.h5, both
bf16 (the extractor's and the matcher's compute dtype on CUDA). LightGlue
is counted at the depth the plain reference takes on these inputs (the
configuration's ``counted_layers``, every layer) over every keypoint: with
the seeded token-confidence heads at zero neither the depth exit nor the
width pruning fires. One shared similarity in each cross block, as the
published model computes it."""

import importlib.util
from pathlib import Path

from harness.peaks import PEAK_RATE

_spec = importlib.util.spec_from_file_location("portbench_flops_common",
                                               Path(__file__).with_name("_common.py"))
_common = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_common)


def lightglue_pair(n0: int, n1: int, layers: int, dim: int = 256) -> float:
    """Per layer and side the self block (QKV, out and FFN projections
    20 n dim^2; its two attention products 4 n^2 dim) and the cross block's
    projections (18 n dim^2); the cross block's shared similarity and two
    value products (6 n0 n1 dim); the last layer's assignment head
    (2 dim^2 (n0 + n1) + 2 n0 n1 dim)."""
    layer = 38.0 * dim * dim * (n0 + n1) + 4.0 * dim * (n0 * n0 + n1 * n1) + 6.0 * dim * n0 * n1
    return layers * layer + 2.0 * dim * dim * (n0 + n1) + 2.0 * dim * n0 * n1


def least_seconds(images, pairs, config) -> float:
    """``images``: (h, w) of each image extracted; ``pairs``: (n0, n1)
    keypoints of each pair matched."""
    layers = int(config["counted_layers"])
    sp = sum(_common.superpoint(h, w) for h, w in images)
    lg = sum(lightglue_pair(n0, n1, layers) for n0, n1 in pairs)
    return (sp + lg) / PEAK_RATE["bf16"]
