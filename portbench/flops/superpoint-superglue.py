"""Model FLOPs of one superpoint-superglue job at the bf16 peak:
SuperPoint's convolutions at each image's size, SuperGlue's keypoint
encoder, its 18 propagation layers and its final projection at the
keypoints written to features.h5. Sinkhorn's iterations are exponentials
and sums read from memory, not products: they add no FLOPs here, and
their share of the card shows in ``sinkhorn_roofline``."""

import importlib.util
from pathlib import Path

from harness.peaks import PEAK_RATE

_spec = importlib.util.spec_from_file_location("portbench_flops_common",
                                               Path(__file__).with_name("_common.py"))
_common = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_common)

KENC = (3, 32, 64, 128, 256)


def superglue_pair(n0: int, n1: int, blocks: int = 9, dim: int = 256) -> float:
    """Per side and propagation layer the q, k, v and merge projections and
    the MLP (20 n dim^2) and the attention products (4 n m dim, m the
    source's points); the encoder; the final projection and similarity."""
    enc = sum(2.0 * a * b for a, b in zip(KENC[:-1], KENC[1:])) * (n0 + n1)
    self_ = 20.0 * dim * dim * (n0 + n1) + 4.0 * dim * (n0 * n0 + n1 * n1)
    cross = 20.0 * dim * dim * (n0 + n1) + 8.0 * dim * n0 * n1
    head = 2.0 * dim * dim * (n0 + n1) + 2.0 * dim * n0 * n1
    return enc + blocks * (self_ + cross) + head


def least_seconds(images, pairs, config) -> float:
    sp = sum(_common.superpoint(h, w) for h, w in images)
    sg = sum(superglue_pair(n0, n1) for n0, n1 in pairs)
    return (sp + sg) / PEAK_RATE["bf16"]
