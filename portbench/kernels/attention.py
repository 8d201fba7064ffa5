"""Kernel 1, the masked attention of ``ops/attention.py::fused_attention``
(``csrc/attention.cu``): its operations and bytes per call, counted as the
kernel table of PERF.md counts them, over valid query rows and valid keys
only: Q K^T and P V, 4 * H * hd * rows * keys operations; Q and the output
once per valid row, K and V once per valid key. Calls in bfloat16 are
counted at the bf16 peak; a call in another dtype (the split-TF32 float32
form) makes the count inexact, and the share is left out."""

import torch

from harness.peaks import bound_s

WRAPS = ("deep_image_matching_tpu_torch.ops.attention", "fused_attention")
DEVICE_NAMES = r"attention(_hd96)?(_f32)?_sm90"


def note(args, kwargs, out):
    q, k, v, q_mask, kv_mask = args[:5]
    return (tuple(q.shape), int(k.shape[2]), q.dtype, q.device, q_mask, kv_mask)


def least_seconds(calls):
    """The least time of all ``calls`` at the published peaks, or None."""
    if not calls or any(c[2] != torch.bfloat16 for c in calls):
        return None

    def valid(mask, n, B, dev):
        return torch.full((B,), n, device=dev) if mask is None else mask.sum(1)

    counts = torch.cat([torch.stack([valid(qm, Tq, B, dev), valid(km, Tk, B, dev)]).double().cpu()
                        for (B, H, Tq, hd), Tk, _, dev, qm, km in calls], 1)
    total, at = 0.0, 0
    for (B, H, Tq, hd), *_ in calls:
        nq, nk = counts[0, at:at + B], counts[1, at:at + B]
        at += B
        ops = float((4.0 * H * hd * nq * nk).sum())
        nbytes = float((2.0 * H * hd * (2 * nq + 2 * nk)).sum())
        total += bound_s(nbytes, ops, "bf16")
    return total
