"""Which steps of the matching path give a row other bits when the batch it
sits in changes shape, on one CUDA card (or the CPU).

    python3 probe_batch_shapes.py [cuda|cpu]

A device mesh splits a chunk of pairs into slots of fewer rows, so a step
whose result for a row depends on how many rows run beside it cannot give
the one-device output bit for bit. Each step runs on a batch of 16 rows (4
for LoFTR) and again on slices of it (8 + 8, 6 + 6 + 4, 1 + 15, and for
RANSAC single rows), and the line says whether the rows are equal:
LightGlue's forward at full width (bf16 and f32, fixed depth and adaptive;
2048 keypoints on the card, 256 on the CPU),
kernel 5's nearest neighbours, device RANSAC (its inliers and its F, the
Hartley sums, the refit's products) and a LoFTR step (backbone, then the
whole step). Random inputs; nothing is timed.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from deep_image_matching_tpu_torch.models import lightglue as tlg  # noqa: E402
from deep_image_matching_tpu_torch.models import loftr  # noqa: E402
from deep_image_matching_tpu_torch.ops import ransac  # noqa: E402
from deep_image_matching_tpu_torch.ops.nn_match import nn_match_auto  # noqa: E402
from deep_image_matching_tpu_torch.utils.device import full_f32, to_device  # noqa: E402

B = 16
SPLITS = ([slice(0, 8), slice(8, 16)], [slice(0, 6), slice(6, 12), slice(12, 16)],
          [slice(0, 1), slice(1, 16)])


def _same(name, run, splits=SPLITS, rows=B):
    """``run(rows)`` returns a tuple of tensors; compare the whole batch's
    (``rows`` rows) with the slices' concatenated."""
    whole = run(slice(0, rows))
    for parts in splits:
        outs = [run(p) for p in parts]
        equal = [torch.equal(torch.cat([o[j] for o in outs]), whole[j])
                 for j in range(len(whole))]
        diff = max(float((torch.cat([o[j] for o in outs]).float() - whole[j].float()).abs().max())
                   for j in range(len(whole)))
        print(f"{name} {[(p.start, p.stop) for p in parts][:4]}: equal {equal}, "
              f"largest difference {diff:.3g}", flush=True)


def main() -> None:
    dev = torch.device(sys.argv[1] if len(sys.argv) > 1 else "cuda")
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    K = 256 if dev.type == "cpu" else 2048
    model = tlg.LightGlue(n_layers=9).reset_random(torch.Generator().manual_seed(1)).eval()
    model = model.to(dev)
    k0, k1 = (t(rng.uniform(0, 1024, (B, K, 2)).astype(np.float32)) for _ in range(2))
    d0 = t(rng.normal(size=(B, K, 256)).astype(np.float32))
    d1 = d0 + 0.1 * t(rng.normal(size=(B, K, 256)).astype(np.float32))
    m0 = torch.ones(B, K, dtype=torch.bool, device=dev)
    m1 = m0.clone()
    m0[:, 1900:] = False
    m1[3, 1500:] = False
    size = torch.tensor([[1024.0, 1024.0]] * B, device=dev)
    for dt in (torch.bfloat16, torch.float32):
        for dc, wc in ((-1.0, -1.0), (0.95, 0.99)):
            def lightglue(r, dt=dt, dc=dc, wc=wc):
                with full_f32():
                    o = tlg.forward(model, k0[r], k1[r], d0[r], d1[r], m0[r], m1[r], size[r],
                                    size[r], filter_threshold=0.0, compute_dtype=dt,
                                    depth_confidence=dc, width_confidence=wc)
                return o["matches0"], o["matching_scores0"], o["valid0"]
            _same(f"LightGlue {str(dt)[6:]} depth/width confidence {dc}/{wc}", lightglue)
    for mode in ("smnn", "mnn"):
        _same(f"nearest neighbours {mode}",
              lambda r, mode=mode: nn_match_auto(d0[r], d1[r], m0[r], m1[r], mode=mode,
                                                 ratio_th=0.95))

    # RANSAC on a planted translation with 30 % outliers, the same draws
    p0 = rng.uniform(0, 1000, (B, K, 2)).astype(np.float32)
    p1 = p0 + np.float32([30, -10]) + rng.normal(0, 0.5, (B, K, 2)).astype(np.float32)
    out = rng.random((B, K)) < 0.3
    p1[out] = rng.uniform(0, 1000, (out.sum(), 2))
    valid = rng.random((B, K)) < 0.6
    P0, P1, V = t(p0), t(p1), t(valid)
    u = torch.rand((B, 8, 2048), generator=torch.Generator(dev).manual_seed(0), device=dev)
    hi = V.sum(1).clamp(min=1)[:, None, None]
    draws = torch.minimum((u * hi).long(), hi - 1)
    singles = [[slice(i, i + 1) for i in range(B)]]
    _same("RANSAC (F, inliers)", lambda r: ransac.ransac_fundamental_batch(
        P0[r], P1[r], V[r], 4.0, 2048, sample_u=draws[r])[:2], SPLITS + tuple(singles))
    _same("RANSAC's Hartley sums (mean and scale)",
          lambda r: ransac._normalize_points(P0[r], V[r]))
    _same("a masked sum over the rows' points",
          lambda r: ((P0[r] * V[r].float()[..., None]).sum(1),))
    pn0, _ = ransac._normalize_points(P0, V)
    pn1, _ = ransac._normalize_points(P1, V)
    A = ransac._build_constraints(pn0, pn1) * V.float()[..., None]
    _same("RANSAC's refit product A^T A", lambda r: (torch.einsum("bni,bnj->bij", A[r], A[r]),))
    _same("RANSAC's refit from one A", lambda r: (ransac._solve_f(A[r]),))

    # LoFTR on 4 pairs of 256 x 256 crops, 2 + 2 and 1 + 1 + 1 + 1
    params = to_device(loftr.init_params(torch.Generator().manual_seed(2)), dev)
    base = rng.random((300, 300)).astype(np.float32)
    im0 = t(np.stack([base[j:j + 256, :256] for j in range(4)])[..., None])
    im1 = t(np.stack([base[j + 8:j + 264, 8:264] for j in range(4)])[..., None])
    four = ([slice(0, 2), slice(2, 4)], [slice(i, i + 1) for i in range(4)])
    with full_f32():
        _same("LoFTR backbone", lambda r: loftr.backbone_forward(
            loftr.prepare(params, torch.float32), loftr._to_unit(im0[r])), four, 4)
    _same("LoFTR step (keypoints0, keypoints1, confidence, mask)", lambda r: tuple(
        loftr.match_pair(params, im0[r], im1[r], max_matches=1024, threshold=0.0).values()),
        four, 4)


if __name__ == "__main__":
    main()
