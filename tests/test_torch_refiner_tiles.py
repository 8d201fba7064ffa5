"""The row-streaming algorithm of kernel 9 (csrc/refiner.cu, RoMa's depthwise
refiner stack) against the JAX package's Pallas kernel in interpret mode and
XLA's convolutions, on the CPU.

The CUDA kernel runs only on the card (tests/test_torch_cuda.py holds it
against its plain version there). What can be checked here is the algorithm
it implements, which ``model_stack`` follows step by step: one launch a
block, each over work units of a strip of Wt output columns and a band of Hb
rows (``refiner_plan``) that read Wt + 4 columns from 2 rows above the band,
zeros outside the image; at step s the unit takes its input row s into four
running sums per column (its open output rows); each finished row + b1,
ReLU, split into TF32 halves (hi = rna_tf32(h), lo = rna_tf32(h - hi)) and
mixed by the 1x1 a step later as (lo.hi + hi.lo) + hi.hi over 8-deep slices
of the channels.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from deep_image_matching_tpu.ops.pallas_refiner import refiner_dw_stack as jax_refiner
from deep_image_matching_tpu_torch.ops import refiner as trefiner

SMS = 132  # the H100's SMs, as the wrapper reads them from the card


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: f32 rounded to 10 mantissa bits, ties away from
    zero (the low 13 bits of the word cleared)."""
    bits = x.float().contiguous().numpy().view(np.uint32)
    return torch.from_numpy(((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32))


def split_mix(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h (P, C) . w (C, C) as the kernel's mma.sync k-steps of 8 channels:
    the lo terms (lo.hi, then hi.lo) and hi.hi in two f32 accumulators,
    summed at the end."""
    hh, wh = rna_tf32(h), rna_tf32(w)
    hl, wl = rna_tf32(h - hh), rna_tf32(w - wh)
    lo = torch.zeros(h.shape[0], w.shape[1])
    hi = torch.zeros(h.shape[0], w.shape[1])
    for k in range(0, h.shape[1], 8):
        ks = slice(k, k + 8)
        lo = lo + hl[:, ks] @ wh[ks]
        lo = lo + hh[:, ks] @ wl[ks]
        hi = hi + hh[:, ks] @ wh[ks]
    return lo + hi


def model_block(x, w1, b1, w2, b2, Wt, Hb, zero_fill=True):
    """One launch (one block) over every work unit, as the kernel streams
    it. x (B, H, W, C) f32; w1 (5, 5, 1, C), b1 (C), w2 (1, 1, C, C), b2 (C):
    the block's slices of the stack's weights."""
    B, H, W, C = x.shape
    assert Wt <= min(trefiner.MAXI * (trefiner.THREADS // C), trefiner.MAX_BOX - 4)
    y = torch.empty_like(x)
    for b in range(B):
        for Y0 in range(0, H, Hb):
            for X0 in range(0, W, Wt):
                _model_unit(x[b], w1.reshape(5, 5, C), b1, w2.reshape(C, C), b2, y[b], X0, Y0,
                            min(Hb, H - Y0), Wt, zero_fill)
    return y


def _model_unit(xb, taps, b1, mix, b2, yb, X0, Y0, Hr, Wt, zero_fill):
    H, W, C = xb.shape
    acc = torch.zeros(4, Wt, C)  # the open output rows i - 4 .. i - 1
    done = None  # the row the depthwise finished at the step before

    def image_row(j):
        """Input row j: image row Y0 - 2 + j, columns X0 - 2 .. X0 + Wt + 1,
        zeros outside the image (TMA's fill); without ``zero_fill`` the
        nearest image pixel (a clamped load)."""
        gx = torch.arange(Wt + 4) + X0 - 2
        gy = Y0 - 2 + j
        out = xb[min(max(gy, 0), H - 1), gx.clamp(0, W - 1)].clone()
        if zero_fill:
            out[(gx < 0) | (gx >= W) | (not 0 <= gy < H)] = 0.0
        return out

    for s in range(Hr + 5):
        finished = None
        if s < Hr + 4:
            src = image_row(s)
            # input row s: tap row dy = s - o of output rows o = s - 4 .. s
            part = [sum(taps[dy, dx] * src[dx:dx + Wt] for dx in range(5)) for dy in range(5)]
            out = acc[0] + part[4]
            acc = torch.stack([acc[j + 1] + part[3 - j] for j in range(3)] + [part[0]])
            if s >= 4:
                finished = (s - 4, torch.relu(out + b1))
        if done is not None:
            o, h = done
            n = min(Wt, W - X0)
            yb[Y0 + o, X0:X0 + n] = (split_mix(h, mix) + b2)[:n]
        done = finished


def model_stack(x, w1, b1, w2, b2, tiles=None, zero_fill=True):
    """The stack as the wrapper launches it: one launch a block, each with
    ``tiles`` (Wt, Hb) or, by default, ``refiner_plan``'s for the H100."""
    B, H, W, C = x.shape
    Wt, Hb = tiles or trefiner.refiner_plan(B, H, W, C, SMS)
    for k in range(w1.shape[0]):
        x = model_block(x, w1[k], b1[k], w2[k], b2[k], Wt, Hb, zero_fill)
    return x


def _inputs(B, H, W, C, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w1 = rng.normal(0, 0.3, (N, 5, 5, 1, C)).astype(np.float32)
    b1 = rng.normal(0, 0.1, (N, C)).astype(np.float32)
    w2 = rng.normal(0, C ** -0.5, (N, 1, 1, C, C)).astype(np.float32)
    b2 = rng.normal(0, 0.1, (N, C)).astype(np.float32)
    return x, w1, b1, w2, b2


def _xla(x, w1, b1, w2, b2):
    import jax

    for k in range(w1.shape[0]):
        h = jax.lax.conv_general_dilated(
            x, w1[k], (1, 1), [(2, 2), (2, 2)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=x.shape[-1]) + b1[k]
        x = jax.lax.conv_general_dilated(
            jax.nn.relu(h), w2[k], (1, 1), [(0, 0), (0, 0)],
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + b2[k]
    return x


def _err(got, ref):
    """max |got - ref| over max(max |ref|, 1)."""
    ref = np.asarray(ref)
    return float(np.abs(got.numpy() - ref).max()) / max(float(np.abs(ref).max()), 1.0)


# (B, H, W, C, N, tiles): C = 5, 6 and 13 (the plain-load instantiation's
# widths; 5 and 13 pad K of the 1x1 to 8 and 16), 24 (RoMa's) and 64 (the
# widest); N = 1, 2, 4 and 9; strips and bands that do not divide W and H,
# with None the plan's for the H100; an image smaller than the halo
CASES = {
    "c6_n4_ragged": (2, 13, 21, 6, 4, (8, 5)),
    "c5_n2_ragged": (1, 9, 13, 5, 2, (7, 4)),
    "c13_n2_ragged": (2, 8, 11, 13, 2, (6, 3)),
    "c24_n9_ragged": (2, 19, 40, 24, 9, (16, 7)),
    "c24_n9_plan": (2, 19, 40, 24, 9, None),
    "c24_n2_one_band": (1, 11, 37, 24, 2, (12, 11)),
    "c64_n4_ragged": (2, 10, 19, 64, 4, (8, 3)),
    "c64_n1": (1, 9, 14, 64, 1, (16, 4)),
    "c64_n2_plan": (2, 12, 9, 64, 2, None),
    "c24_n4_below_halo": (2, 3, 2, 24, 4, None),
    "c6_n9_below_halo": (1, 2, 5, 6, 9, (3, 1)),
    "c6_n2_plan": (2, 7, 11, 6, 2, None),
    "c13_n9_plan": (1, 6, 23, 13, 9, None),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_model_matches_pallas_and_xla(case):
    B, H, W, C, N, tiles = CASES[case]
    arrs = _inputs(B, H, W, C, N)
    jargs = [jnp.asarray(a) for a in arrs]
    got = model_stack(*(torch.from_numpy(a) for a in arrs), tiles=tiles)
    # f32 sums of 25 taps and C split-TF32 products in another order, over
    # N blocks; the missing lo.lo term is ~2^-22 of each product
    assert _err(got, jax_refiner(*jargs, interpret=True)) <= 1e-5
    assert _err(got, _xla(*jargs)) <= 1e-5


def test_model_without_zero_fill_differs_at_the_border():
    """Reading the nearest image pixel in place of zeros outside the image
    (a clamped load) breaks the 'same' padding: the model then leaves the
    reference near the image's border, and only there."""
    B, H, W, C, N = 1, 16, 20, 24, 3
    arrs = _inputs(B, H, W, C, N, seed=1)
    ref = np.asarray(_xla(*(jnp.asarray(a) for a in arrs)))
    targs = [torch.from_numpy(a) for a in arrs]
    good = model_stack(*targs, tiles=(8, 6))
    bad = model_stack(*targs, tiles=(8, 6), zero_fill=False)
    assert _err(good, ref) <= 1e-5
    diff = np.abs(bad.numpy() - ref).max(axis=(0, 3))  # (H, W)
    scale = float(np.abs(ref).max())
    assert diff.max() > 1e-2 * scale
    # each block reaches 2 pixels further in from the border: the interior agrees
    assert diff[6:-6, 6:-6].max() <= 1e-5 * scale


def test_one_tf32_product_leaves_the_tolerance():
    """Why the mix takes three TF32 products: at RoMa's width and depth one
    product (hi.hi) is far outside 1e-5 of max|out|, the split inside it."""
    arrs = _inputs(1, 12, 16, 24, 9, seed=2)
    ref = np.asarray(_xla(*(jnp.asarray(a) for a in arrs)))
    x, w1, b1, w2, b2 = (torch.from_numpy(a) for a in arrs)

    def stack(mix):
        y = x
        for k in range(9):
            taps = w1[k].reshape(5, 5, 24).permute(2, 0, 1)[:, None]
            h = F.relu(F.conv2d(y.permute(0, 3, 1, 2), taps, b1[k], padding=2, groups=24))
            y = (mix(h.permute(0, 2, 3, 1).reshape(-1, 24), w2[k].reshape(24, 24))
                 + b2[k]).reshape(x.shape)
        return y

    one = stack(lambda h, w: rna_tf32(h) @ rna_tf32(w))
    split = stack(split_mix)
    assert _err(split, ref) <= 1e-5
    assert _err(one, ref) > 1e-4


@pytest.mark.parametrize("C", [1, 3, 5, 6, 13, 24, 48, 64])
def test_plan_keeps_the_kernel_limits(C):
    """Every plan fits the kernel: the strip covered by MAXI columns per
    taking-part thread, the input row inside a TMA box, bands that cover H;
    RoMa's shapes fill one wave of two thread blocks on each of the H100's
    SMs, at most."""
    for B, H, W in ((2, 864, 864), (2, 560, 560), (1, 3, 2), (2, 21, 45), (4, 2000, 3000)):
        Wt, Hb = trefiner.refiner_plan(B, H, W, C, SMS)
        assert 1 <= Wt <= min(W, trefiner.MAXI * (trefiner.THREADS // C))
        assert Wt + 4 <= trefiner.MAX_BOX
        assert 1 <= Hb <= H
    if C == 24:
        for side in (560, 864):
            Wt, Hb = trefiner.refiner_plan(2, side, side, 24, SMS)
            units = 2 * -(-side // Wt) * -(-side // Hb)
            assert SMS < units <= trefiner.CTAS_PER_SM * SMS, (side, Wt, Hb, units)
