"""RoMa in the port against the JAX package on the CPU: kernel 9's plain
version, the VGG19 pyramid, DINOv2, the decoder's blocks, the two passes of
``match_pair``, the device sampler with the JAX draws injected, and the
checkpoint loaders. Inputs come from numpy seeds; weights are the JAX
package's random init (DINOv2 at depth 1) carried over by
``roma_params_from_jax``. Every tolerance is stated where it is used."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_image_matching_tpu.models import dinov2 as jd
from deep_image_matching_tpu.models import roma as jr
from deep_image_matching_tpu.models import vgg_refiner as jvgg
from deep_image_matching_tpu.ops.pallas_refiner import refiner_dw_stack as jax_refiner
from deep_image_matching_tpu_torch.convert import (
    dinov2_params_from_jax,
    roma_params_from_jax,
    roma_params_from_torch,
    vgg19_params_from_jax,
)
from deep_image_matching_tpu_torch.models import dinov2 as td
from deep_image_matching_tpu_torch.models import roma as tr
from deep_image_matching_tpu_torch.models import vgg_refiner as tvgg
from deep_image_matching_tpu_torch.ops.refiner import refiner_dw_stack, refiner_dw_stack_reference


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, ref, rel, what=""):
    """|got - ref| <= rel * max(|ref|, 1) elementwise."""
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    bound = rel * max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(got - ref).max())
    assert err <= bound, f"{what}: max err {err:.3e} > {bound:.3e}"


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{pre}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{pre}/{i}")
    else:
        yield pre, tree


@pytest.fixture(scope="module")
def params():
    """(JAX params, the port's params), DINOv2 at depth 1."""
    jp = jr.init_params(jax.random.PRNGKey(0), dinov2_depth=1)
    return jp, roma_params_from_jax(jax.tree.map(np.asarray, jp))


def _xla_refiner(x, w1, b1, w2, b2):
    for k in range(w1.shape[0]):
        h = jax.lax.conv_general_dilated(
            x, w1[k], (1, 1), [(2, 2), (2, 2)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=x.shape[-1]) + b1[k]
        x = jax.lax.conv_general_dilated(
            jax.nn.relu(h), w2[k], (1, 1), [(0, 0), (0, 0)],
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + b2[k]
    return x


@pytest.mark.parametrize("B,H,W,C,N", [(2, 21, 33, 6, 3), (2, 19, 40, 24, 9)])
def test_refiner_plain_matches_pallas_interpret(B, H, W, C, N):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w1 = rng.normal(0, 0.3, (N, 5, 5, 1, C)).astype(np.float32)
    b1 = rng.normal(0, 0.1, (N, C)).astype(np.float32)
    w2 = rng.normal(0, C ** -0.5, (N, 1, 1, C, C)).astype(np.float32)
    b2 = rng.normal(0, 0.1, (N, C)).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]
    pallas = np.asarray(jax_refiner(*args, interpret=True))
    xla = np.asarray(_xla_refiner(*args))
    got = refiner_dw_stack(*(_t(a) for a in (x, w1, b1, w2, b2)))
    assert torch.equal(got, refiner_dw_stack_reference(*(_t(a) for a in (x, w1, b1, w2, b2))))
    # f32 sums of 25 taps and C products in another order, over N blocks
    _close(got, pallas, 1e-5, "pallas interpret")
    _close(got, xla, 1e-5, "xla convolutions")


def test_vgg19_features_match_jax():
    tree = jvgg.init_vgg19_params(jax.random.PRNGKey(0))
    x = np.random.default_rng(1).normal(size=(2, 48, 40, 3)).astype(np.float32)
    ref = jvgg.vgg19_features(tree, jnp.asarray(x))
    got = tvgg.vgg19_features(vgg19_params_from_jax(jax.tree.map(np.asarray, tree)), _t(x))
    assert [tuple(g.shape) for g in got] == [(2, 48, 40, 64), (2, 24, 20, 128),
                                             (2, 12, 10, 256), (2, 6, 5, 512)]
    for g, r in zip(got, ref):
        _close(g, r, 1e-5, "vgg")  # f32 convolutions, sums in another order
    # the port's random init is the JAX package's
    ours, theirs = dict(_flat(tvgg.init_tree())), dict(_flat(jax.tree.map(np.asarray, tree)))
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dinov2_forward_features_match_jax(dtype):
    tree = jd.init_params(jax.random.PRNGKey(0), depth=1)
    p = dinov2_params_from_jax(jax.tree.map(np.asarray, tree))
    x = np.random.default_rng(2).normal(size=(2, 112, 112, 3)).astype(np.float32)
    ref = np.asarray(jd.forward_features(tree, jnp.asarray(x), compute_dtype=dtype))
    got = td.forward_features(p, _t(x), compute_dtype=getattr(torch, dtype))
    assert got.shape == (2, 64, 1024) and got.dtype == torch.float32
    if dtype == "float32":
        _close(got, ref, 1e-5, "f32")  # f32 sums in another order
    else:
        # bf16 activations: the port rounds to bf16 at every op boundary,
        # while XLA under jit keeps excess precision between fused ops (and
        # f32 sums run in another order), so single roundings differ by a
        # bf16 ulp (2^-7 at 1) and the block carries them on: eight ulps of
        # max(|x|, 1) per element, and 2^-7 of the mean magnitude on average
        diff = np.abs(got.numpy() - ref)
        assert (diff <= 2.0 ** -4 * np.maximum(np.abs(ref), 1.0)).all(), diff.max()
        assert diff.mean() <= 2.0 ** -7 * np.abs(ref).mean()


def test_gp_posterior_and_cls_to_flow_match_jax(params):
    jp, tp = params
    rng = np.random.default_rng(3)
    f1 = rng.normal(size=(2, 6, 8, 512)).astype(np.float32)
    f2 = rng.normal(size=(2, 6, 8, 512)).astype(np.float32)
    ref = jr.gp_posterior(jp, jnp.asarray(f1), jnp.asarray(f2))
    _close(tr.gp_posterior(tp, _t(f1), _t(f2)), ref, 1e-5, "gp")  # Cholesky, f32
    cls = rng.normal(size=(2, 5, 7, 64)).astype(np.float32) * 3
    _close(tr.cls_to_flow_refine(_t(cls)), jr.cls_to_flow_refine(jnp.asarray(cls)), 1e-6, "cls")
    tok = rng.normal(size=(2, 48, 1024)).astype(np.float32)
    _close(tr._vit_block_fwd(_t(tok), tp["embed_blocks"][0]),
           jr._vit_block_fwd(jnp.asarray(tok), jp["embed_blocks"][0]), 1e-5, "vit block")


@pytest.mark.parametrize("impl", ["gather", "dense"])
def test_local_correlation_matches_jax(impl):
    rng = np.random.default_rng(7)
    B, H, W, C, r = 2, 10, 12, 8, 2
    f1 = rng.normal(size=(B, H, W, C)).astype(np.float32)
    f2 = rng.normal(size=(B, H, W, C)).astype(np.float32)
    # flows wander off the image, so the zero border is read too
    flow = (np.asarray(jr._grid(H, W))[None] + rng.normal(0, 0.4, (B, H, W, 2))).astype(np.float32)
    corr, x_hat = tr.local_correlation(_t(f1), _t(f2), _t(flow), r, with_warp=True, impl=impl)
    for b in range(B):
        rc, rx = jr.local_correlation(jnp.asarray(f1[b]), jnp.asarray(f2[b]), jnp.asarray(flow[b]),
                                      r, with_warp=True, impl=impl)
        _close(corr[b], rc, 1e-5, "corr")  # f32 products over C in another order
        _close(x_hat[b], rx, 1e-5, "warp")


@pytest.mark.parametrize("scale,dtype", [("1", "float32"), ("8", "float32"), ("8", "bfloat16")])
def test_conv_refiner_matches_jax(params, scale, dtype):
    """Scale 1 runs the nine depthwise blocks through ``refiner_dw_stack``
    (its plain version here), scale 8 the convolutions and the radius-3
    local correlation; bf16 is the ``decoder_dtype`` / ``corr_dtype`` opt-in."""
    jp, tp = params
    rng = np.random.default_rng(8)
    C = {"1": 9, "8": 512}[scale]
    H, W = (24, 20) if scale == "1" else (7, 9)
    f1 = rng.normal(size=(2, H, W, C)).astype(np.float32)
    f2 = rng.normal(size=(2, H, W, C)).astype(np.float32)
    flow = (np.asarray(jr._grid(H, W))[None] + rng.normal(0, 0.1, (2, H, W, 2))).astype(np.float32)
    ref = jr.conv_refiner_fwd(jp["refiners"][scale], jnp.asarray(f1), jnp.asarray(f2),
                              jnp.asarray(flow), scale, 1.5, compute_dtype=dtype,
                              corr_dtype=None if dtype == "float32" else dtype)
    tdt = getattr(torch, dtype)
    got = tr.conv_refiner_fwd(tp["refiners"][scale], _t(f1), _t(f2), _t(flow), scale, 1.5,
                              compute_dtype=tdt, corr_dtype=None if dtype == "float32" else tdt)
    for g, r in zip(got, ref):
        if dtype == "float32":
            _close(g, r, 1e-5, scale)  # f32 convolutions, sums in another order
        else:
            # bf16 activations through nine blocks: roundings of 2^-9
            # relative that XLA partly skips (excess precision) compound
            _close(g, r, 2.0 ** -4, scale)
            err = np.abs(g.numpy() - np.asarray(r))
            assert err.mean() <= 2.0 ** -5 * np.abs(np.asarray(r)).mean()


def test_match_pair_and_upsample_match_jax(params):
    """Both passes at 112 / 160 px, the DINOv2 encoder in f32 on both
    sides. Random weights give certainty logits of ~1e3 and warps far
    outside the image, and the coarse-to-fine loop carries f32 rounding
    differences forward: 1e-3 of each output's magnitude."""
    jp, tp = params
    # the port's random init equals the JAX package's (the same draws)
    ours = dict(_flat(tr.init_params(dinov2_depth=1)))
    theirs = dict(_flat(tp))
    assert ours.keys() == theirs.keys()
    assert all(torch.equal(ours[k], theirs[k]) for k in ours)
    rng = np.random.default_rng(4)
    imA, imB = (rng.random((1, 112, 112, 3)).astype(np.float32) for _ in range(2))
    hrA, hrB = (rng.integers(0, 256, (1, 160, 160, 3), dtype=np.uint8) for _ in range(2))
    ref = jr.match_pair(jp, jnp.asarray(imA), jnp.asarray(imB), compute_dtype="float32",
                        with_cert16=True)
    got = tr.match_pair(tp, _t(imA), _t(imB), compute_dtype=torch.float32, with_cert16=True)
    assert [tuple(g.shape) for g in got] == [(1, 112, 112, 2), (1, 112, 112, 1)] * 2 + [(1, 8, 8, 1)] * 2
    for g, r in zip(got, ref):
        _close(g, r, 1e-3, "coarse")
    ref_up = jr.match_pair_upsample(jp, jnp.asarray(hrA), jnp.asarray(hrB), *ref[:4],
                                    scale_factor=160 / 112, cert16_ab=ref[4], cert16_ba=ref[5])
    got_up = tr.match_pair_upsample(tp, torch.from_numpy(hrA), torch.from_numpy(hrB),
                                    *(_t(r) for r in ref[:4]), scale_factor=160 / 112,
                                    cert16_ab=_t(ref[4]), cert16_ba=_t(ref[5]))
    for g, r in zip(got_up, ref_up):
        assert g.shape == (1, 160, 160, r.shape[-1])
        _close(g, r, 1e-3, "upsample")


def _jax_draws(key, n, num):
    """The three draws of the JAX package's ``sample_matches_device``."""
    n_cand = min(4 * num, n)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(key), 3)
    return (torch.from_numpy(np.array(jax.random.gumbel(k1, (n,)))),
            torch.from_numpy(np.array(jax.random.choice(k2, n_cand, (min(n_cand, 4000),),
                                                          replace=False))),
            torch.from_numpy(np.array(jax.random.gumbel(k3, (n_cand,)))))


@pytest.mark.parametrize("num", [64, 1200])
def test_sample_matches_device_with_jax_draws(num):
    """The same candidates and the same samples, in the same order, with
    the JAX draws injected (``num`` 1200 takes a 4000-point KDE subset of
    4800 candidates)."""
    rng = np.random.default_rng(5)
    H = W = 48
    warp_ab = rng.uniform(-1.1, 1.1, (H, W, 2)).astype(np.float32)   # some out of range
    warp_ba = rng.uniform(-1.1, 1.1, (H, W, 2)).astype(np.float32)
    cert_ab = rng.normal(0, 4, (H, W, 1)).astype(np.float32)
    cert_ba = rng.normal(0, 4, (H, W, 1)).astype(np.float32)
    m, c = jr.sample_matches_device(*(jnp.asarray(a) for a in (warp_ab, cert_ab, warp_ba, cert_ba)),
                                    jax.random.PRNGKey(11), num=num, sample_thresh=0.05)
    gm, gc = tr.sample_matches_device(*(_t(a) for a in (warp_ab, cert_ab, warp_ba, cert_ba)),
                                      num=num, sample_thresh=0.05,
                                      draws=_jax_draws(11, 2 * H * W, num))
    # XLA folds the grid's arithmetic differently, which moves a grid
    # coordinate by one f32 ulp; another sample would move it by a grid
    # step (2 / 48) or more
    np.testing.assert_allclose(gm.numpy(), np.asarray(m), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gc.numpy(), np.asarray(c), rtol=0, atol=1e-6)
    # without injected draws the generator is used; the result is a sample
    tm, _ = tr.sample_matches_device(*(_t(a) for a in (warp_ab, cert_ab, warp_ba, cert_ba)),
                                     generator=torch.Generator().manual_seed(0), num=num)
    assert tm.shape == (num, 4) and bool((tm.abs() <= 1).all())


def _reference_state_dicts(seed=0):
    """Random RoMa and 1-block DINOv2 state dicts in the reference
    checkpoints' naming and layouts, with non-trivial BatchNorm statistics."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, s=None):
        s = s if s is not None else (np.prod(shape[1:]) ** -0.5 if len(shape) > 1 else 0.1)
        return torch.randn(*shape, generator=g) * float(s)

    sd = {}

    def bn(prefix, n):
        sd[f"{prefix}.weight"] = 1 + rnd(n, s=0.1)
        sd[f"{prefix}.bias"] = rnd(n, s=0.1)
        sd[f"{prefix}.running_mean"] = rnd(n, s=0.1)
        sd[f"{prefix}.running_var"] = 0.5 + torch.rand(n, generator=g)

    def lin(prefix, co, ci):
        sd[f"{prefix}.weight"] = rnd(co, ci)
        sd[f"{prefix}.bias"] = rnd(co, s=0.02)

    cin = 3
    for dims, idxs in zip(jvgg.VGG19_STAGE_DIMS, jvgg.VGG19_CONV_IDX):
        for i in idxs:
            sd[f"encoder.cnn.layers.{i}.weight"] = rnd(dims, cin, 3, 3, s=(2 / (9 * cin)) ** 0.5)
            sd[f"encoder.cnn.layers.{i}.bias"] = rnd(dims, s=0.02)
            bn(f"encoder.cnn.layers.{i + 1}", dims)
            cin = dims
    for s, (ci, co) in jr._PROJ.items():
        sd[f"decoder.proj.{s}.0.weight"] = rnd(co, ci, 1, 1)
        sd[f"decoder.proj.{s}.0.bias"] = rnd(co, s=0.02)
        bn(f"decoder.proj.{s}.1", co)
    sd["decoder.gps.16.pos_conv.weight"] = rnd(jr.GP_DIM, 2, 1, 1)
    sd["decoder.gps.16.pos_conv.bias"] = rnd(jr.GP_DIM, s=0.02)
    d = 1024
    for i in range(5):
        p = f"decoder.embedding_decoder.blocks.{i}"
        for n in ("norm1", "norm2"):
            sd[f"{p}.{n}.weight"] = 1 + rnd(d, s=0.1)
            sd[f"{p}.{n}.bias"] = rnd(d, s=0.1)
        lin(f"{p}.attn.qkv", 3 * d, d)
        lin(f"{p}.attn.proj", d, d)
        lin(f"{p}.mlp.fc1", 4 * d, d)
        lin(f"{p}.mlp.fc2", d, 4 * d)
    lin("decoder.embedding_decoder.to_out", jr.CLS_RES ** 2 + 1, d)
    for s, (ci, h, disp, _r) in jr._REFINERS.items():
        p = f"decoder.conv_refiner.{s}"
        for blk in ["block1"] + [f"hidden_blocks.{j}" for j in range(8)]:
            sd[f"{p}.{blk}.0.weight"] = rnd(h, 1, 5, 5, s=0.2)
            sd[f"{p}.{blk}.0.bias"] = rnd(h, s=0.02)
            bn(f"{p}.{blk}.1", h)
            sd[f"{p}.{blk}.3.weight"] = rnd(h, h, 1, 1)
            sd[f"{p}.{blk}.3.bias"] = rnd(h, s=0.02)
        sd[f"{p}.out_conv.weight"] = rnd(3, h, 1, 1)
        sd[f"{p}.out_conv.bias"] = rnd(3, s=0.02)
        sd[f"{p}.disp_emb.weight"] = rnd(disp, 2, 1, 1)
        sd[f"{p}.disp_emb.bias"] = rnd(disp, s=0.02)
    dino = {"patch_embed.proj.weight": rnd(d, 3, 14, 14, s=0.02),
            "patch_embed.proj.bias": rnd(d, s=0.02), "cls_token": rnd(1, 1, d, s=0.02),
            "pos_embed": rnd(1, 37 * 37 + 1, d, s=0.02),
            "norm.weight": 1 + rnd(d, s=0.1), "norm.bias": rnd(d, s=0.1)}
    for n in ("norm1", "norm2"):
        dino[f"blocks.0.{n}.weight"] = 1 + rnd(d, s=0.1)
        dino[f"blocks.0.{n}.bias"] = rnd(d, s=0.1)
    for name, co, ci in (("attn.qkv", 3 * d, d), ("attn.proj", d, d), ("mlp.fc1", 4 * d, d),
                         ("mlp.fc2", d, 4 * d)):
        dino[f"blocks.0.{name}.weight"] = rnd(co, ci)
        dino[f"blocks.0.{name}.bias"] = rnd(co, s=0.02)
    dino["blocks.0.ls1.gamma"] = rnd(d, s=0.5)
    dino["blocks.0.ls2.gamma"] = rnd(d, s=0.5)
    return sd, dino


def test_checkpoint_loader_matches_jax():
    """One reference-layout checkpoint through the JAX package's
    ``params_from_torch`` and through the port's loader: the same folded
    parameters (BatchNorm folded once, in f32) and the same forward."""
    sd, dino = _reference_state_dicts()
    jp = jr.params_from_torch(sd)
    jp["dinov2"] = jd.params_from_torch(dino, cfg={**jd.VIT_L, "depth": 1})
    tp = roma_params_from_torch(sd, dino)
    carried = dict(_flat(roma_params_from_jax(jax.tree.map(np.asarray, jp))))
    loaded = dict(_flat(tp))
    assert carried.keys() == loaded.keys()
    for k in carried:  # one f32 rounding of the fold either way
        torch.testing.assert_close(loaded[k], carried[k], rtol=1e-6, atol=1e-7, msg=k)
    rng = np.random.default_rng(6)
    imA, imB = (rng.integers(0, 256, (1, 112, 112, 3), dtype=np.uint8) for _ in range(2))
    ref = jr.match_pair(jp, jnp.asarray(imA), jnp.asarray(imB), compute_dtype="float32")
    got = tr.match_pair(tp, torch.from_numpy(imA), torch.from_numpy(imB),
                        compute_dtype=torch.float32)
    for g, r in zip(got, ref):
        _close(g, r, 1e-3, "forward")  # as test_match_pair_and_upsample_match_jax
