"""XFeat + LighterGlue in the port against the JAX package on the CPU: the
converters' round trips, XFeat's dense maps (f32, within 1e-5 of their
largest magnitude), ``space_to_depth``, the half-pixel sampling, detection
(keypoints equal as sets) and descriptors (within 1e-5); LighterGlue
(2 layers, width 96, one head, 64-d input) against the JAX ``forward`` in
f32 and bf16, its FFN route at D = 96 (the unfused arithmetic, bit for bit),
kernel 1's plain version at head dim 96 and kernel 3's at width 96; the
checkpoint loaders (``net.`` prefixes). Inputs come from a numpy seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_image_matching_tpu.models import lightglue as jlg
from deep_image_matching_tpu.models import xfeat as jxf
from deep_image_matching_tpu.ops import attention as jattn
from deep_image_matching_tpu_torch.convert import lightglue_params_from_jax, xfeat_params_from_jax
from deep_image_matching_tpu_torch.extractors import xfeat as txf_ext
from deep_image_matching_tpu_torch.matchers import lighterglue as tlighter
from deep_image_matching_tpu_torch.models import lightglue as tlg
from deep_image_matching_tpu_torch.models import xfeat as txf
from deep_image_matching_tpu_torch.ops import attention as tattn
from deep_image_matching_tpu_torch.ops.assignment import filter_matches_fused
from deep_image_matching_tpu_torch.ops.ffn import ffn_xla


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _xfeat_params():
    p = jxf.init_params(jax.random.PRNGKey(3))
    rng = np.random.default_rng(2)
    for block in p:
        for layer in p[block]:
            layer["b"] = jnp.asarray(rng.normal(0, 0.1, layer["b"].shape), jnp.float32)
    return p


def _images(dtype=np.uint8):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (2, 64, 96, 1)).astype(np.uint8)
    return img if dtype == np.uint8 else (img / 255.0).astype(np.float32)


def test_xfeat_converter_round_trip():
    p = _xfeat_params()
    sd = xfeat_params_from_jax(p)
    back = jxf.params_from_torch({f"net.{k}": v for k, v in sd.items()})
    for block in p:
        for a, b in zip(p[block], back[block]):
            np.testing.assert_array_equal(np.asarray(a["w"]), np.asarray(b["w"]))
            np.testing.assert_array_equal(np.asarray(a["b"]), np.asarray(b["b"]))
    model = txf.params_from_torch(sd)
    for block in p:
        for a, conv in zip(p[block], getattr(model, block)):
            np.testing.assert_array_equal(conv.weight.detach().numpy(),
                                          np.asarray(a["w"]).transpose(3, 2, 0, 1))
            np.testing.assert_array_equal(conv.bias.detach().numpy(), np.asarray(a["b"]))


def test_space_to_depth_and_halfpix_sampling():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 32, 48, 1)).astype(np.float32)
    ref = np.asarray(jxf._space_to_depth(jnp.asarray(x), 8))
    got = txf.space_to_depth(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), ref)
    fmap = rng.normal(size=(8, 12, 5)).astype(np.float32)
    coords = np.concatenate([rng.uniform(-2, 100, (64, 1)), rng.uniform(-2, 66, (64, 1))],
                            1).astype(np.float32)
    ref = np.asarray(jxf._sample_map_halfpix(jnp.asarray(fmap), jnp.asarray(coords), 64, 96))
    got = txf.sample_map_halfpix(torch.from_numpy(fmap), torch.from_numpy(coords), 64, 96)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    # the same arithmetic as grid_sample's align_corners=False convention
    grid = torch.from_numpy(np.stack([2 * coords[:, 0] / 95 - 1, 2 * coords[:, 1] / 63 - 1], -1))
    gs = torch.nn.functional.grid_sample(torch.from_numpy(fmap).permute(2, 0, 1)[None],
                                         grid[None, None], align_corners=False)
    np.testing.assert_allclose(got.numpy(), gs[0, :, 0].T.numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_xfeat_dense_and_extract_match_jax(dtype):
    p = _xfeat_params()
    model = txf.params_from_torch(xfeat_params_from_jax(p))
    imgs = _images(dtype)
    jout = jxf.dense_forward(p, jnp.asarray(imgs))
    tout = txf.dense_forward(model, torch.from_numpy(imgs))
    for j, t in zip(jout, tout):
        assert _rel(t.numpy(), j) < 1e-5
    np.testing.assert_allclose(txf.get_kpts_heatmap(tout[1]).numpy(),
                               np.asarray(jxf.get_kpts_heatmap(jout[1])), atol=1e-6)
    vhw = np.array([[64, 96], [60, 70]], np.int32)
    jo = jxf.extract(p, jnp.asarray(imgs), jnp.asarray(vhw), top_k=256, detection_threshold=0.01)
    to = txf.extract(model, torch.from_numpy(imgs), torch.from_numpy(vhw.astype(np.int64)),
                     top_k=256, detection_threshold=0.01)
    for b in range(2):
        jm, tm = np.asarray(jo["mask"][b]), to["mask"][b].numpy()
        assert jm.sum() == tm.sum() > 20
        jk = np.asarray(jo["keypoints"][b])[jm]
        tk = to["keypoints"][b].numpy()[tm]
        assert {tuple(k) for k in jk} == {tuple(k) for k in tk}
        index = {tuple(k): i for i, k in enumerate(tk)}
        order = [index[tuple(k)] for k in jk]
        np.testing.assert_allclose(to["descriptors"][b].numpy()[tm][order],
                                   np.asarray(jo["descriptors"][b])[jm], atol=1e-5)
        np.testing.assert_allclose(to["scores"][b].numpy()[tm][order],
                                   np.asarray(jo["scores"][b])[jm], rtol=1e-5, atol=1e-7)


def test_xfeat_checkpoint_loader(tmp_path, monkeypatch):
    p = _xfeat_params()
    torch.save({f"net.{k}": v for k, v in xfeat_params_from_jax(p).items()},
               tmp_path / "xfeat.pt")
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setattr(txf_ext, "_MODEL", None)
    monkeypatch.setattr(txf_ext, "_MODEL_RANDOM", False)
    model = txf_ext.load_model()
    np.testing.assert_array_equal(model.keypoint_head[3].weight.detach().numpy(),
                                  np.asarray(p["keypoint_head"][3]["w"]).transpose(3, 2, 0, 1))


# ---------------------------------------------------------------------------
# LighterGlue
# ---------------------------------------------------------------------------

B, K, DIM, LAYERS, IN_DIM = 2, 128, 96, 2, 64


def _lg_params():
    return jlg.init_params(jax.random.PRNGKey(11), n_layers=LAYERS, dim=DIM, num_heads=1,
                           input_dim=IN_DIM)


def _lg_port(params):
    model = tlg.LightGlue(n_layers=LAYERS, dim=DIM, num_heads=1, input_dim=IN_DIM)
    model.load_state_dict(lightglue_params_from_jax(params))
    return model.eval()


def _lg_inputs():
    rng = np.random.default_rng(6)
    kpts0 = (rng.random((B, K, 2)) * [320, 240]).astype(np.float32)
    perm = np.stack([rng.permutation(K) for _ in range(B)])
    kpts1 = np.take_along_axis(kpts0, perm[..., None], 1) + np.float32([12, -8])
    desc0 = rng.normal(size=(B, K, IN_DIM)).astype(np.float32)
    desc0 /= np.linalg.norm(desc0, axis=-1, keepdims=True)
    desc1 = np.take_along_axis(desc0, perm[..., None], 1)
    desc1 = desc1 + 0.1 * rng.normal(size=desc1.shape).astype(np.float32)
    mask0 = np.ones((B, K), bool)
    mask0[1, 100:] = False
    mask1 = np.take_along_axis(mask0, perm, 1)
    size = np.tile(np.float32([[320, 240]]), (B, 1))
    return kpts0, kpts1, desc0, desc1, mask0, mask1, size, size


def test_lighterglue_converter_round_trip():
    p = _lg_params()
    back = jlg.params_from_torch(lightglue_params_from_jax(p), n_layers=LAYERS)
    # the JAX tree's last token head is padding (zeros after the trip)
    p["layers"]["token"] = jax.tree.map(lambda x: x.at[-1].set(0.0), p["layers"]["token"])
    leaves_p, tree_p = jax.tree_util.tree_flatten(p)
    leaves_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_p == tree_b
    for a, b in zip(leaves_p, leaves_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lighterglue_forward_matches_jax(dtype):
    """f32: matches and validity equal, scores within 1e-4. bf16: both sides
    round every product and the probabilities to bf16 in other orders, so
    matches agree on at least 95 % of the valid rows and the scores of the
    rows that agree within 2e-2."""
    p = _lg_params()
    inputs = _lg_inputs()
    ref = jlg.forward(p, *(jnp.asarray(a) for a in inputs), num_heads=1,
                      filter_threshold=0.0, compute_dtype=dtype, attn_impl="xla",
                      assignment_impl="dense")
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = tlg.forward(_lg_port(p), *(torch.from_numpy(a) for a in inputs), filter_threshold=0.0,
                      compute_dtype=getattr(torch, dtype))
    v = ref["valid0"]
    assert v.sum() > 50
    if dtype == "float32":
        np.testing.assert_array_equal(got["valid0"].numpy(), v)
        np.testing.assert_array_equal(got["matches0"].numpy(), ref["matches0"])
        np.testing.assert_allclose(got["matching_scores0"].numpy()[v],
                                   ref["matching_scores0"][v], atol=1e-4)
    else:
        same = got["matches0"].numpy() == ref["matches0"]
        assert same[v].mean() >= 0.95
        both = v & same
        np.testing.assert_allclose(got["matching_scores0"].float().numpy()[both],
                                   ref["matching_scores0"][both], atol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_route_at_width_96(dtype):
    """At D = 96 ``_ffn`` with impl "fused" is the unfused arithmetic bit for
    bit (kernel 2 is never called), and equals the JAX package's ``_ffn``."""
    tdt = getattr(torch, dtype)
    model = _lg_port(_lg_params())
    pt = {k: v.to(tdt) for k, v in model.state_dict().items()}
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(B, K, DIM)).astype(np.float32)).to(tdt)
    msg = torch.from_numpy(rng.normal(size=(B, K, DIM)).astype(np.float32)).to(tdt)
    pre = "transformers.0.self_attn"
    got = tlg._ffn(x, msg, pt, pre, "fused")
    args = [pt[f"{pre}.ffn.{i}.{n}"] for i, n in ((0, "weight"), (0, "bias"), (1, "weight"),
                                                   (1, "bias"), (3, "weight"), (3, "bias"))]
    assert torch.equal(got, ffn_xla(x, msg, *args))
    jp = jax.tree_util.tree_map(lambda a: a[0], _lg_params()["layers"]["self"])
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, getattr(jnp, dtype)), jp)
    jdt = getattr(jnp, dtype)
    ref = jlg._ffn(jnp.asarray(x.float().numpy(), jdt), jnp.asarray(msg.float().numpy(), jdt), jp,
                   impl="fused")
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    else:
        # one bf16 ulp of the output where the f32 products round differently
        assert (np.abs(got.float().numpy() - ref) <= 2.0 ** -7 * np.abs(ref) + 1e-6).all()
        assert (got.float().numpy() == ref).mean() >= 0.99


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_at_head_dim_96_matches_jax(dtype):
    """Kernel 1's plain version at LighterGlue's head dim against the JAX
    package's ``fused_attention`` on its CPU route, valid query rows."""
    rng = np.random.default_rng(8)
    Bq, H, T, hd = 2, 1, 96, 96
    q, k, v = (rng.normal(size=(Bq, H, T, hd)).astype(np.float32) * s for s in (2.0, 2.0, 1.0))
    qm = np.ones((Bq, T), bool)
    km = np.ones((Bq, T), bool)
    qm[1, 70:] = km[1, 50:] = False
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jattn.fused_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(qm),
                                jnp.asarray(km), hd ** -0.5, impl="xla")
    ref = np.asarray(ref.astype(jnp.float32))
    got = tattn.fused_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                torch.from_numpy(qm), torch.from_numpy(km), hd ** -0.5)
    rows = np.broadcast_to(qm[:, None, :, None], ref.shape)
    err = np.abs(got.float().numpy() - ref)[rows]
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    assert (err <= tol * np.maximum(np.abs(ref[rows]), 1.0)).all()


def test_assignment_plain_at_width_96_matches_dense():
    """Kernel 3's plain version at D = 96: the filtered matches of the dense
    log assignment (the JAX package's CPU route)."""
    p = _lg_params()
    model = _lg_port(p)
    pt = {k: v for k, v in model.state_dict().items()}
    rng = np.random.default_rng(9)
    d0 = torch.from_numpy(rng.normal(size=(B, K, DIM)).astype(np.float32))
    d1 = torch.cat([d0[:, 64:], d0[:, :64]], 1) + 0.05 * torch.from_numpy(
        rng.normal(size=(B, K, DIM)).astype(np.float32))
    m0 = torch.ones(B, K, dtype=torch.bool)
    m1 = torch.ones(B, K, dtype=torch.bool)
    m1[0, 90:] = False
    md0, md1, z0, z1 = tlg._assign_inputs(d0, d1, pt, 0)
    got = filter_matches_fused(md0, md1, z0, z1, m0, m1, 0.0)
    jp = jax.tree_util.tree_map(lambda a: a[0], p["layers"]["assign"])
    scores = jlg._log_assignment(jnp.asarray(d0.numpy()), jnp.asarray(d1.numpy()),
                                 jnp.asarray(m0.numpy()), jnp.asarray(m1.numpy()), jp)
    ref = jlg.filter_matches_static(scores, jnp.asarray(m0.numpy()), jnp.asarray(m1.numpy()), 0.0)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert got[2].sum() > 50


def test_lighterglue_checkpoint_loader(tmp_path, monkeypatch):
    """``xfeat-lighterglue.pt`` with its ``net.`` prefix, at the matcher's
    6 layers, loads into the matcher's model."""
    p = jlg.init_params(jax.random.PRNGKey(11), n_layers=6, dim=96, num_heads=1, input_dim=64)
    sd = {f"net.{k}": v for k, v in lightglue_params_from_jax(p).items()}
    torch.save(sd, tmp_path / "xfeat-lighterglue.pt")
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setattr(tlighter, "_MODEL", None)
    monkeypatch.setattr(tlighter, "_MODEL_RANDOM", False)
    model = tlighter.load_model()
    assert model.n_layers == 6 and model.num_heads == 1
    np.testing.assert_array_equal(model.state_dict()["input_proj.weight"].numpy(),
                                  np.asarray(p["input_proj"]["w"]).T)
    assert jlg.params_from_torch(tlighter.strip_net_prefix(sd), n_layers=6)["posenc"]["wr"].shape \
        == (2, 48)


def test_run_matching_xfeat_lighterglue_agrees_with_jax(tmp_path, monkeypatch):
    from test_torch_disk import run_both_and_compare
    from test_torch_pipeline import _project

    from deep_image_matching_tpu.extractors import xfeat as jxf_ext
    from deep_image_matching_tpu.matchers import lighterglue as jlighter

    wdir = tmp_path / "weights"
    wdir.mkdir()
    torch.save({f"net.{k}": v for k, v in xfeat_params_from_jax(_xfeat_params()).items()},
               wdir / "xfeat.pt")
    lg = jlg.init_params(jax.random.PRNGKey(11), n_layers=6, dim=96, num_heads=1, input_dim=64)
    torch.save({f"net.{k}": v for k, v in lightglue_params_from_jax(lg).items()},
               wdir / "xfeat-lighterglue.pt")
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(wdir))
    monkeypatch.setattr(jxf_ext, "_PARAMS", None)
    monkeypatch.setattr(jlighter, "_PARAMS", None)
    monkeypatch.setattr(txf_ext, "_MODEL", None)
    monkeypatch.setattr(txf_ext, "_MODEL_RANDOM", False)
    monkeypatch.setattr(tlighter, "_MODEL", None)
    monkeypatch.setattr(tlighter, "_MODEL_RANDOM", False)
    # three views shifted by whole 8-px cells: random weights still match them
    run_both_and_compare(tmp_path, _project(tmp_path / "proj"), "xfeat+lighterglue",
                         "extractor:\n  max_num_keypoints: 512\nmatcher:\n  filter_threshold: 0.0\n",
                         min_verified=1)
