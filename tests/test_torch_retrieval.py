"""The port's retrieval against the JAX package's, in f32 on the CPU: each of
the five global descriptors at narrow widths (channels / 8, 64 x 48 images)
from one seeded set of weights, the converters' exact round trip, the
checkpoint loaders on the demo images, ``retrieval_pairs`` and the weight
policy."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deep_image_matching_tpu import image_retrieval as jir
from deep_image_matching_tpu.models import retrieval as jr
from deep_image_matching_tpu.utils import weights as jw
from deep_image_matching_tpu.utils.image import ImageList as JImageList
from deep_image_matching_tpu_torch import image_retrieval as tir
from deep_image_matching_tpu_torch.convert import retrieval_params_from_jax
from deep_image_matching_tpu_torch.models import retrieval as tr
from deep_image_matching_tpu_torch.utils import weights as tw
from deep_image_matching_tpu_torch.utils.image import ImageList as TImageList

DEMO_IMAGES = Path(__file__).resolve().parents[1] / "notebooks" / "demo_project" / "images"
# f32 on both sides; the convolutions and reductions add in other orders
ATOL = 2e-5
R18_NARROW = [(2, 8, 1), (2, 16, 2), (2, 32, 2), (2, 64, 2)]
R101_NARROW = [(3, 32, 1), (4, 64, 2), (23, 128, 2), (3, 256, 2)]


def _conv(rng, co, ci, k):
    return rng.normal(0, (2.0 / (ci * k * k)) ** 0.5, (co, ci, k, k)).astype(np.float32)


def _bn(rng, sd, name, n):
    sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    sd[f"{name}.bias"] = rng.normal(0, 0.1, n).astype(np.float32)
    sd[f"{name}.running_mean"] = rng.normal(0, 0.1, n).astype(np.float32)
    sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)


def vgg16_openibl_state(rng, div: int = 8, clusters: int = 8) -> dict:
    """OpenIBL's upstream layout (``base_model.{i}``, ``net_vlad.*``) with
    the VGG16 widths divided by ``div``."""
    sd, cin = {}, 3
    for idx, c in zip(tr.vgg16_conv_indices(), tr.VGG16_WIDTHS):
        sd[f"base_model.{idx}.weight"] = _conv(rng, c // div, cin, 3)
        sd[f"base_model.{idx}.bias"] = rng.normal(0, 0.05, c // div).astype(np.float32)
        cin = c // div
    sd["net_vlad.centroids"] = rng.normal(0, 0.1, (clusters, cin)).astype(np.float32)
    sd["net_vlad.conv.weight"] = rng.normal(0, 0.5, (clusters, cin, 1, 1)).astype(np.float32)
    sd["net_vlad.conv.bias"] = rng.normal(0, 0.1, clusters).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def resnet_state(rng, stages, bottleneck: bool, stem: int, proj: int, prefix: str = "",
                 proj_key: str = "whiten", gem_key: str = "pool.p") -> dict:
    """A torchvision-style ResNet state dict with random BatchNorm statistics,
    a projection and a learned GeM exponent."""
    sd = {}
    sd["conv1.weight"] = _conv(rng, stem, 3, 7)
    _bn(rng, sd, "bn1", stem)
    cin = stem
    for si, (n, cout, s) in enumerate(stages):
        for bi in range(n):
            p = f"layer{si + 1}.{bi}"
            stride = s if bi == 0 else 1
            if bottleneck:
                mid = cout // 4
                shapes = [(mid, cin, 1), (mid, mid, 3), (cout, mid, 1)]
            else:
                shapes = [(cout, cin, 3), (cout, cout, 3)]
            for k, (co, ci, ks) in enumerate(shapes, 1):
                sd[f"{p}.conv{k}.weight"] = _conv(rng, co, ci, ks)
                _bn(rng, sd, f"{p}.bn{k}", co)
            if stride != 1 or cin != cout:
                sd[f"{p}.downsample.0.weight"] = _conv(rng, cout, cin, 1)
                _bn(rng, sd, f"{p}.downsample.1", cout)
            cin = cout
    sd[f"{proj_key}.weight"] = rng.normal(0, 0.1, (proj, cin)).astype(np.float32)
    sd[f"{proj_key}.bias"] = rng.normal(0, 0.05, proj).astype(np.float32)
    sd[gem_key] = np.array([2.5], np.float32)
    return {prefix + k: torch.from_numpy(v) for k, v in sd.items()}


def netvlad_tree(rng, div: int = 8, clusters: int = 8, pca: int = 64) -> dict:
    """The JAX package's NetVLAD tree (HWIO convolutions, (D, K) assignment,
    PCA) at widths / ``div``."""
    convs, cin = [], 3
    for c in tr.VGG16_WIDTHS:
        convs.append({"w": _conv(rng, c // div, cin, 3).transpose(2, 3, 1, 0).copy(),
                      "b": rng.normal(0, 0.05, c // div).astype(np.float32)})
        cin = c // div
    return {"backbone": {"convs": convs},
            "centers": rng.normal(0, 0.1, (clusters, cin)).astype(np.float32),
            "assign_w": rng.normal(0, 0.5, (cin, clusters)).astype(np.float32),
            "pca_w": rng.normal(0, 0.05, (clusters * cin, pca)).astype(np.float32),
            "pca_b": rng.normal(0, 0.05, pca).astype(np.float32)}


def _images(seed: int, h: int = 48, w: int = 64, b: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (b, h, w, 3)).astype(np.float32)


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax(v) for v in tree]
    return jnp.asarray(tree)


def _port(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _jax_descriptor(kind: str, params, x: np.ndarray) -> np.ndarray:
    if kind == "netvlad":
        feats = jr.vgg16_features(params["backbone"], jnp.asarray(x))
        return np.asarray(jr.netvlad_aggregate(feats, params["centers"], params["assign_w"],
                                               params["pca_w"], params["pca_b"]))
    if kind == "openibl":
        feats = jr.vgg16_features(params, jnp.asarray(x))
        return np.asarray(jr.netvlad_aggregate(feats, params["centers"], params["assign_w"],
                                               assign_b=params["assign_b"]))
    if kind == "cosplace":
        return np.asarray(jr.cosplace_descriptor(params, jnp.asarray(x)))
    return np.asarray(jr.resnet_gem_descriptor(params, jnp.asarray(x), stages=R101_NARROW))


def _jax_params(kind: str, seed: int):
    """(JAX tree, upstream torch state dict or None) of ``kind``."""
    rng = np.random.default_rng(seed)
    if kind == "netvlad":
        return _jax(netvlad_tree(rng)), None
    if kind == "openibl":
        sd = vgg16_openibl_state(rng)
        return jr.openibl_params_from_torch(sd), sd
    if kind == "cosplace":
        sd = resnet_state(rng, R18_NARROW, False, 8, 32, prefix="backbone.",
                          proj_key="aggregation.3", gem_key="aggregation.1.p")
        return jr.cosplace_params_from_torch(sd), sd
    sd = resnet_state(rng, R101_NARROW, True, 8, 64)
    return jr.resnet_gem_params_from_torch(sd, stages=R101_NARROW), sd


def _port_model(kind: str, sd_port: dict) -> torch.nn.Module:
    if kind in ("netvlad", "openibl"):
        return tr.VGG16NetVLAD.from_state_dict(sd_port)
    stages = R18_NARROW if kind == "cosplace" else R101_NARROW
    return tr.ResNetGeM.from_state_dict(sd_port, [s for _, _, s in stages], kind == "dir")


@pytest.mark.parametrize("kind", ["netvlad", "openibl", "cosplace", "dir"])
def test_learned_descriptor_matches_jax(kind):
    params, _ = _jax_params(kind, seed=1)
    model = _port_model(kind, retrieval_params_from_jax(params, kind))
    x = _images(2)
    if kind in ("cosplace", "dir"):
        x = (x - 0.45) / 0.225
    ref = _jax_descriptor(kind, params, x)
    with torch.no_grad():
        got = model(_port(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("size", [(48, 64), (480, 640), (13, 37)])
def test_tiny_descriptor_matches_jax(size):
    x = _images(3, *size, b=2)
    ref = np.asarray(jr.tiny_descriptor(jnp.asarray(x)))
    got = tr.tiny_descriptor(_port(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("size", [(480, 16), (640, 16), (480, 4), (13, 16), (5, 4)])
def test_resize_weights_match_jax(size):
    """The triangle weights equal ``jax.image.resize``'s (a ramp through the
    resize gives the weight matrix column by column)."""
    n_in, n_out = size
    eye = np.eye(n_in, dtype=np.float32)
    import jax

    ref = np.asarray(jax.image.resize(jnp.asarray(eye), (n_in, n_out), "linear"))
    np.testing.assert_allclose(tr.resize_weights(n_in, n_out), ref, atol=1e-7)


@pytest.mark.parametrize("kind", ["openibl", "cosplace", "dir"])
def test_converters_round_trip_exactly(kind):
    """The upstream checkpoint read by the port equals, bit for bit, the JAX
    package's reading carried across by ``retrieval_params_from_jax``; and the
    port's state written back in the upstream layout (identity BatchNorm:
    weight 1, bias 0, mean 0, variance 1 - eps) reads back through the JAX
    package's converter to the same tree."""
    params, sd = _jax_params(kind, seed=4)
    via_jax = retrieval_params_from_jax(params, kind)
    if kind == "openibl":
        direct = tr.openibl_state_from_torch(sd)
    elif kind == "cosplace":
        direct = tr.cosplace_state_from_torch(sd)
    else:
        direct = tr.resnet_state_from_torch(sd, R101_NARROW, bottleneck=True)
    assert direct.keys() == via_jax.keys()
    for k in direct:
        assert torch.equal(direct[k], via_jax[k]), k

    # back: the port's state in the upstream layout, through the JAX converter
    if kind == "openibl":
        up = {k.replace("features.", "base_model."): v for k, v in direct.items()}
        back = jr.openibl_params_from_torch(up)
    else:
        up = {}
        for k, v in direct.items():
            if k == "gem_p":
                up["gem.p"] = v.reshape(1)
            elif k.startswith("proj."):
                up[k.replace("proj.", "fc.")] = v
            elif k.endswith(".weight"):
                name = k[:-len(".weight")]
                conv, bn = _upstream_names(name)
                n = v.shape[0]
                up[f"{conv}.weight"] = v
                up[f"{bn}.weight"] = torch.ones(n)
                up[f"{bn}.bias"] = direct[f"{name}.bias"]
                up[f"{bn}.running_mean"] = torch.zeros(n)
                up[f"{bn}.running_var"] = torch.full((n,), 1.0 - 1e-5)
        if kind == "cosplace":
            back = jr.cosplace_params_from_torch(up)
        else:
            back = jr.resnet_gem_params_from_torch(up, stages=R101_NARROW)
    _assert_trees_equal(back, params)


def _upstream_names(name: str):
    if name == "stem":
        return "conv1", "bn1"
    _, si, bi, conv = name.split(".")
    p = f"layer{int(si) + 1}.{bi}"
    if conv == "downsample":
        return f"{p}.downsample.0", f"{p}.downsample.1"
    return f"{p}.{conv}", f"{p}.bn{conv[-1]}"


def _assert_trees_equal(a, b, path="") -> None:
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def _write_checkpoints(wdir: Path, seed: int) -> dict:
    """Narrow checkpoints of all four networks in their files' own layouts;
    returns the JAX trees."""
    wdir.mkdir(parents=True, exist_ok=True)
    trees = {}
    for kind, fname in (("openibl", "vgg16_netvlad.pth"), ("cosplace", "cosplace.pth"),
                        ("dir", "Resnet101-AP-GeM-LM18.pt")):
        trees[kind], sd = _jax_params(kind, seed)
        torch.save({"state_dict": sd}, wdir / fname)
    tree = netvlad_tree(np.random.default_rng(seed))
    flat = {f"backbone.convs.{i}.{p}": c[p] for i, c in enumerate(tree["backbone"]["convs"])
            for p in ("w", "b")}
    flat.update({k: tree[k] for k in ("centers", "assign_w", "pca_w", "pca_b")})
    np.savez(wdir / "netvlad.npz", **flat)
    trees["netvlad"] = tree
    return trees


def test_loaders_on_demo_images_match_jax(tmp_path, monkeypatch):
    """``compute_global_descriptors`` of both packages on the 5 demo images
    at 640 x 480 from the same checkpoint files. The JAX package's
    ``netvlad.npz`` loader cannot read an npz (it indexes a nested tree), so
    NetVLAD is held to the JAX functions on the port's own image batch."""
    wdir = tmp_path / "weights"
    trees = _write_checkpoints(wdir, seed=5)
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(wdir))
    jil, til = JImageList(DEMO_IMAGES), TImageList(DEMO_IMAGES)
    for kind in ("openibl", "cosplace", "dir", "tiny"):
        ref = jir.compute_global_descriptors(jil, kind)
        got = tir.compute_global_descriptors(til, kind, device="cpu")
        np.testing.assert_allclose(got, ref, atol=ATOL, err_msg=kind)
    got = tir.compute_global_descriptors(til, "netvlad", device="cpu")
    batch = tir.load_images(til)
    ref = _jax_descriptor("netvlad", _jax(trees["netvlad"]), batch)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_retrieval_pairs_match_jax():
    """Both packages' pairs on the demo images with the tiny descriptor at
    top-2, and on a tie-heavy descriptor set (repeated rows: equal
    similarities), where the order among ties decides the pairs."""
    jil, til = JImageList(DEMO_IMAGES), TImageList(DEMO_IMAGES)
    for k in (1, 2, 3):
        assert tir.retrieval_pairs(til, "tiny", num_matched=k, device="cpu") == \
            jir.retrieval_pairs(jil, "tiny", num_matched=k)
    rng = np.random.default_rng(6)
    base = rng.normal(size=(4, 16)).astype(np.float32)
    descs = base[rng.integers(0, 4, 40)]
    names = [f"im{i:02d}.jpg" for i in range(40)]
    for k in (1, 3, 7):
        jpairs = _jax_pairs(names, descs, k)
        assert tir.pairs_from_descriptors(names, descs, k) == jpairs


def _jax_pairs(names, descs, k):
    class _List:
        img_names = names

    real = jir.compute_global_descriptors
    jir.compute_global_descriptors = lambda *a, **kw: descs
    try:
        return jir.retrieval_pairs(_List(), "tiny", num_matched=k)
    finally:
        jir.compute_global_descriptors = real


@pytest.mark.parametrize("kind", ["netvlad", "openibl", "cosplace", "dir"])
def test_weight_policy_matches_jax(kind, tmp_path, monkeypatch):
    """Without a checkpoint: strict mode raises in both packages; with
    random weights allowed both fall back to the tiny descriptor."""
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))
    til = TImageList(DEMO_IMAGES)
    with tw.strict(), pytest.raises(tw.MissingWeightsError, match="global_feature tiny"):
        tir.compute_global_descriptors(til, kind, device="cpu")
    with jw.strict(), pytest.raises(jw.MissingWeightsError):
        jir.compute_global_descriptors(JImageList(DEMO_IMAGES), kind)
    got = tir.compute_global_descriptors(til, kind, device="cpu")
    tiny = tir.compute_global_descriptors(til, "tiny", device="cpu")
    np.testing.assert_array_equal(got, tiny)
    with pytest.raises(ValueError, match="Unknown retrieval"):
        tir.retrieval_pairs(til, "vlad", device="cpu")


@pytest.mark.parametrize("feature", ["tiny", "netvlad"])
def test_cli_retrieval_pairs_match_jax(tmp_path, feature, monkeypatch):
    """``run_matching --strategy retrieval`` of both packages on the 5 demo
    images (sift, the CPU): the same pairs.txt. Without netvlad.npz both
    fall back to the tiny descriptor (random weights allowed)."""
    import shutil

    from deep_image_matching_tpu.__main__ import run_matching as jax_run
    from deep_image_matching_tpu_torch.__main__ import run_matching as torch_run

    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(tmp_path / "none"))
    monkeypatch.setenv("HOME", str(tmp_path))
    cfg = tmp_path / "cpu.yaml"
    cfg.write_text("general:\n  tpu:\n    device: cpu\n")
    outs = {}
    for name, run in (("jax", jax_run), ("port", torch_run)):
        proj = tmp_path / name
        shutil.copytree(DEMO_IMAGES, proj / "images")
        feats, _, _ = run({"dir": str(proj), "pipeline": "sift+kornia_matcher",
                           "strategy": "retrieval", "global_feature": feature,
                           "skip_reconstruction": True, "graph": False, "force": True,
                           "config_file": str(cfg)})
        outs[name] = (feats.parent / "pairs.txt").read_text()
    assert outs["port"] == outs["jax"]
    assert len(outs["port"].splitlines()) >= 4
