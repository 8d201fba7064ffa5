"""DISK in the port against the JAX package on the CPU: the converter's
round trip in both gate layouts, the dense maps (f32, within 1e-5 of their
largest magnitude), detection (keypoints equal as sets, ties at the lower
index as ``jax.lax.top_k``) and descriptors (within 1e-5), the checkpoint
loader's nestings, and ``run_matching --pipeline disk+lightglue`` on three
demo images. Inputs come from a numpy seed."""

from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_image_matching_tpu.models import disk as jdisk
from deep_image_matching_tpu_torch.convert import disk_params_from_jax
from deep_image_matching_tpu_torch.extractors import disk as tdisk_ext
from deep_image_matching_tpu_torch.models import disk as tdisk

DEMO_IMAGES = Path(__file__).resolve().parents[1] / "notebooks" / "demo_project" / "images"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _params(first_gate: bool, seed: int = 0):
    """The JAX init with its gates and biases drawn too, so every tensor
    the converters carry is non-trivial."""
    p = jdisk.init_params(jax.random.PRNGKey(0), first_gate=first_gate)
    rng = np.random.default_rng(seed)
    for group in ("down", "up"):
        for blk in p[group]:
            blk["b"] = jnp.asarray(rng.normal(0, 0.1, blk["b"].shape), jnp.float32)
            if blk["prelu"] is not None:
                blk["prelu"] = jnp.asarray(rng.uniform(0.0, 0.5, blk["prelu"].shape),
                                           jnp.float32)
    return p


@pytest.mark.parametrize("first_gate", [False, True])
def test_disk_converter_round_trip(first_gate):
    p = _params(first_gate)
    sd = disk_params_from_jax(p)
    back = jdisk.params_from_torch(sd)
    for group in ("down", "up"):
        for a, b in zip(p[group], back[group]):
            np.testing.assert_array_equal(np.asarray(a["w"]), np.asarray(b["w"]))
            np.testing.assert_array_equal(np.asarray(a["b"]), np.asarray(b["b"]))
            assert (a["prelu"] is None) == (b["prelu"] is None)
            if a["prelu"] is not None:
                np.testing.assert_array_equal(np.asarray(a["prelu"]), np.asarray(b["prelu"]))
    model = tdisk.params_from_torch(sd)
    assert (model.down[0].prelu is not None) == first_gate
    ref = model.state_dict()
    for k, v in sd.items():
        torch.testing.assert_close(ref[k], v, rtol=0, atol=0)
    # the port's own state dict loads back through the JAX converter
    again = jdisk.params_from_torch(model.state_dict())
    np.testing.assert_array_equal(np.asarray(again["up"][3]["w"]), np.asarray(p["up"][3]["w"]))


@pytest.mark.parametrize("first_gate", [False, True])
def test_disk_dense_and_extract_match_jax(first_gate):
    p = _params(first_gate)
    model = tdisk.params_from_torch(disk_params_from_jax(p))
    rng = np.random.default_rng(1)
    imgs = rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    jd, jh = jdisk.dense_forward(p, jnp.asarray(imgs))
    td, th = tdisk.dense_forward(model, torch.from_numpy(imgs))
    assert _rel(td, jd) < 1e-5 and _rel(th, jh) < 1e-5
    vhw = np.array([[64, 96], [50, 80]], np.int32)
    jo = jdisk.extract(p, jnp.asarray(imgs), jnp.asarray(vhw), max_keypoints=256)
    to = tdisk.extract(model, torch.from_numpy(imgs), torch.from_numpy(vhw.astype(np.int64)),
                       max_keypoints=256)
    for b in range(2):
        jm, tm = np.asarray(jo["mask"][b]), to["mask"][b].numpy()
        assert jm.sum() == tm.sum() > 20
        jk = {tuple(k): i for i, k in enumerate(np.asarray(jo["keypoints"][b])[jm])}
        tk = {tuple(k): i for i, k in enumerate(to["keypoints"][b].numpy()[tm])}
        assert jk.keys() == tk.keys()
        order = [tk[k] for k in jk]
        np.testing.assert_allclose(to["descriptors"][b].numpy()[tm][order],
                                   np.asarray(jo["descriptors"][b])[jm], atol=1e-5)
        # the scores are the dense logits: within 1e-5 of their largest magnitude
        js = np.asarray(jo["scores"][b])[jm]
        np.testing.assert_allclose(to["scores"][b].numpy()[tm][order], js, rtol=0,
                                   atol=1e-5 * np.abs(js).max())


def test_disk_extract_ties_follow_top_k():
    """A flat logit map: every position ties, so the keypoints are the
    first ones in raster order, as jax.lax.top_k picks them."""
    p = _params(False)
    model = tdisk.params_from_torch(disk_params_from_jax(p))
    for blk in list(model.up)[-1:]:
        with torch.no_grad():
            blk.conv.weight[-1].zero_()
            blk.conv.bias[-1] = 1.0
    heat_flat = tdisk.extract(model, torch.zeros(1, 32, 32, 3), torch.tensor([[32, 32]]),
                              max_keypoints=40)
    xy = heat_flat["keypoints"][0].numpy()
    np.testing.assert_array_equal(xy[:, 1] * 32 + xy[:, 0], np.arange(40))


@pytest.mark.parametrize("nesting", ["extractor", "state_dict", "top"])
def test_disk_checkpoint_loader(tmp_path, monkeypatch, nesting):
    p = _params(True)
    sd = disk_params_from_jax(p)
    # a wrapper prefix, as in the released files, which both converters strip
    sd = {f"model.{k}": v for k, v in sd.items()}
    ckpt = sd if nesting == "top" else {nesting: sd}
    torch.save(ckpt, tmp_path / "disk_depth.pth")
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setattr(tdisk_ext, "_MODEL", None)
    monkeypatch.setattr(tdisk_ext, "_MODEL_RANDOM", False)
    model = tdisk_ext.load_model()
    np.testing.assert_array_equal(model.up[2].prelu.weight.detach().numpy(),
                                  np.asarray(p["up"][2]["prelu"]))
    np.testing.assert_array_equal(model.down[0].prelu.weight.detach().numpy(),
                                  np.asarray(p["down"][0]["prelu"]))
    # a residue tensor is refused, as the JAX converter refuses it
    with pytest.raises(ValueError, match="Residue"):
        tdisk.params_from_torch({**disk_params_from_jax(p), "extra.weight": torch.ones(3, 3)})


# ---------------------------------------------------------------------------
# run_matching on both packages (the other slice files import these)
# ---------------------------------------------------------------------------

def demo_project(root, size=(256, 192), n=3):
    """The first ``n`` demo images resized to ``size`` (w, h): 49152 pixels,
    below the JAX package's chunked top-k (65536), whose fill rows DISK
    would take for keypoints (ROADMAP.md, section 3b)."""
    import cv2

    (root / "images").mkdir(parents=True)
    for p in sorted(DEMO_IMAGES.iterdir())[:n]:
        cv2.imwrite(str(root / "images" / p.name), cv2.resize(cv2.imread(str(p)), size))
    return root


def run_both_and_compare(tmp_path, proj, pipeline, yaml_text, min_verified=0, share=1.0,
                         desc_atol=1e-3, verified_share=1.0):
    """``run_matching`` of both packages on ``proj`` on the CPU in f32 with
    host verification, then the outputs held together as
    ``tests/test_torch_pipeline.py`` holds them: keypoints equal as sets,
    descriptors within one f16 ulp (1e-3), scores within 1e-3, raw and
    verified matches equal pair by pair, the database's tables equal.
    ``share`` < 1 holds each image's keypoints and each pair's raw matches
    to at least that share of their union instead (the shared keypoints'
    values as above, the verified matches where the raw ones are equal), for
    detectors whose f32 responses the two packages sum in other orders, so
    that near-equal neighbours can swap in the NMS; ``desc_atol`` is the
    descriptors' tolerance. ``verified_share`` < 1 holds the verified
    matches of a pair whose raw matches are equal as sets to that share of
    their union, for detectors whose near-equal scores can list the same
    keypoints in another order, so that MAGSAC draws other samples."""
    from test_torch_pipeline import _read

    from deep_image_matching_tpu.__main__ import run_matching as jax_run_matching
    from deep_image_matching_tpu_torch.__main__ import run_matching as torch_run_matching

    cfg = tmp_path / "config.yaml"
    cfg.write_text("general:\n  tpu:\n    device: cpu\n    dtype: float32\n" + yaml_text)
    outs = {}
    for tag, run in (("jax", jax_run_matching), ("torch", torch_run_matching)):
        feature_path, _, _ = run({
            "dir": str(proj), "outs": str(tmp_path / tag), "pipeline": pipeline,
            "strategy": "bruteforce", "skip_reconstruction": True, "graph": False,
            "force": True, "config_file": str(cfg),
        })
        outs[tag] = _read(feature_path.parent)
    jf, jraw, jver, jtab, jimg, jcam = outs["jax"]
    tf, traw, tver, ttab, timg, tcam = outs["torch"]
    n_images = len(list((proj / "images").iterdir()))
    assert jf.keys() == tf.keys() and len(jf) == n_images
    for name in jf:
        jk = {tuple(p): i for i, p in enumerate(jf[name]["keypoints"])}
        tk = {tuple(p): i for i, p in enumerate(tf[name]["keypoints"])}
        assert len(tk.keys() & jk.keys()) >= share * len(jk.keys() | tk.keys()) and len(jk) > 20
        # positions found once in each file (a detector may keep one position
        # at two scales, which features.h5 does not tell apart)
        counts = Counter(map(tuple, jf[name]["keypoints"])) + Counter(
            map(tuple, tf[name]["keypoints"]))
        once = [p for p in tk if p in jk and counts[p] == 2]
        ji = np.array([jk[p] for p in once])
        ti = np.array([tk[p] for p in once])
        np.testing.assert_allclose(tf[name]["descriptors"][:, ti].astype(np.float32),
                                   jf[name]["descriptors"][:, ji].astype(np.float32),
                                   atol=desc_atol)
        js = jf[name]["scores"][ji].astype(np.float32)
        np.testing.assert_allclose(tf[name]["scores"][ti].astype(np.float32), js, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(js).max()))
        np.testing.assert_array_equal(tf[name]["image_size"], jf[name]["image_size"])
    assert jraw.keys() == traw.keys() and len(jraw) == n_images * (n_images - 1) // 2
    assert sum(len(m) for m in jraw.values()) > 0
    for pair in jraw:
        assert len(traw[pair] & jraw[pair]) >= share * len(traw[pair] | jraw[pair]), pair
    assert jver.keys() == tver.keys() and len(jver) >= min_verified
    for pair in jver:
        # MAGSAC over other raw matches draws other samples: the verified
        # matches are held equal where the raw matches are
        if traw[pair] == jraw[pair]:
            assert len(tver[pair] & jver[pair]) >= verified_share * len(
                tver[pair] | jver[pair]), pair
    assert timg == jimg and tcam == jcam
    if share == 1.0:
        assert ttab == jtab
    return outs


def test_run_matching_disk_lightglue_agrees_with_jax(tmp_path, monkeypatch):
    from deep_image_matching_tpu.extractors import disk as jdisk_ext
    from deep_image_matching_tpu.models import lightglue as jlg
    from deep_image_matching_tpu_torch.convert import lightglue_params_from_jax
    from deep_image_matching_tpu_torch.models import lightglue as tlg

    wdir = tmp_path / "weights"
    wdir.mkdir()
    torch.save({"extractor": disk_params_from_jax(_params(False))}, wdir / "disk.pth")
    torch.save(lightglue_params_from_jax(
        jlg.init_params(jax.random.PRNGKey(42), n_layers=9, input_dim=128)),
        wdir / "disk_lightglue.pth")
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(wdir))
    monkeypatch.setattr(jdisk_ext, "_PARAMS", None)
    monkeypatch.setattr(jlg, "_DEFAULT_PARAMS", {})
    monkeypatch.setattr(jlg, "_DEFAULT_PARAMS_RANDOM", set())
    monkeypatch.setattr(tdisk_ext, "_MODEL", None)
    monkeypatch.setattr(tdisk_ext, "_MODEL_RANDOM", False)
    monkeypatch.setattr(tlg, "_DEFAULT_MODELS", {})
    monkeypatch.setattr(tlg, "_DEFAULT_RANDOM", set())
    proj = demo_project(tmp_path / "proj")
    run_both_and_compare(tmp_path, proj, "disk+lightglue",
                         "extractor:\n  max_keypoints: 512\nmatcher:\n  filter_threshold: 0.0\n")
