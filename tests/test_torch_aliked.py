"""The port's ALIKED against the JAX package's, in f32 on the CPU: the
deformable sampling ops, the checkpoint loaders, the dense backbone, DKD,
SDDH and the whole extraction of ``aliked-n16rot`` at full width, the
ALIKED low-res probe, and ``run_matching --pipeline aliked+lightglue``.
Neither package has an ALIKED random initialisation, so both load one
seeded checkpoint in the upstream state-dict layout, built here."""

import sqlite3
from pathlib import Path

import cv2
import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_image_matching_tpu.__main__ import run_matching as jax_run_matching
from deep_image_matching_tpu.extractors import aliked as jext
from deep_image_matching_tpu.models import aliked as jal
from deep_image_matching_tpu.models import lightglue as jlg
from deep_image_matching_tpu.models import superpoint as jsp
from deep_image_matching_tpu.ops import deform as jdef
from deep_image_matching_tpu_torch.__main__ import run_matching as torch_run_matching
from deep_image_matching_tpu_torch.convert import aliked_params_from_jax, lightglue_params_from_jax
from deep_image_matching_tpu_torch.extractors import aliked as text
from deep_image_matching_tpu_torch.models import aliked as tal
from deep_image_matching_tpu_torch.models import lightglue as tlg
from deep_image_matching_tpu_torch.models import superpoint as tsp
from deep_image_matching_tpu_torch.ops import deform as tdef

DEMO_IMAGES = Path(__file__).resolve().parents[1] / "notebooks" / "demo_project" / "images"
MODEL = "aliked-n16rot"


def aliked_state_dict(seed: int = 0) -> dict:
    """A seeded ``aliked-n16rot`` checkpoint in the upstream key layout:
    He-normal convolutions, BatchNorm with running statistics, small
    deformable offsets, a score head scaled so that a share of the sigmoid
    scores clears the 0.2 detection threshold without saturating (the
    upstream initialisation puts nearly all of them at 1), and the coarse
    blocks' share of the features damped. ``chip_smoke.py`` builds the same."""
    rng = np.random.default_rng(seed)
    c1, c2, c3, c4, dim, K, M = tal.CFGS[MODEL]
    sd = {}

    def conv(name, co, ci, k, bias=False, std=None):
        std = (2.0 / (ci * k * k)) ** 0.5 if std is None else std
        sd[f"{name}.weight"] = rng.normal(0, std, (co, ci, k, k))
        if bias:
            sd[f"{name}.bias"] = rng.normal(0, 0.05, co)

    def bn(name, n):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, n)
        sd[f"{name}.bias"] = rng.normal(0, 0.1, n)
        sd[f"{name}.running_mean"] = rng.normal(0, 0.1, n)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, n)
        sd[f"{name}.num_batches_tracked"] = np.array(0)

    conv("block1.conv1", c1, 3, 3)
    bn("block1.bn1", c1)
    conv("block1.conv2", c1, c1, 3)
    bn("block1.bn2", c1)
    conv("block2.conv1", c2, c1, 3)
    bn("block2.bn1", c2)
    conv("block2.conv2", c2, c2, 3)
    bn("block2.bn2", c2)
    conv("block2.downsample", c2, c1, 1, bias=True)
    for blk, ci, co in (("block3", c2, c3), ("block4", c3, c4)):
        for j, cin in ((1, ci), (2, co)):
            conv(f"{blk}.conv{j}.offset_conv", 18, cin, 3, bias=True, std=0.5 / (cin * 9) ** 0.5)
            conv(f"{blk}.conv{j}.regular_conv", co, cin, 3)
            bn(f"{blk}.bn{j}", co)
        conv(f"{blk}.downsample", co, ci, 1, bias=True)
    for i, c in enumerate((c1, c2, c3, c4), 1):
        # the /8 and /32 blocks' align-corners upsampling is not shift
        # equivariant: damped, so shifted copies of a view keep most of
        # their keypoints and descriptors
        conv(f"conv{i}", dim // 4, c, 1, std=(2.0 / c) ** 0.5 * (0.1 if i > 2 else 1.0))
    conv("score_head.0", 8, dim, 1)
    conv("score_head.2", 4, 8, 3)
    conv("score_head.4", 4, 4, 3)
    conv("score_head.6", 1, 4, 3, std=0.05)
    conv("desc_head.offset_conv.0", 2 * M, dim, K, bias=True, std=0.5 / (dim * K * K) ** 0.5)
    conv("desc_head.offset_conv.2", 2 * M, 2 * M, 1, bias=True)
    conv("desc_head.sf_conv", dim, dim, 1)
    sd["desc_head.agg_weights"] = rng.normal(0, (1.0 / (M * dim)) ** 0.5, (M, dim, dim))
    return {k: torch.tensor(v, dtype=torch.int64 if v.ndim == 0 else torch.float32)
            for k, v in sd.items()}


@pytest.fixture(scope="module")
def params():
    """(JAX params, port params) of the seeded checkpoint."""
    sd = aliked_state_dict()
    return jal.params_from_torch(sd, MODEL), tal.params_from_torch(sd, MODEL)


def _images(sides=((96, 128), (128, 96))):
    """Demo images resized to (h, w), uint8 (B, H, W, 3) padded to one shape."""
    names = ("sacre_coeur_A.jpg", "sacre_coeur_B.jpg")
    H = max(-(-h // 32) * 32 for h, _ in sides)
    W = max(-(-w // 32) * 32 for _, w in sides)
    batch = np.zeros((len(sides), H, W, 3), np.uint8)
    for i, (name, (h, w)) in enumerate(zip(names, sides)):
        batch[i, :h, :w] = cv2.resize(cv2.imread(str(DEMO_IMAGES / name))[..., ::-1], (w, h),
                                      interpolation=cv2.INTER_AREA)
    return batch, np.array(sides, np.int64)


def _same_rows(a, b, atol):
    """Rows of a and b equal as sets (within atol), returning b's order of a."""
    d = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    idx = d.argmin(1)
    assert (d.min(1) <= atol).all() and len(set(idx.tolist())) == len(a) == len(b)
    return idx


# ---------------------------------------------------------------------------
# deformable sampling ops
# ---------------------------------------------------------------------------

def _fmap_coords(seed=0, H=9, W=11, C=5, n=200):
    rng = np.random.default_rng(seed)
    fmap = rng.normal(size=(H, W, C)).astype(np.float32)
    # a margin beyond both borders: some corners and whole samples outside
    coords = np.stack([rng.uniform(-2.5, W + 1.5, n), rng.uniform(-2.5, H + 1.5, n)], -1)
    coords[:4] = [[0, 0], [W - 1, H - 1], [-1, 3], [W - 1, -0.5]]  # on the edges
    return fmap, coords.astype(np.float32).reshape(10, 20, 2)


@pytest.mark.parametrize("name", ["bilinear_sample_zeropad", "bilinear_sample_zeropad_wide"])
def test_bilinear_zeropad_matches_jax(name):
    fmap, coords = _fmap_coords()
    ref = np.asarray(getattr(jdef, name)(jnp.asarray(fmap), jnp.asarray(coords)))
    got = getattr(tdef, name)(torch.from_numpy(fmap), torch.from_numpy(coords)).numpy()
    assert got.shape == (10, 20, 5)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert (np.abs(ref).max(-1) == 0).any()  # samples wholly outside are zero


def test_deform_conv2d_matches_jax():
    rng = np.random.default_rng(1)
    H, W, Cin, Cout = 12, 10, 6, 7
    x = rng.normal(size=(H, W, Cin)).astype(np.float32)
    offset = rng.normal(0, 2.0, (H, W, 18)).astype(np.float32)  # samples leave the map
    w = rng.normal(size=(3, 3, Cin, Cout)).astype(np.float32)   # HWIO
    b = rng.normal(size=Cout).astype(np.float32)
    ref = np.asarray(jdef.deform_conv2d(*(jnp.asarray(a) for a in (x, offset, w, b))))
    got = tdef.deform_conv2d(torch.from_numpy(x), torch.from_numpy(offset),
                             torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                             torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_extract_patches_matches_jax():
    rng = np.random.default_rng(2)
    fmap = rng.normal(size=(16, 20, 4)).astype(np.float32)
    # corners and borders: the [0, dim - 1 - ps] clamp
    centers = np.array([[0, 0], [19, 15], [1, 14], [10, 8], [18, 0], [5, 1]], np.int32)
    ref = np.asarray(jdef.extract_patches(jnp.asarray(fmap), jnp.asarray(centers), 3))
    got = tdef.extract_patches(torch.from_numpy(fmap), torch.from_numpy(centers), 3).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("op, arg", [("up", 2), ("up", 8), ("up", 32), ("resize", (7, 13))])
def test_bilinear_resize_matches_jax(op, arg):
    x = np.random.default_rng(3).normal(size=(2, 3, 4, 5)).astype(np.float32)
    name = "upsample_bilinear_align" if op == "up" else "resize_bilinear_align"
    ref = getattr(jdef, name)(jnp.asarray(x), arg)
    got = getattr(tdef, name)(torch.from_numpy(x), arg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


# ---------------------------------------------------------------------------
# checkpoint and model
# ---------------------------------------------------------------------------

def test_checkpoint_loaders_agree_exactly(params):
    jparams, tparams = params
    carried = aliked_params_from_jax(jax.tree.map(np.asarray, jparams))
    flat_t, flat_c = [], []

    def walk(a, b, path=""):
        assert type(a) is type(b), path
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
        else:
            flat_t.append(path)
            assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape, path
            assert torch.equal(a, b), path

    walk(tparams, carried)
    assert len(flat_t) == 44


def test_dense_forward_matches_jax(params):
    jparams, tparams = params
    batch, _ = _images()
    jf, js = jal.dense_forward(jparams, jnp.asarray(batch))
    tf, ts = tal.dense_forward(tparams, torch.from_numpy(batch))
    assert tf.shape == (2, 128, 128, 128) and ts.shape == (2, 128, 128)
    # f32 convolutions summed in another order, through 14 layers
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=2e-5)
    assert float(ts.max()) < 0.99  # not saturated: no plateaus of tied scores


def test_dkd_detect_matches_jax(params):
    jparams, _ = params
    batch, vhw = _images()
    _, js = jal.dense_forward(jparams, jnp.asarray(batch))
    ref = [np.asarray(a) for a in jal.dkd_detect(js, jnp.asarray(vhw, jnp.int32), 300, 0.2, 3)]
    got = [a.numpy() for a in tal.dkd_detect(torch.from_numpy(np.array(js)),
                                             torch.from_numpy(vhw), 300, 0.2, 3)]
    np.testing.assert_array_equal(got[3], ref[3])  # the same slots are valid
    assert ref[3].sum() > 100
    np.testing.assert_allclose(got[0], ref[0], atol=1e-5)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-6)
    np.testing.assert_allclose(got[2][ref[3]], ref[2][ref[3]], atol=1e-5)


def test_select_topk_breaks_ties_as_jax():
    """Plateaus of equal scores with more tied candidates than slots: the
    same keypoints in the same order as ``jax.lax.top_k`` (lower index
    first), at SuperPoint's and ALIKED's settings."""
    from deep_image_matching_tpu.ops import detect as jdet
    from deep_image_matching_tpu_torch.ops import detect as tdet

    rng = np.random.default_rng(6)
    scores = rng.choice(np.float32([0.0, 0.1, 0.3, 0.5, 0.9]), size=(2, 64, 80))
    vhw = np.array([[64, 80], [50, 70]], np.int32)
    for k, th, border in ((300, 0.0005, 4), (700, 0.2, 3)):
        ref = jdet.select_topk(jnp.asarray(scores), k, threshold=th, border=border,
                               valid_hw=(jnp.asarray(vhw[:, 0]), jnp.asarray(vhw[:, 1])))
        got = tdet.select_topk(torch.from_numpy(scores), k, threshold=th, border=border,
                               valid_hw=(torch.from_numpy(vhw[:, 0]), torch.from_numpy(vhw[:, 1])))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_sddh_describe_matches_jax(params):
    jparams, tparams = params
    batch, _ = _images()
    jf, _ = jal.dense_forward(jparams, jnp.asarray(batch))
    fmap = np.array(jf)[0]
    rng = np.random.default_rng(4)
    kpts = np.concatenate([rng.uniform(0, 127, (60, 2)),
                           [[0, 0], [127, 127], [0.4, 126.6], [127, 0]]]).astype(np.float32)
    ref = np.asarray(jal.sddh_describe(jparams["sddh"], jnp.asarray(fmap), jnp.asarray(kpts)))
    got = tal.sddh_describe(tparams["sddh"], torch.from_numpy(fmap), torch.from_numpy(kpts))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_extract_matches_jax(params):
    jparams, tparams = params
    batch, vhw = _images()
    ref = jal.extract(jparams, jnp.asarray(batch), jnp.asarray(vhw, jnp.int32),
                      max_keypoints=400, nms_radius=3, model_name=MODEL)
    got = tal.extract(tparams, torch.from_numpy(batch), torch.from_numpy(vhw),
                      max_keypoints=400, nms_radius=3, model_name=MODEL)
    for b in range(2):
        rm, gm = np.asarray(ref["mask"][b]), got["mask"][b].numpy()
        assert rm.sum() == gm.sum() > 100
        rk, gk = np.asarray(ref["keypoints"][b])[rm], got["keypoints"][b].numpy()[gm]
        idx = _same_rows(rk, gk, 1e-4)  # keypoints equal as sets
        np.testing.assert_allclose(got["scores"][b].numpy()[gm][idx],
                                   np.asarray(ref["scores"][b])[rm], atol=1e-5)
        np.testing.assert_allclose(got["descriptors"][b].numpy()[gm][idx],
                                   np.asarray(ref["descriptors"][b])[rm], atol=1e-4)
        assert not got["descriptors"][b].numpy()[~gm].any()


# ---------------------------------------------------------------------------
# the probe and the pipeline
# ---------------------------------------------------------------------------

@pytest.fixture
def aliked_weights(tmp_path, monkeypatch):
    """The seeded checkpoint as ``aliked-n16rot.pth`` in a weights directory
    of its own, with every default-weight cache emptied; no SuperPoint or
    LightGlue checkpoint unless a test adds one."""
    wdir = tmp_path / "weights"
    wdir.mkdir()
    torch.save(aliked_state_dict(), wdir / f"{MODEL}.pth")
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(wdir))
    monkeypatch.setattr(jext, "_PARAM_CACHE", {})
    monkeypatch.setattr(text, "_PARAM_CACHE", {})
    monkeypatch.setattr(jsp, "_DEFAULT_PARAMS", None)
    monkeypatch.setattr(jsp, "_DEFAULT_PARAMS_RANDOM", False)
    monkeypatch.setattr(jlg, "_DEFAULT_PARAMS", {})
    monkeypatch.setattr(jlg, "_DEFAULT_PARAMS_RANDOM", set())
    monkeypatch.setattr(tsp, "_DEFAULT_MODEL", None)
    monkeypatch.setattr(tsp, "_DEFAULT_MODEL_RANDOM", False)
    monkeypatch.setattr(tlg, "_DEFAULT_MODELS", {})
    monkeypatch.setattr(tlg, "_DEFAULT_RANDOM", set())
    return wdir


def test_lowres_probe_aliked_branch_matches_jax(aliked_weights):
    """No SuperPoint/LightGlue checkpoint, an ALIKED one: both packages probe
    with ALIKED and mutual-nearest-neighbour counting, and keep the same
    pairs from the same counts."""
    from deep_image_matching_tpu.low_resolution import _probe_backend as jax_backend
    from deep_image_matching_tpu.low_resolution import lowres_pair_probe as jax_probe
    from deep_image_matching_tpu_torch.low_resolution import _probe_backend as torch_backend
    from deep_image_matching_tpu_torch.low_resolution import lowres_pair_probe as torch_probe
    from deep_image_matching_tpu_torch.upright import _AlikedProbe
    from deep_image_matching_tpu_torch.utils.image import ImageList

    paths = sorted(DEMO_IMAGES.iterdir())
    jrunner, jcount = jax_backend(max_keypoints=256, resize_max=160)
    trunner, tcount = torch_backend(max_keypoints=256, resize_max=160, device=torch.device("cpu"))
    assert isinstance(trunner, _AlikedProbe)
    jfeats, tfeats = jrunner.extract_images(paths), trunner.extract_images(paths)
    for jf, tf in zip(jfeats, tfeats):
        assert len(jf["keypoints"]) > 50
        idx = _same_rows(jf["keypoints"], tf["keypoints"], 1e-3)
        np.testing.assert_allclose(tf["descriptors"][idx], jf["descriptors"], atol=1e-4)
    pairs = [(i, j) for i in range(len(paths)) for j in range(i + 1, len(paths))]
    jc, tc = jcount(jfeats, pairs), tcount(tfeats, pairs)
    assert tc == jc and max(jc) > 0

    class Cfg:
        general = {"lowres_probe_size": 160, "lowres_max_keypoints": 256,
                   "lowres_min_matches": int(np.median(jc)), "tpu": {"device": "cpu"}}

    kept = jax_probe(ImageList(DEMO_IMAGES), config=Cfg)
    assert torch_probe(ImageList(DEMO_IMAGES), config=Cfg) == kept
    assert 0 < len(kept) < len(pairs)


def _demo_project(root: Path) -> Path:
    """Three demo images at a quarter of their size."""
    (root / "images").mkdir(parents=True)
    for name in ("sacre_coeur_A.jpg", "sacre_coeur_B.jpg", "sacre_coeur_squared.jpg"):
        img = cv2.imread(str(DEMO_IMAGES / name))
        h, w = img.shape[:2]
        cv2.imwrite(str(root / "images" / name.replace(".jpg", ".png")),
                    cv2.resize(img, (w // 4, h // 4), interpolation=cv2.INTER_AREA))
    return root


def _read(out_dir):
    """features by image, raw and verified matches as (N, 2) index arrays,
    the database's table sizes and images."""
    feats, raw, ver = {}, {}, {}
    with h5py.File(out_dir / "features.h5", "r") as f:
        for name in f:
            feats[name] = {k: f[name][k][()] for k in f[name]}
    for path, out in ((out_dir / "raw_matches.h5", raw), (out_dir / "matches.h5", ver)):
        if path.exists():
            with h5py.File(path, "r") as f:
                for a in f:
                    for b in f[a]:
                        out[(a, b)] = f[a][b][()]
    db = sqlite3.connect(str(out_dir / "database.db"))
    tables = {t: db.execute(f"SELECT COUNT(*) FROM {t}").fetchone()[0]
              for t in ("cameras", "images", "keypoints", "matches", "two_view_geometries")}
    images = sorted(db.execute("SELECT name, camera_id FROM images").fetchall())
    db.close()
    return feats, raw, ver, tables, images


def test_run_matching_aliked_lightglue_agrees_with_jax(tmp_path, aliked_weights):
    """Both packages' run_matching on three demo images with the seeded
    ALIKED checkpoint and the JAX package's random LightGlue weights for
    ALIKED's 128-wide descriptors, in f32 with host verification."""
    torch.save(lightglue_params_from_jax(jlg.init_params(jax.random.PRNGKey(42), n_layers=9,
                                                         input_dim=128)),
               aliked_weights / "aliked_lightglue.pth")
    proj = _demo_project(tmp_path / "proj")
    cfg = tmp_path / "config.yaml"
    # random weights never reach LightGlue's 0.1 match score: keep every
    # mutual nearest neighbour
    cfg.write_text("general:\n  tpu:\n    device: cpu\n    dtype: float32\n"
                   "extractor:\n  max_num_keypoints: 1024\nmatcher:\n  filter_threshold: 0.0\n")
    outs = {}
    for tag, run in (("jax", jax_run_matching), ("torch", torch_run_matching)):
        feature_path, _, _ = run({
            "dir": str(proj), "outs": str(tmp_path / tag), "pipeline": "aliked+lightglue",
            "strategy": "bruteforce", "skip_reconstruction": True, "graph": False,
            "force": True, "config_file": str(cfg),
        })
        outs[tag] = _read(feature_path.parent)
    jf, jraw, jver, jtab, jimg = outs["jax"]
    tf, traw, tver, ttab, timg = outs["torch"]
    assert jf.keys() == tf.keys() and len(jf) == 3
    to_jax = {}  # per image, the JAX package's index of each port keypoint
    for name in jf:
        assert len(jf[name]["keypoints"]) > 200
        # sub-pixel refinement of f32 scores: equal as sets within 1e-4 px
        idx = _same_rows(jf[name]["keypoints"], tf[name]["keypoints"], 1e-4)
        to_jax[name] = np.argsort(idx)
        # stored as float16: one f16 ulp of the f32 values' differences
        np.testing.assert_allclose(tf[name]["descriptors"][:, idx].astype(np.float32),
                                   jf[name]["descriptors"].astype(np.float32), atol=1e-3)
        np.testing.assert_allclose(tf[name]["scores"][idx].astype(np.float32),
                                   jf[name]["scores"].astype(np.float32), rtol=1e-3)
        np.testing.assert_array_equal(tf[name]["image_size"], jf[name]["image_size"])
    def as_jax(pair, m):
        a, b = pair
        return {(int(to_jax[a][i]), int(to_jax[b][j])) for i, j in m}

    assert jraw.keys() == traw.keys() and len(jraw) == 3
    assert sum(len(m) for m in jraw.values()) > 10
    for pair in jraw:
        assert as_jax(pair, traw[pair]) == {tuple(r) for r in jraw[pair].tolist()}, pair
    assert jver.keys() == tver.keys()
    for pair in jver:
        assert as_jax(pair, tver[pair]) == {tuple(r) for r in jver[pair].tolist()}, pair
    assert ttab == jtab and timg == jimg
