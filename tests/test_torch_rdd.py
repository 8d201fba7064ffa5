"""RDD in the port against the JAX package on the CPU: the converter's
round trip (exact), the position embedding, the multi-scale deformable
attention on five small levels (within 1e-4), the score map, the descriptor
map and the matchability at 128 x 160 (within 1e-5 of their largest
magnitude), the checkpoint loader and the weights policy.
``tests/test_torch_rdd_extract.py`` holds ``extract`` and
``tests/test_torch_rdd_pipeline.py`` ``run_matching``, each a file of its
own so that test workers take them side by side. Inputs come from a numpy
seed."""

from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_image_matching_tpu.models import rdd as jrdd
from deep_image_matching_tpu_torch.convert import rdd_params_from_jax
from deep_image_matching_tpu_torch.extractors import rdd_sparse as text
from deep_image_matching_tpu_torch.models import rdd as trdd

DEMO_IMAGES = Path(__file__).resolve().parents[1] / "notebooks" / "demo_project" / "images"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread for this file: in a test worker beside busy others
    each parallel op waits on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def params():
    """(JAX tree, its checkpoint, the port's tree from the checkpoint), with
    the JAX init's zero biases, unit norms and level embeddings redrawn so
    that every converted tensor is non-trivial."""
    p = jrdd.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)

    def redraw(tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                if k in ("b", "g") and not isinstance(v, (dict, list)):
                    base = 1.0 if k == "g" else 0.0
                    tree[k] = jnp.asarray(base + rng.normal(0, 0.05, v.shape), jnp.float32)
                else:
                    redraw(v)
        elif isinstance(tree, list):
            for v in tree:
                redraw(v)

    redraw(p)
    sd = rdd_params_from_jax(p)
    return p, sd, trdd.params_from_torch(sd)


def _walk_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _walk_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _walk_equal(x, y, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def test_rdd_converter_round_trip(params):
    p, sd, tp = params
    _walk_equal(p, jrdd.params_from_torch(sd))
    # the port's fold of the same checkpoint holds the JAX tree's values in
    # torch layouts: convolutions OIHW, linear layers (out, in)
    w = np.asarray(p["resnet"]["stages"][2][0]["conv2"]["w"]).transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(tp["resnet"]["stages"][2][0]["conv2"]["w"].numpy(), w)
    np.testing.assert_array_equal(tp["encoder"][1]["fc1"]["w"].numpy(),
                                  np.asarray(p["encoder"][1]["fc1"]["w"]).T)
    for k in ("w", "b"):
        np.testing.assert_array_equal(
            tp["match_head"]["l1"][k].numpy().reshape(-1),
            np.asarray(p["match_head"]["l1"][k]).transpose(
                *((3, 2, 0, 1) if k == "w" else (0,))).reshape(-1))
    np.testing.assert_array_equal(tp["level_embed"].numpy(), np.asarray(p["level_embed"]))


@pytest.mark.parametrize("hw", [(32, 40), (2, 3)])
def test_sine_pos_embed_matches_jax(hw):
    got = trdd.sine_pos_embed(*hw).numpy()
    ref = np.asarray(jrdd._sine_pos_embed(*hw))
    assert got.shape == ref.shape == (*hw, 256)
    np.testing.assert_allclose(got, ref, atol=2e-6)


def test_ms_deform_attn_matches_jax():
    """Five small levels, offsets large enough that samples fall outside
    the maps (zeros there), against the JAX package's per-level gathers."""
    rng = np.random.default_rng(2)
    B, C, H, P = 2, 64, 8, 4
    shapes = [(12, 16), (6, 8), (3, 4), (2, 2), (1, 1)]
    Lq = sum(h * w for h, w in shapes)
    L = len(shapes)

    def lin(ci, co, scale):
        return {"w": rng.normal(0, scale, (ci, co)).astype(np.float32),
                "b": rng.normal(0, scale, co).astype(np.float32)}

    p = {"sampling_offsets": lin(C, H * L * P * 2, 0.5),
         "attention_weights": lin(C, H * L * P, 0.3),
         "output_proj": lin(C, C, 1 / np.sqrt(C))}
    query = rng.normal(size=(B, Lq, C)).astype(np.float32)
    values = [rng.normal(size=(B, h, w, C)).astype(np.float32) for h, w in shapes]
    refs = rng.uniform(0, 1, (B, Lq, 2)).astype(np.float32)
    ref = jrdd.ms_deform_attn(jnp.asarray(query), [jnp.asarray(v) for v in values],
                              jnp.asarray(refs), jax.tree_util.tree_map(jnp.asarray, p),
                              n_heads=H, n_points=P)
    tp = {k: {"w": torch.from_numpy(v["w"].T.copy()), "b": torch.from_numpy(v["b"])}
          for k, v in p.items()}
    got = trdd.ms_deform_attn(torch.from_numpy(query), [torch.from_numpy(v) for v in values],
                              torch.from_numpy(refs), tp, n_heads=H, n_points=P)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


@pytest.fixture(scope="module")
def image():
    """One demo image at 128 x 160 (H x W) in [0, 1], with valid size 120 x 150."""
    img = cv2.imread(str(DEMO_IMAGES / "sacre_coeur_A.jpg"))[..., ::-1]
    img = cv2.resize(img, (160, 128), interpolation=cv2.INTER_AREA)
    return (img.astype(np.float32) / 255.0)[None], np.array([[120, 150]], np.int32)


def test_rdd_maps_match_jax(params, image):
    p, _, tp = params
    img, _ = image
    js = jrdd.detector_scoremap(p, jnp.asarray(img))
    ts = trdd.detector_scoremap(tp, torch.from_numpy(img))
    assert _rel(ts, js) < 1e-5
    jd, jm = jax.jit(jrdd.descriptor_forward)(p, jnp.asarray(img))
    td, tm = trdd.descriptor_forward(tp, torch.from_numpy(img))
    assert td.shape == (1, 32, 40, 256) and tm.shape == (1, 32, 40)
    assert _rel(td, jd) < 1e-5 and _rel(tm, jm) < 1e-5


@pytest.mark.parametrize("nesting", ["plain", "state_dict"])
def test_rdd_checkpoint_loader(tmp_path, monkeypatch, params, nesting):
    p, sd, tp = params
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setattr(text, "_PARAMS", None)
    monkeypatch.setattr(text, "_PARAMS_RANDOM", False)
    torch.save({"state_dict": sd} if nesting == "state_dict" else sd, tmp_path / "RDD-v1.pth")
    loaded = text.load_params()
    _walk_equal(tp, loaded)
    ext = text.RDDSparseExtractor({"extractor": {"max_num_keypoints": 300},
                                   "general": {"tpu": {"device": "cpu"}}})
    assert ext.params is not None and ext.max_keypoints == 300


def test_rdd_weights_policy(tmp_path, monkeypatch):
    from deep_image_matching_tpu_torch.utils.weights import MissingWeightsError, strict

    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(text, "_PARAMS", None)
    monkeypatch.setattr(text, "_PARAMS_RANDOM", False)
    with strict(), pytest.raises(MissingWeightsError, match="RDD"):
        text.load_params()
    a = text.load_params()           # random weights, allowed in the tests
    assert text._PARAMS_RANDOM
    b = trdd.init_params(torch.Generator().manual_seed(37))
    _walk_equal({k: v for k, v in a.items()}, b)
    with strict(), pytest.raises(MissingWeightsError):
        text.load_params()           # the cached random weights re-consult the policy
