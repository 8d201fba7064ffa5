"""The device mesh's pieces on the CPU (``parallel/mesh.py`` over ``cpu``
named more than once), each against the one-device result:

- LightGlue's depth exit is taken over the whole batch: a batch whose first
  slot alone would exit a layer earlier runs as the one-device batch does,
  equal to it bit for bit and to the JAX package's ``forward``;
- device RANSAC's inliers and AdaLAM's kept matches over a mesh equal the
  one-device ones on a chunk whose later slots hold real rows;
- tile-pair jobs (the analog of ``__graft_entry__._dryrun_tiled_spmd``),
  alone and through the tiled matcher, equal the one-device jobs, each
  matching only rows of its tile;
- a LoFTR step on shifted crops, the images split over the slots, the
  weights replicated and the outputs gathered (the analog of
  ``_dryrun_detector_free_spmd``), equals the one-device step;
- ``tpu.mesh_devices`` resolves as ``parallel/mesh.py`` says, a missing
  device raises, ``_lib.launch`` gives the caller its device back, and the
  store and the matchers' weights copy once to another device.
"""

import filecmp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_image_matching_tpu.models import lightglue as jlg
from deep_image_matching_tpu_torch.config import Config
from deep_image_matching_tpu_torch.constants import GeometricVerification, TileSelection
from deep_image_matching_tpu_torch.convert import lightglue_params_from_jax
from deep_image_matching_tpu_torch.matchers import matcher_base
from deep_image_matching_tpu_torch.matchers.adalam import AdalamMatcher
from deep_image_matching_tpu_torch.matchers.kornia_matcher import NNMatcher
from deep_image_matching_tpu_torch.matchers.lighterglue import LighterGlueMatcher
from deep_image_matching_tpu_torch.matchers.lightglue import LightGlueMatcher
from deep_image_matching_tpu_torch.matchers.superglue import SuperGlueMatcher
from deep_image_matching_tpu_torch.models import lightglue as tlg
from deep_image_matching_tpu_torch.models import loftr as tl
from deep_image_matching_tpu_torch.ops import _lib
from deep_image_matching_tpu_torch.parallel import mesh as mesh_mod
from deep_image_matching_tpu_torch.parallel.mesh import MeshRunner

from test_torch_loftr import seeded_params

CPU = torch.device("cpu")
META = torch.device("meta")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread for this file: its runs are many small ops, which
    in a test worker beside busy others wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n):
    return MeshRunner(["cpu"] * n)


def test_mesh_pads_splits_and_gathers():
    mesh = _mesh(3)
    rows = np.arange(10).reshape(5, 2)
    padded = mesh.pad_batch({"a": rows, "b": torch.from_numpy(rows)})
    np.testing.assert_array_equal(padded["a"], np.r_[rows, rows[-1:]])
    assert torch.equal(padded["b"], torch.from_numpy(padded["a"]))
    assert [s for _, s in mesh.slots(5)] == [slice(0, 2), slice(2, 4), slice(4, 6)]
    assert mesh.real_rows(5) == [2, 2, 1] and mesh.real_rows(4) == [2, 2, 0]
    parts = mesh.shard(rows)
    assert [p.shape[0] for p in parts] == [2, 2, 2]
    assert torch.equal(mesh.gather(parts, 5, CPU), torch.from_numpy(rows))
    assert mesh.pad_batch(rows[:3]) is not None and _mesh(1).pad_batch(rows) is rows
    tree = {"w": torch.ones(2)}
    assert mesh.distinct == [CPU] and mesh.replicate(tree, CPU) == {CPU: tree}


# -- (b) LightGlue's depth exit over the whole batch ---------------------------

B, K, DIM, LAYERS = 4, 128, 64, 3


def _depth_params():
    """Token-confidence logits offset so that after layer 0 the rows'
    confident ratios are 0.42, 0.53, 0.39 and 0.40 and after layer 1 all
    exceed 0.96."""
    p = jlg.init_params(jax.random.PRNGKey(1), n_layers=LAYERS, dim=DIM, num_heads=4,
                        input_dim=DIM)
    layers = dict(p["layers"])
    layers["token"] = {**layers["token"],
                       "b": layers["token"]["b"].at[0].set(2.2).at[1].set(4.0)}
    return {**p, "layers": layers}


def _depth_inputs():
    """Image 1 holds image 0's keypoints permuted and shifted, with noisy
    copies of its descriptors; row 1 has 28 padded keypoints."""
    rng = np.random.default_rng(0)
    kpts0 = (rng.random((B, K, 2)) * [320, 240]).astype(np.float32)
    perm = np.stack([rng.permutation(K) for _ in range(B)])
    kpts1 = np.take_along_axis(kpts0, perm[..., None], 1) + np.float32([12, -8])
    desc0 = rng.normal(size=(B, K, DIM)).astype(np.float32)
    desc0 /= np.linalg.norm(desc0, axis=-1, keepdims=True)
    desc1 = np.take_along_axis(desc0, perm[..., None], 1)
    desc1 = desc1 + 0.1 * rng.normal(size=desc1.shape).astype(np.float32)
    mask0 = np.ones((B, K), bool)
    mask0[1, 100:] = False
    mask1 = np.take_along_axis(mask0, perm, 1)
    size = np.tile(np.float32([[320, 240]]), (B, 1))
    return kpts0, kpts1, desc0, desc1, mask0, mask1, size, size


def test_depth_exit_is_decided_over_every_slot():
    """depth_confidence 0.41 lies between the two halves' ratios after layer
    0: the first half alone exits there, the whole batch after layer 1. Two
    slots hold a half each, three slots pad the batch to six rows."""
    params = _depth_params()
    model = tlg.LightGlue(n_layers=LAYERS, dim=DIM, num_heads=4, input_dim=DIM)
    model.load_state_dict(lightglue_params_from_jax(params))
    model.eval()
    arrays = _depth_inputs()
    inputs = [torch.from_numpy(a) for a in arrays]
    kw = dict(filter_threshold=0.0, depth_confidence=0.41, width_confidence=0.99,
              compute_dtype=torch.float32)
    one = tlg.forward(model, *inputs, **kw)
    assert one["layers_run"] == 2
    assert tlg.forward(model, *(x[:2] for x in inputs), **kw)["layers_run"] == 1
    for n in (2, 3):
        mesh = _mesh(n)
        shards = [(model, *slot) for slot in zip(*(mesh.shard(x) for x in inputs))]
        outs = tlg.forward_shards(shards, mesh.real_rows(B), **kw)
        assert [o["layers_run"] for o in outs] == [2] * n
        for key in ("matches0", "matching_scores0", "valid0"):
            assert torch.equal(mesh.gather([o[key] for o in outs], B, CPU), one[key]), (n, key)
    ref = jlg.forward(params, *(jnp.asarray(a) for a in arrays), num_heads=4,
                      compute_dtype="float32", attn_impl="xla", assignment_impl="dense", **{
                          k: v for k, v in kw.items() if k != "compute_dtype"})
    assert int(ref["layers_run"]) == 2
    v = np.asarray(ref["valid0"])
    np.testing.assert_array_equal(one["valid0"].numpy(), v)
    np.testing.assert_array_equal(one["matches0"].numpy(), np.asarray(ref["matches0"]))
    # f32 on both sides, summation order differs
    np.testing.assert_allclose(one["matching_scores0"].numpy()[v],
                               np.asarray(ref["matching_scores0"])[v], atol=1e-4)
    assert v.sum() > 20


# -- (c) the draws: device RANSAC and AdaLAM ----------------------------------

def _views(n_img=5, n=300, D=32, seed=0):
    """``n`` 3D points seen by ``n_img`` cameras turning about the vertical
    axis, a quarter of each view's keypoints replaced by random ones (the
    outliers), and one descriptor table with a little noise per view, so
    that descriptor row r matches row r."""
    rng = np.random.default_rng(seed)
    Kmat = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    X = np.c_[rng.uniform(-2, 2, (n, 2)), rng.uniform(4, 8, n)]
    table = rng.normal(size=(n, D))
    cache = {}
    for i in range(n_img):
        a = 0.04 * i
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        x = (Kmat @ (R @ X.T + np.array([[0.3 * i], [0.02 * i], [0.0]]))).T
        kpts = x[:, :2] / x[:, 2:]
        out = rng.random(n) < 0.25
        kpts[out] = rng.uniform([0, 0], [640, 480], (out.sum(), 2))
        desc = table + 0.05 * rng.normal(size=table.shape)
        cache[f"im{i}"] = {
            "keypoints": kpts.astype(np.float32),
            "descriptors": (desc / np.linalg.norm(desc, axis=1, keepdims=True)).astype(np.float32),
            "scores": np.ones(n, np.float32), "image_size": np.array([640, 480])}
    return cache


@pytest.mark.parametrize("kind", ["ransac", "adalam"])
def test_draws_cover_the_chunk(kind):
    """A chunk of five pairs: two slots take rows 0-2 and 3-4 (one padding
    row), three slots 0-1, 2-3 and 4 (one padding row). RANSAC's inliers
    (bit 17 of the packed result) and AdaLAM's kept matches (bit 16) equal
    the one-device ones, and every row keeps some."""
    cache = _views()
    names = sorted(cache)
    store = matcher_base._PaddedFeatureStore("unused.h5", names, CPU, cache=cache)
    chunk = [(a, b) for i, a in enumerate(names) for b in names[i + 1:]][:5]
    if kind == "ransac":
        cls, bit, gv = NNMatcher, 17, True
        conf = {"general": {"geom_verification": GeometricVerification.JAX_RANSAC,
                            "tpu": {"device": "cpu", "device_ransac": True,
                                    "ransac_iters": 128}},
                "matcher": {"match_mode": "mnn"}}
    else:
        cls, bit, gv = AdalamMatcher, 16, False
        conf = {"general": {"tpu": {"device": "cpu"}}, "matcher": {"match_mode": "adalam"}}
    packed = {}
    for n in (1, 2, 3):
        matcher = cls(conf)
        matcher.mesh = _mesh(n)
        packed[n] = matcher._dispatch_chunk(chunk, store, gv)[2]
    assert torch.equal(packed[2], packed[1]) and torch.equal(packed[3], packed[1])
    kept = ((packed[1] >> bit) & 1).sum(1)
    assert bool((kept > 100).all()), kept


# -- (d) tile-pair jobs -------------------------------------------------------

def _tiled_cache(n_img=4, n_kpts=96, D=32, n_tiles=4, seed=1):
    """One shared descriptor table: within a tile mask the mutual nearest
    neighbours are the identity on that tile's rows (the JAX dry run's)."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n_kpts, D)).astype(np.float32)
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    return {f"im{i}": {"keypoints": rng.uniform(0, 256, (n_kpts, 2)).astype(np.float32),
                       "descriptors": table, "scores": np.ones(n_kpts, np.float32),
                       "tile_idx": (np.arange(n_kpts) % n_tiles).astype(np.float32),
                       "image_size": np.array([256, 256])}
            for i in range(n_img)}


def test_tile_pair_jobs_over_the_mesh():
    cache = _tiled_cache()
    names = sorted(cache)
    store = matcher_base._PaddedFeatureStore("unused.h5", names, CPU, cache=cache)
    jobs = 5
    i0s = [j % 4 for j in range(jobs)]
    i1s = [(j + 1) % 4 for j in range(jobs)]
    tiles = [float(j % 4) for j in range(jobs)]
    matcher = NNMatcher({"general": {"tpu": {"device": "cpu"}},
                         "matcher": {"match_mode": "smnn", "th": 0.95}})
    t = torch.tensor(tiles)
    m1, v1 = matcher._match_batch_arrays(store.gather_tiled(torch.tensor(i0s), t),
                                         store.gather_tiled(torch.tensor(i1s), t))
    for n in (2, 3):
        matcher.mesh = _mesh(n)
        m, v = matcher._match_sharded(store, i0s, i1s, tiles, tiles)
        assert torch.equal(v, v1) and torch.equal(torch.where(v, m, -1), torch.where(v1, m1, -1))
    per_job = v1.sum(1)
    assert bool((per_job > 0).all()), per_job
    tidx = cache[names[0]]["tile_idx"]
    for j in range(jobs):
        assert (tidx[torch.nonzero(v1[j])[:, 0].numpy()] == tiles[j]).all()


def test_tiled_matcher_over_the_mesh(tmp_path):
    """``_match_all_tiled`` with every tile pair of every image pair
    (``exhaustive``), device RANSAC on the unions: the match files and the
    verified counts of a two- and a three-slot mesh equal the one-device
    ones. Four views of one scene (``_views``) cut into four tiles,
    keypoint r in tile r % 4."""
    cache = _views(n_img=4, n=256)
    for f in cache.values():
        f["tile_idx"] = (np.arange(256) % 4).astype(np.float32)
    names = sorted(cache)
    pairs = [(a, b) for i, a in enumerate(names) for b in names[i + 1:]]
    results = {}
    for n in (1, 2, 3):
        matcher = NNMatcher({
            "general": {"tile_selection": TileSelection.EXHAUSTIVE, "tile_size": (320, 240),
                        "tile_overlap": 0, "geom_verification": GeometricVerification.JAX_RANSAC,
                        "tpu": {"device": "cpu", "device_ransac": True, "ransac_iters": 64,
                                "match_batch_size": 7}},
            "matcher": {"match_mode": "smnn", "th": 0.95}})
        matcher.mesh = _mesh(n)
        matcher.feature_cache = cache
        (tmp_path / str(n)).mkdir()
        results[n] = matcher.match_all(pairs, tmp_path / "unused.h5",
                                       tmp_path / str(n) / "matches.h5")
    assert sum(v > 0 for v in results[1].values()) >= 3
    for n in (2, 3):
        assert results[n] == results[1]
        for f in ("raw_matches.h5", "matches.h5"):
            assert filecmp.cmp(tmp_path / "1" / f, tmp_path / str(n) / f, shallow=False), (n, f)


# -- (e) a detector-free step --------------------------------------------------

def test_loftr_step_over_the_mesh():
    """Four pairs of 64 x 64 crops of one smooth texture, the second crop
    shifted by (4, 2) px; two slots of two pairs (at one image a slot the
    CPU's convolutions take another route, and the outputs agree only to
    rounding). Seeded weights (``tests/test_torch_loftr.py``), so matches
    are many."""
    rng = np.random.default_rng(3)
    base = rng.random((80, 80)).astype(np.float32)
    k = np.ones(5, np.float32) / 5.0
    for _ in range(2):
        base = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, base)
        base = np.apply_along_axis(lambda c: np.convolve(c, k, mode="same"), 0, base)
    im0 = torch.from_numpy(np.stack([base[j:j + 64, :64] for j in range(4)])[..., None].copy())
    im1 = torch.from_numpy(np.stack([base[j + 4:j + 68, 2:66] for j in range(4)])[..., None].copy())
    params = seeded_params()
    one = tl.match_pair(params, im0, im1, max_matches=128, threshold=0.0)
    mesh = _mesh(2)
    weights = mesh.replicate(params, CPU)
    outs = [tl.match_pair(weights[dev], a, b, max_matches=128, threshold=0.0)
            for (dev, _), a, b in zip(mesh.slots(4), mesh.shard(im0), mesh.shard(im1))]
    for key in ("keypoints0", "keypoints1", "confidence", "mask"):
        assert torch.equal(mesh.gather([o[key] for o in outs], 4, CPU), one[key]), key
    assert bool((one["mask"].sum(1) > 0).all())


# -- (f) configuration, failures, replicas --------------------------------------

def test_mesh_devices_resolve(monkeypatch, tmp_path):
    md = mesh_mod.mesh_devices
    assert md({"device": "cpu"}) == [CPU]
    assert mesh_mod.get_default_mesh({"device": "cpu"}).devices == [CPU]
    with pytest.raises(ValueError, match="counts CUDA devices"):
        md({"device": "cpu", "mesh_devices": 2})
    with pytest.raises(RuntimeError, match="CUDA"):  # this host has no card
        md({"device": "auto"})
    with pytest.raises(RuntimeError, match="CUDA"):
        md({"mesh_devices": 1})
    with pytest.raises(RuntimeError, match="missing"):
        MeshRunner(["cpu", "cuda:0"])
    for bad in (0, True, "two"):
        with pytest.raises(ValueError, match="positive integer"):
            md({"device": "cuda", "mesh_devices": bad})
    (tmp_path / "images").mkdir()
    cfg = tmp_path / "c.yaml"
    cfg.write_text("general:\n  tpu:\n    mesh_devices: two\n")
    with pytest.raises(ValueError, match="mesh_devices"):
        Config(args={"dir": str(tmp_path), "pipeline": "sift+kornia_matcher",
                     "config_file": str(cfg)})
    # a host with two cards, as torch.cuda would report it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert md({}) == cards and md({"device": "cuda"}) == cards
    assert md({"device": "cuda:1"}) == cards[1:]
    assert md({"mesh_devices": 1}) == cards[:1] and md({"mesh_devices": 2}) == cards
    with pytest.raises(RuntimeError, match="2 CUDA"):
        md({"mesh_devices": 3})
    with pytest.raises(RuntimeError, match="cuda:2 is missing"):
        MeshRunner(["cuda:0", "cuda:2"])
    twice = MeshRunner(["cuda", "cuda:0"])
    assert twice.devices == [cards[0]] * 2 and twice.distinct == cards[:1]


def test_launch_gives_the_caller_its_device_back(monkeypatch):
    """The C launchers select their tensors' device and leave it selected;
    ``_lib.launch`` selects the caller's again, also when a launch fails."""
    current = {"index": 0}

    class Launchers:
        @staticmethod
        def dim_ok(device):
            current["index"] = device
            return 0

        @staticmethod
        def dim_fails(device):
            current["index"] = device
            return 700

    monkeypatch.setattr(_lib, "lib", Launchers)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current["index"])
    monkeypatch.setattr(torch.cuda, "set_device", lambda index: current.update(index=index))
    monkeypatch.setitem(_lib.LAUNCHES, "nn", 0)
    _lib.launch("nn", "dim_ok", 1)
    assert current["index"] == 0 and _lib.LAUNCHES["nn"] == 1
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _lib.launch("nn", "dim_fails", 1)
    assert current["index"] == 0 and _lib.LAUNCHES["nn"] == 1


def test_store_and_weights_copy_once_to_another_device():
    """The store's tensors and each matcher's weights on another device
    (``meta`` stands for a second card): made once, the originals left where
    they were; on the store's and the matcher's own device, no copy."""
    store = matcher_base._PaddedFeatureStore("unused.h5", ["im0", "im1"], CPU,
                                             cache=dict(list(_tiled_cache().items())[:2]))
    rep = store.replica(META)
    assert rep is store.replica(META) and store.replica(CPU) is store
    assert {v.device for v in rep.dev.values()} == {META} and rep.tile_idx.device == META
    assert {v.device for v in store.dev.values()} == {CPU}
    conf = {"general": {"tpu": {"device": "cpu", "dtype": "float32"}}}
    for cls in (LightGlueMatcher, LighterGlueMatcher, SuperGlueMatcher):
        matcher = cls(conf)
        copy = matcher._replica(META)
        assert copy is matcher._replica(META) and matcher._replica(CPU) is matcher
        assert copy.device == META and matcher.device == CPU
        if cls is SuperGlueMatcher:
            assert {t.device for t in copy.params.values()} == {META}
            assert {t.device for t in matcher.params.values()} == {CPU}
        else:
            assert {p.device for p in copy.model.parameters()} == {META}
            assert {p.device for p in matcher.model.parameters()} == {CPU}
