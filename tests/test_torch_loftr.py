"""LoFTR in the port against the JAX package on the CPU, at the published
widths (d_model 256, 8 heads, 4 x (self, cross) coarse layers, a 128-wide
fine stage, 5 x 5 windows) on small images: the backbone, the position
encoding, linear attention with masks, the transformer, both coarse
matchings, the fine refinement and ``match_pair`` in f32 and bf16; the
converters' exact round trips; the per-checkpoint weight cache; and
``run_matching --pipeline loftr`` on three demo images against the JAX
package with one seeded checkpoint."""

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
from deep_image_matching_tpu.models import loftr as jl
from deep_image_matching_tpu_torch.__main__ import run_matching as torch_run_matching
from deep_image_matching_tpu_torch.convert import (
    loftr_params_from_jax,
    loftr_params_from_torch,
    loftr_state_dict,
)
from deep_image_matching_tpu_torch.matchers import loftr as tml
from deep_image_matching_tpu_torch.models import loftr as tl

DEMO_IMAGES = Path(__file__).resolve().parents[1] / "notebooks" / "demo_project" / "images"


def seeded_params(init=tl.init_params, seed: int = 0, coarse_key: str = "l3_out"):
    """Seeded weights under which matches are many and follow a planted
    shift: random weights give coarse features with a large shared part
    (logits ~500, a one-hot dual softmax that sends every row to one cell),
    so the coarse output projection is scaled by 0.2; the fine stage's
    input projection and layer norms are scaled by 0.1, so that its
    soft-argmax is not pinned to a window corner (offsets of ~0.3 px)."""
    p = init(torch.Generator().manual_seed(seed))
    p["backbone"][coarse_key]["w"] = p["backbone"][coarse_key]["w"] * 0.2
    p["fine_pre"]["merge_feat"]["w"] = p["fine_pre"]["merge_feat"]["w"] * 0.1
    for lp in p["fine"]:
        for ln in ("ln1", "ln2"):
            lp[ln]["g"] = lp[ln]["g"] * 0.1
    return p


def to_jax(tree):
    """The port's tree in the JAX package's layouts (convolutions HWIO,
    dense (in, out))."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "w" and v.ndim == 4:
                out[k] = jnp.asarray(v.numpy().transpose(2, 3, 1, 0))
            elif k == "w" and v.ndim == 2:
                out[k] = jnp.asarray(v.numpy().T)
            else:
                out[k] = to_jax(v)
        return out
    if isinstance(tree, list):
        return [to_jax(v) for v in tree]
    return jnp.asarray(tree.numpy())


def shifted_pair(h: int, w: int, dx: int, dy: int, seed: int = 0):
    """A blurred random texture with 100 discs and strokes, and its copy
    shifted by (dx, dy) whole pixels, uint8 (h, w) each: view 1 at x shows
    view 0 at x + (dx, dy)."""
    rng = np.random.default_rng(seed)
    H, W = h + abs(dy), w + abs(dx)
    tex = cv2.GaussianBlur(rng.integers(0, 256, (H, W), dtype=np.uint8), (0, 0), 2)
    for _ in range(100):
        c = (int(rng.integers(0, W)), int(rng.integers(0, H)))
        if rng.random() < 0.5:
            cv2.circle(tex, c, int(rng.integers(3, 20)), int(rng.integers(0, 256)), -1)
        else:
            d = (int(rng.integers(0, W)), int(rng.integers(0, H)))
            cv2.line(tex, c, d, int(rng.integers(0, 256)), int(rng.integers(1, 4)))
    y0, x0 = max(-dy, 0), max(-dx, 0)
    return tex[y0:y0 + h, x0:x0 + w], tex[y0 + dy:y0 + dy + h, x0 + dx:x0 + dx + w]


@pytest.fixture(scope="module")
def shared():
    """One seeded tree in both packages, and the JAX package's random tree."""
    tp = seeded_params()
    jp_rand = jl.init_params(jax.random.PRNGKey(21))
    return {"torch": tp, "jax": to_jax(tp), "jax_rand": jp_rand,
            "torch_rand": loftr_params_from_jax(jp_rand)}


def _max_rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(got, np.float64) - ref).max() / max(np.abs(ref).max(), 1e-30)


def test_backbone_matches_jax(shared):
    a, _ = shifted_pair(96, 128, 16, 8)
    x = a[None, :, :, None].astype(np.float32) / 255.0
    jc, jf = jl.backbone_forward(shared["jax_rand"], jnp.asarray(x))
    tc, tf = tl.backbone_forward(shared["torch_rand"], torch.from_numpy(x))
    assert tc.shape == (1, 12, 16, 256) and tf.shape == (1, 48, 64, 128)
    # f32 convolutions summed in another order: within 2e-5 of the largest
    # magnitude (measured 2e-6)
    assert _max_rel(tc.numpy(), jc) < 2e-5 and _max_rel(tf.numpy(), jf) < 2e-5


@pytest.mark.parametrize("temp_bug_fix", [False, True])
def test_position_encoding_matches_jax(temp_bug_fix):
    ref = np.asarray(jl.sine_pos_encoding(15, 20, 256, temp_bug_fix))
    got = tl.sine_pos_encoding(15, 20, 256, temp_bug_fix).numpy()
    np.testing.assert_array_equal(got, ref)


def test_linear_attention_with_masks_matches_jax():
    rng = np.random.default_rng(0)
    B, L, S, H, D = 2, 33, 47, 8, 32
    q, k, v = (rng.normal(size=(B, n, H, D)).astype(np.float32) for n in (L, S, S))
    qm = np.ones((B, L), np.float32)
    qm[1, 30:] = 0
    km = np.ones((B, S), np.float32)
    km[:, 40:] = 0
    ref = jl.linear_attention(*(jnp.asarray(a) for a in (q, k, v, qm, km)))
    got = tl.linear_attention(*(torch.from_numpy(a) for a in (q, k, v, qm, km)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_transformer_matches_jax(shared):
    rng = np.random.default_rng(1)
    f0 = rng.normal(size=(2, 60, 256)).astype(np.float32)
    f1 = rng.normal(size=(2, 48, 256)).astype(np.float32)
    j0, j1 = jl.transformer(jnp.asarray(f0), jnp.asarray(f1), shared["jax_rand"]["coarse"],
                            None, None)
    t0, t1 = tl.transformer(torch.from_numpy(f0), torch.from_numpy(f1),
                            shared["torch_rand"]["coarse"])
    # eight layers of f32 products and layer norms: within 1e-5 of the
    # largest magnitude
    assert _max_rel(t0.numpy(), j0) < 1e-5 and _max_rel(t1.numpy(), j1) < 1e-5


def _planted_features(seed=2, B=2, h=(10, 12), w=(14, 9), C=256):
    """Coarse features where image 1's cells are a shuffled, noisy copy of
    image 0's: clear mutual nearest neighbours, many at the border."""
    rng = np.random.default_rng(seed)
    L, S = h[0] * w[0], h[1] * w[1]
    f0 = rng.normal(size=(B, L, C)).astype(np.float32)
    f1 = rng.normal(size=(B, S, C)).astype(np.float32)
    for b in range(B):
        src = rng.choice(L, size=S - 20, replace=False)
        dst = rng.choice(S, size=S - 20, replace=False)
        f1[b, dst] = f0[b, src] + 0.3 * rng.normal(size=(S - 20, C)).astype(np.float32)
    return f0 * 0.4, f1 * 0.4, (h[0], w[0]), (h[1], w[1])


@pytest.mark.parametrize("impl", ["dense", "blocked"])
def test_coarse_match_matches_jax(impl):
    f0, f1, hw0, hw1 = _planted_features()
    jfn = jl.coarse_match if impl == "dense" else jl.coarse_match_blocked
    tfn = tl.coarse_match if impl == "dense" else tl.coarse_match_blocked
    kw = {"block": 32} if impl == "blocked" else {}  # four blocks, the last padded
    ji, jj, jc, jv = jfn(jnp.asarray(f0), jnp.asarray(f1), hw0, hw1, 64, 0.0, 0.1, **kw)
    ti, tj, tc, tv = tfn(torch.from_numpy(f0), torch.from_numpy(f1), hw0, hw1, 64, 0.0, 0.1,
                         **kw)
    jv = np.asarray(jv)
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert jv.sum() >= 25
    np.testing.assert_array_equal(ti.numpy()[jv], np.asarray(ji)[jv])
    np.testing.assert_array_equal(tj.numpy()[jv], np.asarray(jj)[jv])
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-7)


def test_coarse_match_blocked_equals_dense_and_breaks_ties_low():
    f0, f1, hw0, hw1 = _planted_features(seed=3)
    dense = tl.coarse_match(torch.from_numpy(f0), torch.from_numpy(f1), hw0, hw1, 200, 0.0)
    blocked = tl.coarse_match_blocked(torch.from_numpy(f0), torch.from_numpy(f1), hw0, hw1, 200,
                                      0.0, block=16)
    v = dense[3]
    np.testing.assert_array_equal(blocked[3].numpy(), v.numpy())
    for a, b in zip(dense[:2], blocked[:2]):
        np.testing.assert_array_equal(a[v].numpy(), b[v].numpy())
    # invalid rows (confidence 0) follow in ascending row order, as
    # jax.lax.top_k returns them
    ids = dense[0][0][~v[0]].numpy()
    assert (np.diff(ids) > 0).all()


def test_fine_refine_matches_jax(shared):
    rng = np.random.default_rng(4)
    B, hc, wc, M = 2, 6, 8, 20
    ff0, ff1 = (rng.normal(size=(B, 4 * hc, 4 * wc, 128)).astype(np.float32) for _ in range(2))
    fc0, fc1 = (rng.normal(size=(B, hc * wc, 256)).astype(np.float32) for _ in range(2))
    ii, jj = (rng.integers(0, hc * wc, (B, M)).astype(np.int32) for _ in range(2))
    ref = jl.fine_refine(shared["jax"], *(jnp.asarray(a) for a in (ff0, ff1, fc0, fc1, ii, jj)),
                         None, (hc, wc), (hc, wc))
    got = tl.fine_refine(shared["torch"], *(torch.from_numpy(a) for a in (ff0, ff1, fc0, fc1)),
                         torch.from_numpy(ii).long(), torch.from_numpy(jj).long(), (hc, wc),
                         (hc, wc))
    # windows at the map border take zeros outside it in both
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def _match_both(shared, dtype="float32", impl="dense", shape=(192, 256)):
    a, b = shifted_pair(*shape, 16, -8)
    i0, i1 = a[None, :, :, None], b[None, :, :, None]
    ref = jl.match_pair(shared["jax"], jnp.asarray(i0), jnp.asarray(i1), threshold=0.0,
                        compute_dtype=dtype, coarse_impl=impl)
    got = tl.match_pair(shared["torch"], torch.from_numpy(i0), torch.from_numpy(i1),
                        threshold=0.0, compute_dtype=getattr(torch, dtype), coarse_impl=impl)
    return {k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in got.items()}


def _cell_pairs(out, b=0):
    m = out["mask"][b]
    return {tuple(r) for r in np.c_[out["keypoints0"][b][m], np.round(out["keypoints1"][b][m] / 8)]}


@pytest.mark.parametrize("impl", ["dense", "blocked"])
def test_match_pair_matches_jax(shared, impl):
    ref, got = _match_both(shared, impl=impl)
    m = ref["mask"][0]
    # the seeded weights follow the planted shift: view 1 at x shows view
    # 0 at x + (16, -8)
    d = ref["keypoints0"][0][m] - ref["keypoints1"][0][m]
    assert m.sum() > 100 and (np.abs(d - [16, -8]).max(1) < 2).mean() > 0.9
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    np.testing.assert_array_equal(got["keypoints0"], ref["keypoints0"])
    # fine offsets through two f32 transformer layers and a soft-argmax
    np.testing.assert_allclose(got["keypoints1"], ref["keypoints1"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["confidence"], ref["confidence"], rtol=1e-4, atol=1e-7)


def test_match_pair_bf16_holds_shares(shared):
    ref, got = _match_both(shared, dtype="bfloat16")
    f32 = _match_both(shared)[0]
    # bf16 convolutions and coarse layers, summed in other orders by XLA and
    # by torch, move near-tied mutual neighbours: the coarse cell pairs of
    # the two packages share at least 90 % of their union, and both keep at
    # least 90 % of the f32 run's
    a, b, c = _cell_pairs(ref), _cell_pairs(got), _cell_pairs(f32)
    assert len(a) > 100
    assert len(a & b) / len(a | b) >= 0.9
    assert len(b & c) / len(c) >= 0.9 and len(a & c) / len(c) >= 0.9


def _state_dict_with_bn_stats(seed=5):
    """A LoFTR checkpoint with the original keys and BatchNorm statistics
    that are not the identity."""
    sd = loftr_state_dict(seeded_params(seed=seed))
    rng = np.random.default_rng(seed)
    for k in list(sd):
        if k.endswith("running_var"):
            n = sd[k].shape[0]
            pre = k[: -len("running_var")]
            sd[pre + "running_var"] = torch.from_numpy(rng.uniform(0.5, 2, n).astype(np.float32))
            sd[pre + "running_mean"] = torch.from_numpy(rng.normal(0, 0.5, n).astype(np.float32))
            sd[pre + "weight"] = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    return {"matcher." + k: v for k, v in sd.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_converters_round_trip_exactly(shared):
    # the checkpoint's BatchNorms fold to the same bits in both packages
    sd = _state_dict_with_bn_stats()
    jtree = jl.params_from_torch({k: v.numpy() for k, v in sd.items()})
    _assert_trees_equal(loftr_params_from_torch(sd), loftr_params_from_jax(jtree))
    # the JAX tree -> the port's -> a checkpoint -> either package's tree
    port = loftr_params_from_jax(shared["jax_rand"])
    written = loftr_state_dict(port)
    _assert_trees_equal(jl.params_from_torch({k: v.numpy() for k, v in written.items()}),
                        shared["jax_rand"])
    _assert_trees_equal(loftr_params_from_torch(written), port)
    assert len(port["coarse"]) == 8 and len(port["fine"]) == 2


def test_checkpoints_are_cached_per_file(tmp_path, monkeypatch):
    """``pretrained: indoor`` after ``outdoor`` in one process loads the
    indoor file (the JAX package's loader returns whichever it loaded
    first), and a missing indoor file follows the weights policy."""
    from deep_image_matching_tpu_torch.utils import weights

    torch.save(loftr_state_dict(seeded_params(seed=1)), tmp_path / "loftr_outdoor.ckpt")
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setattr(tml, "_PARAMS", {})
    outdoor = tml.load_params("outdoor")
    with weights.strict(), pytest.raises(weights.MissingWeightsError):
        tml.load_params("indoor")
    torch.save({"state_dict": loftr_state_dict(seeded_params(seed=2))},
               tmp_path / "indoor_ds.ckpt")
    indoor = tml.load_params("indoor")
    assert not torch.equal(indoor["backbone"]["conv1"]["w"], outdoor["backbone"]["conv1"]["w"])
    assert tml.load_params("outdoor") is outdoor


def demo_project(root: Path, names=("sacre_coeur_A.jpg", "sacre_coeur_B.jpg")) -> Path:
    """Demo images at half their sides, and a copy of the first shifted by
    whole coarse cells (24, 16) px, so that one pair verifies."""
    (root / "images").mkdir(parents=True)
    for n in names:
        im = cv2.imread(str(DEMO_IMAGES / n))
        h, w = im.shape[:2]
        cv2.imwrite(str(root / "images" / n), cv2.resize(im, (w // 2, h // 2)))
    first = cv2.imread(str(root / "images" / names[0]))
    h, w = first.shape[:2]
    shifted = np.zeros_like(first)
    shifted[: h - 16, : w - 24] = first[16:, 24:]
    cv2.imwrite(str(root / "images" / "shifted.png"), shifted)
    return root


def read_h5(path):
    out = {}
    if path.exists():
        with h5py.File(path, "r") as f:
            f.visititems(lambda n, o: out.__setitem__(n, o[()]) if isinstance(o, h5py.Dataset)
                         else None)
    return out


def read_db(path):
    db = sqlite3.connect(str(path))
    try:
        return {t: sorted(db.execute(f"SELECT * FROM {t}").fetchall())
                for t in ("cameras", "images", "keypoints", "matches", "two_view_geometries")}
    finally:
        db.close()


def run_both(tmp_path, pipeline: str, weights_env: dict, monkeypatch, yaml_extra: str = ""):
    from deep_image_matching_tpu.matchers import loftr as jml
    from deep_image_matching_tpu.matchers import se2loftr as jsm

    # both packages load the checkpoints anew (the JAX package keeps one tree
    # a process)
    monkeypatch.setattr(jml, "_PARAMS", None)
    monkeypatch.setattr(jsm, "_SE2_PARAMS", None)
    monkeypatch.setattr(jsm, "_SE2_TRIED", False)
    monkeypatch.setattr(tml, "_PARAMS", {})
    proj = demo_project(tmp_path / "proj")
    for k, v in weights_env.items():
        monkeypatch.setenv(k, v)
    cfg = tmp_path / "config.yaml"
    cfg.write_text("general:\n  tpu:\n    device: cpu\nmatcher:\n  match_threshold: 0.0\n"
                   + yaml_extra)
    outs = {}
    for tag, run in (("jax", jax_run_matching), ("torch", torch_run_matching)):
        fp, _, _ = run({"dir": str(proj), "outs": str(tmp_path / tag), "pipeline": pipeline,
                        "strategy": "bruteforce", "skip_reconstruction": True, "graph": False,
                        "force": True, "config_file": str(cfg)})
        d = fp.parent
        outs[tag] = ({n: read_h5(d / n) for n in (
            "features.h5", "raw_matches.h5", "matches.h5", "multiview/features_multiview.h5",
            "multiview/matches_multiview.h5")},
                     read_db(d / "database.db"))
    return outs


def pair_rows(files, key):
    """Each pair of the match file ``key`` as rows (x0, y0, x1, y1) of its
    matched keypoints."""
    feats = files["multiview/features_multiview.h5" if key.startswith("multiview")
                 else "features.h5"]
    out = {}
    for pair, m in files[key].items():
        a, b = pair.split("/")
        out[pair] = np.c_[feats[f"{a}/keypoints"][m[:, 0]], feats[f"{b}/keypoints"][m[:, 1]]]
    return out


def same_rows(ref, got, tol: float = 1e-3) -> bool:
    """Whether the rows of ``got`` are those of ``ref`` in any order, each
    within ``tol`` (max norm) of its own: two matches of near-equal
    confidence may come out of the top-k in either order."""
    if ref.shape != got.shape:
        return False
    dist = np.abs(ref[:, None, :] - got[None, :, :]).max(-1)
    nearest = dist.argmin(1)
    return bool((dist[np.arange(len(ref)), nearest] <= tol).all()
                and len(set(nearest.tolist())) == len(ref))


def assert_runs_agree(outs, min_verified: int = 1):
    """Each pair's raw and verified matches and the multiview merge's
    matches the same rows of keypoints (coarse cells equal, fine offsets
    within 1e-3 px: f32 sums in other orders), the databases' rows equal."""
    (jf, jdb), (tf, tdb) = outs["jax"], outs["torch"]
    for name in jf:
        assert jf[name].keys() == tf[name].keys(), name
    for k, v in jf["features.h5"].items():
        assert v.shape == tf["features.h5"][k].shape, k
        if k.endswith("image_size"):
            np.testing.assert_array_equal(tf["features.h5"][k], v)
    for name in ("raw_matches.h5", "matches.h5", "multiview/matches_multiview.h5"):
        jrows, trows = pair_rows(jf, name), pair_rows(tf, name)
        for pair, rows in jrows.items():
            assert same_rows(rows, trows[pair]), (name, pair)
    assert len(jf["matches.h5"]) >= min_verified
    for t in ("cameras", "images", "keypoints", "matches", "two_view_geometries"):
        assert [r[:3] for r in tdb[t]] == [r[:3] for r in jdb[t]], t


def test_run_matching_loftr_agrees_with_jax(tmp_path, monkeypatch):
    wdir = tmp_path / "weights"
    wdir.mkdir()
    torch.save(loftr_state_dict(seeded_params()), wdir / "loftr_outdoor.ckpt")
    outs = run_both(tmp_path, "loftr", {"DIM_TPU_WEIGHTS_DIR": str(wdir)}, monkeypatch)
    assert_runs_agree(outs)
