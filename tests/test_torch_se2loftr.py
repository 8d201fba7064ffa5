"""SE2-LoFTR in the port against the JAX package on the CPU: the e2cnn
checkpoint's expansion and both converters bit for bit, the SE2 backbone
and ``match_pair`` on the JAX package's random tree and on a seeded
exported checkpoint, the matcher's weights (its own checkpoint only, the
policy without one) and its batches on the SE2 backbone, and
``run_matching --pipeline se2loftr`` against the JAX package."""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_image_matching_tpu.models import se2loftr as js
from deep_image_matching_tpu_torch.convert import loftr_params_from_jax, loftr_state_dict
from deep_image_matching_tpu_torch.matchers import loftr as tml
from deep_image_matching_tpu_torch.matchers.se2loftr import SE2LOFTRMatcher
from deep_image_matching_tpu_torch.models import se2loftr as ts
from deep_image_matching_tpu_torch.utils import weights
from test_se2loftr import _synthetic_e2cnn_backbone
from test_torch_loftr import (
    _assert_trees_equal,
    _cell_pairs,
    _state_dict_with_bn_stats,
    assert_runs_agree,
    run_both,
    seeded_params,
    shifted_pair,
    to_jax,
)


def se2_seeded():
    """``test_torch_loftr.seeded_params`` on the SE2 tree: its coarse output
    projection ``l3_triv`` scaled by 0.2."""
    return seeded_params(ts.init_params, coarse_key="l3_triv")


def _np(sd):
    return {k: v.numpy() if torch.is_tensor(v) else np.asarray(v) for k, v in sd.items()}


def test_e2cnn_export_and_converters_match_jax():
    """The published layout's R2Conv filters and InnerBatchNorm statistics
    expand to the JAX package's arrays exactly, with and without a cached
    filter, and both converters give the same tree bit for bit."""
    transformer = {k: v for k, v in _state_dict_with_bn_stats().items()
                   if not k.startswith("matcher.backbone.")}
    for cached in (False, True):
        sd = {**_synthetic_e2cnn_backbone(seed=3, with_cached_filter=cached), **transformer}
        ref = js.export_e2cnn_state_dict(sd)
        got = ts.export_e2cnn_state_dict(sd)
        assert ref.keys() == got.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
        _assert_trees_equal(ts.params_from_torch(sd),
                            loftr_params_from_jax(js.params_from_torch(_np(sd))))


def test_exported_checkpoint_round_trips_exactly():
    port = se2_seeded()
    written = loftr_state_dict(port)
    assert "backbone.layer3triv.weight" in written
    _assert_trees_equal(ts.params_from_torch(written), port)
    _assert_trees_equal(js.params_from_exported_torch(_np(written)), to_jax(port))


def test_se2_backbone_matches_jax():
    jp = js.init_params(jax.random.PRNGKey(0))
    a, _ = shifted_pair(96, 128, 16, 8)
    x = a[None, :, :, None].astype(np.float32) / 255.0
    jc, jf = js.backbone_forward(jp, jnp.asarray(x))
    tc, tf = ts.backbone_forward(loftr_params_from_jax(jp), torch.from_numpy(x))
    for got, ref in ((tc, jc), (tf, jf)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        # f32 convolutions summed in another order: within 2e-5 of the
        # largest magnitude
        assert np.abs(got.numpy() - ref).max() < 2e-5 * np.abs(ref).max()


@pytest.fixture(scope="module")
def se2_pair():
    tp = se2_seeded()
    a, b = shifted_pair(192, 256, 16, -8)
    i0, i1 = a[None, :, :, None], b[None, :, :, None]
    ref = js.match_pair(to_jax(tp), jnp.asarray(i0), jnp.asarray(i1), threshold=0.0)
    return tp, (a, b), {k: np.asarray(v) for k, v in ref.items()}


def _assert_match_outputs_agree(got, ref):
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    np.testing.assert_array_equal(got["keypoints0"], ref["keypoints0"])
    # fine offsets through two f32 transformer layers and a soft-argmax
    np.testing.assert_allclose(got["keypoints1"], ref["keypoints1"], rtol=0, atol=1e-3)


def test_se2_match_pair_matches_jax(se2_pair):
    tp, (a, b), ref = se2_pair
    got = ts.match_pair(tp, torch.from_numpy(a)[None, ..., None],
                        torch.from_numpy(b)[None, ..., None], threshold=0.0)
    got = {k: v.numpy() for k, v in got.items()}
    m = ref["mask"][0]
    d = ref["keypoints0"][0][m] - ref["keypoints1"][0][m]
    assert m.sum() > 100 and (np.abs(d - [16, -8]).max(1) < 2).mean() > 0.6
    _assert_match_outputs_agree(got, ref)
    # the blocked coarse matching keeps the same cell pairs
    blocked = ts.match_pair(tp, torch.from_numpy(a)[None, ..., None],
                            torch.from_numpy(b)[None, ..., None], threshold=0.0,
                            coarse_impl="blocked")
    assert _cell_pairs({k: v.numpy() for k, v in blocked.items()}) == _cell_pairs(got)


def test_se2_matcher_loads_its_own_checkpoint_and_batches_on_it(tmp_path, monkeypatch,
                                                                  se2_pair):
    """With only ``se2loftr_8rot_exported.pth`` present the matcher
    constructs under the strict policy (the JAX package first loads LoFTR's
    file and raises), and its batches run the SE2 backbone: each pair equals
    the JAX package's ``se2loftr.match_pair_impl`` on those weights."""
    import cv2

    tp, (a, b), ref = se2_pair
    wdir = tmp_path / "weights"
    wdir.mkdir()
    torch.save(loftr_state_dict(tp), wdir / "se2loftr_8rot_exported.pth")
    for name, img in (("a.png", a), ("b.png", b)):
        cv2.imwrite(str(tmp_path / name), img)
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(wdir))
    monkeypatch.setattr(tml, "_PARAMS", {})
    config = {"general": {"tpu": {"device": "cpu"}},
              "matcher": {"match_threshold": 0.0, "pair_batch_size": 2}}
    with weights.strict():
        matcher = SE2LOFTRMatcher(config)
    paths = [(tmp_path / "a.png", tmp_path / "b.png"), (tmp_path / "b.png", tmp_path / "a.png")]
    out = matcher._finish_images_batch(matcher._dispatch_images_batch(paths))
    m = ref["mask"][0]
    np.testing.assert_array_equal(out[0][0], ref["keypoints0"][0][m])
    np.testing.assert_allclose(out[0][1], ref["keypoints1"][0][m], rtol=0, atol=1e-3)
    assert len(out[1][0]) > 100


def test_se2_matcher_without_its_checkpoint_follows_the_policy(tmp_path, monkeypatch):
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setattr(tml, "_PARAMS", {})
    torch.save(loftr_state_dict(seeded_params()), tmp_path / "loftr_outdoor.ckpt")
    config = {"general": {"tpu": {"device": "cpu"}}, "matcher": {}}
    with weights.strict(), pytest.raises(weights.MissingWeightsError, match="SE2-LoFTR"):
        SE2LOFTRMatcher(config)
    records = []
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec.getMessage())
    logging.getLogger("dim_tpu_torch").addHandler(handler)
    weights.set_allow_random_weights(True)
    try:
        matcher = SE2LOFTRMatcher(config)
    finally:
        weights.set_allow_random_weights(None)
        logging.getLogger("dim_tpu_torch").removeHandler(handler)
    assert any("running standard LoFTR" in r for r in records)
    assert matcher._match_fn == matcher._loftr_batch
    assert "l3_triv" not in matcher.params["backbone"]


def test_run_matching_se2loftr_agrees_with_jax(tmp_path, monkeypatch):
    """Without an SE2 checkpoint (random weights allowed) both packages run
    standard LoFTR on LoFTR's checkpoint: the JAX package's SE2 batches run
    that model even when SE2 weights are loaded, so this is the
    configuration where the two presets compute the same thing."""
    wdir = tmp_path / "weights"
    wdir.mkdir()
    torch.save(loftr_state_dict(seeded_params(seed=3)), wdir / "loftr_outdoor.ckpt")
    outs = run_both(tmp_path, "se2loftr", {"DIM_TPU_WEIGHTS_DIR": str(wdir),
                                           "DIM_TPU_ALLOW_RANDOM_WEIGHTS": "1"}, monkeypatch)
    assert_runs_agree(outs)
