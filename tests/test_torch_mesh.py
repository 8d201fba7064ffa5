"""The device mesh under ``run_matching`` on the CPU, ``parallel/mesh.py``
injected as ``_DEFAULT_MESH`` over ``cpu`` named two and three times (the
analog of stage 1 of ``__graft_entry__.dryrun_multichip``):

- superpoint+lightglue and superpoint+kornia_matcher on three synthetic
  views, device RANSAC on the CPU (``jax_ransac``, ``device_ransac: true``)
  and chunks of two pairs, so a three-slot mesh pads every chunk and a
  two-slot mesh the last one: features.h5, raw_matches.h5, matches.h5 and
  database.db byte-equal to the one-device run's;
- the same project under host MAGSAC against the JAX package pinned to a
  two-device mesh (``tests/test_torch_pipeline.py``'s comparisons);
- the extract -> match handoff on a two-slot mesh: the same files as
  without it;
- a mesh of one device runs the one-device path (no padding, no replica);
- an exception raised in one slot propagates out of ``run_matching``.
"""

import filecmp

import pytest
import torch

import jax

from deep_image_matching_tpu.__main__ import run_matching as jax_run_matching
from deep_image_matching_tpu.parallel import mesh as jax_mesh
from deep_image_matching_tpu_torch.__main__ import run_matching
from deep_image_matching_tpu_torch.extractors.extractor_base import ExtractorBase
from deep_image_matching_tpu_torch.matchers import matcher_base
from deep_image_matching_tpu_torch.matchers.kornia_matcher import NNMatcher
from deep_image_matching_tpu_torch.parallel import mesh as mesh_mod

from test_torch_pipeline import _project, _read, assert_outputs_agree, shared_weights  # noqa: F401

FILES = ("features.h5", "raw_matches.h5", "matches.h5", "database.db")
DEVICE_GV = ("general:\n  geom_verification: jax_ransac\n  tpu:\n    device: cpu\n"
             "    dtype: float32\n    device_ransac: true\n    ransac_iters: 256\n"
             "    match_batch_size: 2\n")
HOST_GV = "general:\n  tpu:\n    device: cpu\n    dtype: float32\n"
# 512 keypoints a view keep the runs short; random weights never reach
# LightGlue's 0.1 match score
EXTRA = {"superpoint+lightglue": "extractor:\n  max_keypoints: 512\n"
                                 "matcher:\n  filter_threshold: 0.0\n",
         "superpoint+kornia_matcher": "extractor:\n  max_keypoints: 512\n"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread for this file: its runs are many small ops, which
    in a test worker beside busy others wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def mesh(monkeypatch):
    """``mesh(n)`` makes ``cpu`` named ``n`` times the mesh of every run."""
    def use(n):
        monkeypatch.setattr(mesh_mod, "_DEFAULT_MESH", mesh_mod.MeshRunner(["cpu"] * n))
    return use


def _run(proj, out, cfg_text, pipeline):
    cfg = out.with_suffix(".yaml")
    cfg.write_text(cfg_text)
    feature_path, _, _ = run_matching({
        "dir": str(proj), "outs": str(out), "pipeline": pipeline, "strategy": "bruteforce",
        "skip_reconstruction": True, "graph": False, "force": True, "config_file": str(cfg)})
    return feature_path.parent


def _same_files(a, b):
    return {f: filecmp.cmp(a / f, b / f, shallow=False) for f in FILES}


@pytest.mark.parametrize("pipeline", list(EXTRA))
def test_sparse_stage_over_the_mesh(tmp_path, shared_weights, mesh, pipeline):  # noqa: F811
    proj = _project(tmp_path / "proj")
    cfg = DEVICE_GV + EXTRA[pipeline]
    one = _run(proj, tmp_path / "one", cfg, pipeline)
    for n in (2, 3):
        mesh(n)
        assert _same_files(one, _run(proj, tmp_path / f"mesh{n}", cfg, pipeline)) == dict.fromkeys(
            FILES, True), n
    # device RANSAC verified pairs, so the comparison covers its inliers
    assert _read(one)[2]
    # host MAGSAC, the JAX package on two of its CPU devices
    mesh(2)
    torch_out = _read(_run(proj, tmp_path / "torch", HOST_GV + EXTRA[pipeline], pipeline))
    prev = jax_mesh._DEFAULT_MESH
    jax_mesh._DEFAULT_MESH = jax_mesh.MeshRunner(jax.devices()[:2])
    try:
        cfg_path = tmp_path / "jax.yaml"
        cfg_path.write_text(HOST_GV + EXTRA[pipeline])
        feature_path, _, _ = jax_run_matching({
            "dir": str(proj), "outs": str(tmp_path / "jax"), "pipeline": pipeline,
            "strategy": "bruteforce", "skip_reconstruction": True, "graph": False,
            "force": True, "config_file": str(cfg_path)})
    finally:
        jax_mesh._DEFAULT_MESH = prev
    assert_outputs_agree(_read(feature_path.parent), torch_out, 3, pipeline)


def test_handoff_on_a_mesh_gives_the_same_files(tmp_path, shared_weights, mesh,  # noqa: F811
                                                monkeypatch):
    """The store takes the handoff's tensors as its copy on the extractor's
    device (and would copy them once to any other device): the files equal
    those of a run whose matcher reads the features the host path gives."""
    proj = _project(tmp_path / "proj")
    pipeline = "superpoint+lightglue"
    mesh(2)
    stores = []
    real = matcher_base._PaddedFeatureStore

    def spy(*args, **kwargs):
        stores.append(kwargs.get("handoff") is not None)
        return real(*args, **kwargs)

    monkeypatch.setattr(matcher_base, "_PaddedFeatureStore", spy)
    handed = _run(proj, tmp_path / "handoff", DEVICE_GV + EXTRA[pipeline], pipeline)
    monkeypatch.setattr(ExtractorBase, "_device_handoff_allowed", lambda self, tiled=False: False)
    host = _run(proj, tmp_path / "host", DEVICE_GV + EXTRA[pipeline], pipeline)
    assert stores == [True, False]
    assert _same_files(handed, host) == dict.fromkeys(FILES, True)


def test_one_device_mesh_takes_the_one_device_path(tmp_path, shared_weights,  # noqa: F811
                                                   monkeypatch):
    """No mesh injected and ``tpu.device: cpu``: a mesh of one device, and
    no row is padded, sharded or copied to another device's replica."""
    calls = []
    for cls, name in ((mesh_mod.MeshRunner, "pad_batch"), (mesh_mod.MeshRunner, "shard"),
                      (matcher_base._PaddedFeatureStore, "replica"),
                      (matcher_base.BatchedMatcher, "_match_sharded"),
                      (matcher_base.MatcherBase, "_move_weights")):
        real = getattr(cls, name)

        def spy(*args, real=real, name=name, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)

        monkeypatch.setattr(cls, name, spy)
    proj = _project(tmp_path / "proj")
    out = _run(proj, tmp_path / "one", DEVICE_GV + EXTRA["superpoint+lightglue"],
               "superpoint+lightglue")
    assert mesh_mod.get_default_mesh({"device": "cpu"}).devices == [torch.device("cpu")]
    assert calls == [] and _read(out)[2]


def test_an_exception_in_one_slot_propagates(tmp_path, shared_weights, mesh,  # noqa: F811
                                             monkeypatch):
    proj = _project(tmp_path / "proj")
    mesh(2)
    real = NNMatcher._match_batch_arrays
    seen = []

    def second_slot_fails(self, batch0, batch1):
        seen.append(len(seen))
        if len(seen) == 2:
            raise RuntimeError("slot 1 failed")
        return real(self, batch0, batch1)

    monkeypatch.setattr(NNMatcher, "_match_batch_arrays", second_slot_fails)
    with pytest.raises(RuntimeError, match="slot 1 failed"):
        _run(proj, tmp_path / "out", DEVICE_GV, "superpoint+kornia_matcher")
    assert seen == [0, 1]
