"""The port stands alone: it imports without JAX, without the JAX package
and without h5py (which the GPU hosts lack), and its entry points refuse
what is not ported instead of running something else."""

import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"

_IMPORT_ALL = """
import importlib, pkgutil, sys
for blocked in ("jax", "jaxlib", "deep_image_matching_tpu", "h5py"):
    sys.modules[blocked] = None  # any import of these raises ImportError
import deep_image_matching_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(" ".join(names))
"""

# the modules of the ported slices (SuperPoint + LightGlue, then nearest
# neighbours, SuperGlue, SIFT and ORB, then RoMa, then ALIKED and LightGlue's
# two opt-in kernels)
SLICE_MODULES = (
    "models.superpoint", "models.lightglue", "ops.attention", "ops.ffn", "ops.assignment",
    "ops.nullspace", "ops.ransac",
    "ops.nn", "ops.nn_match", "ops.sinkhorn", "models.superglue", "matchers.superglue",
    "matchers.kornia_matcher", "extractors.sift", "extractors.orb",
    "ops.refiner", "models.vgg_refiner", "models.dinov2", "models.roma", "matchers.roma",
    "extractors.no_extractor", "utils.dense_to_multiview",
    "ops.bidir_attention", "ops.qkv", "ops.deform", "models.aliked", "extractors.aliked",
    "upright", "low_resolution",
)


def test_port_imports_without_jax_or_h5py():
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    names = set(res.stdout.split())
    assert len(names) >= 62
    assert {f"deep_image_matching_tpu_torch.{m}" for m in SLICE_MODULES} <= names


def test_hdf5_files_read_back_with_h5py(tmp_path):
    from deep_image_matching_tpu_torch.io import hdf5
    from deep_image_matching_tpu_torch.io.h5 import (
        get_features, list_h5_names, list_pairs, save_features, save_matches, write_features)

    rng = np.random.default_rng(0)
    path, mpath = tmp_path / "features.h5", tmp_path / "matches.h5"
    kp = {}
    for i in range(150):  # more names than one symbol-table node holds
        kp[f"im{i:03d}.jpg"] = rng.random((i + 1, 2), dtype=np.float32) * 100
    with hdf5.File(path, "w") as fd:
        for name, k in kp.items():
            write_features(fd, name, keypoints=k,
                           descriptors=rng.random((len(k), 8), dtype=np.float32),
                           scores=rng.random(len(k), dtype=np.float32),
                           image_size=np.array([640, 480]))
    save_features(path, "im000.jpg", keypoints=kp["im000.jpg"] + 1)  # rewrite one
    save_matches(mpath, "im001.jpg", "im002.jpg", np.array([[0, 1], [1, 0]]))
    save_matches(mpath, "im001.jpg", "im003.jpg", np.zeros((0, 2)))
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == sorted(kp)
        np.testing.assert_array_equal(f["im000.jpg/keypoints"][()], kp["im000.jpg"] + 1)
        assert "descriptors" not in f["im000.jpg"]
        g = f["im149.jpg"]
        np.testing.assert_array_equal(g["keypoints"][()], kp["im149.jpg"])
        assert g["descriptors"].shape == (8, 150) and g["descriptors"].dtype == np.float16
        assert g["image_size"].dtype == np.int64
    with h5py.File(mpath, "r") as f:
        np.testing.assert_array_equal(f["im001.jpg/im002.jpg"][()], [[0, 1], [1, 0]])
        assert f["im001.jpg/im003.jpg"].shape == (0, 2)
    assert list_h5_names(path) == sorted(kp)
    assert list_pairs(mpath) == [("im001.jpg", "im002.jpg"), ("im001.jpg", "im003.jpg")]
    np.testing.assert_array_equal(get_features(path, "im149.jpg")["keypoints"], kp["im149.jpg"])
    # files from other writers are refused, not misread
    other = tmp_path / "other.h5"
    with h5py.File(other, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(3))
    with pytest.raises(NotImplementedError):
        hdf5.File(other, "r")


def test_entry_points_refuse_what_is_not_ported(tmp_path):
    from deep_image_matching_tpu_torch.__main__ import run_matching
    from deep_image_matching_tpu_torch.utils.device import resolve_device

    (tmp_path / "images").mkdir()
    args = {"dir": str(tmp_path), "pipeline": "superpoint+lightglue", "strategy": "bruteforce"}
    with pytest.raises(NotImplementedError, match="reconstruction"):
        run_matching(args)
    for pipeline in ("disk+lightglue", "loftr", "se2loftr", "srif"):
        with pytest.raises(NotImplementedError, match="ported"):
            run_matching({**args, "pipeline": pipeline, "skip_reconstruction": True})
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")
