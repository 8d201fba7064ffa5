"""The port stands alone: it imports without JAX, without the JAX package,
without h5py and without networkx (which the GPU hosts lack), and its entry
points refuse what is not ported instead of running something else."""

import json
import subprocess
import sys
from pathlib import Path

import cv2
import h5py
import numpy as np
import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"

_IMPORT_ALL = """
import importlib, pkgutil, sys
for blocked in ("jax", "jaxlib", "deep_image_matching_tpu", "h5py", "networkx"):
    sys.modules[blocked] = None  # any import of these raises ImportError
import deep_image_matching_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(" ".join(names))
"""

# the modules of the ported slices (SuperPoint + LightGlue, then nearest
# neighbours, SuperGlue, SIFT and ORB, then RoMa, then ALIKED and LightGlue's
# two opt-in kernels, then reconstruction, then tiling, then retrieval,
# upright, the exports and the host tools, then DISK, XFeat + LighterGlue,
# open SuperPoint, KeyNet + AffNet + HardNet and AdaLAM)
SLICE_MODULES = (
    "models.superpoint", "models.lightglue", "ops.attention", "ops.ffn", "ops.assignment",
    "ops.nullspace", "ops.ransac",
    "ops.nn", "ops.nn_match", "ops.sinkhorn", "models.superglue", "matchers.superglue",
    "matchers.kornia_matcher", "extractors.sift", "extractors.orb",
    "ops.refiner", "models.vgg_refiner", "models.dinov2", "models.roma", "matchers.roma",
    "extractors.no_extractor", "utils.dense_to_multiview",
    "ops.bidir_attention", "ops.qkv", "ops.deform", "models.aliked", "extractors.aliked",
    "upright", "low_resolution",
    "native", "sfm", "sfm.geometry", "sfm.ba", "sfm.incremental", "reconstruction",
    "triangulation", "io.tracks",
    "utils.tiling", "ops.tile_merge", "matchers.tiling",
    "models.retrieval", "image_retrieval", "io.h5_to_bundler", "io.h5_to_micmac",
    "io.micmac_to_h5", "io.h5_to_metashape", "io.h5_to_openmvg", "openmvg", "graph",
    "visualization", "gui", "utils.profiler",
    "extractors.superpoint_open", "models.disk", "extractors.disk", "models.xfeat",
    "extractors.xfeat", "matchers.lighterglue", "models.keynet", "models.affnet",
    "models.hardnet", "extractors.keynetaffnethardnet", "ops.adalam", "matchers.adalam",
    "io.hdf5", "models.dedode", "extractors.dedode", "models.ripe", "extractors.ripe",
    "models.liftfeat", "extractors.liftfeat",
)


def test_port_imports_without_jax_or_h5py():
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    names = set(res.stdout.split())
    assert len(names) >= 70
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
    # h5py's newer layout reads back; a structure the reader does not take
    # (a chunk index of two unlimited dims, a v2 B-tree) is refused, not misread
    other = tmp_path / "other.h5"
    with h5py.File(other, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(3))
    with hdf5.File(other, "r") as f:
        np.testing.assert_array_equal(np.asarray(f["x"]), np.arange(3))
    with h5py.File(other, "a", libver="latest") as f:
        f.create_dataset("y", data=np.zeros((2, 2)), maxshape=(None, None))
    with hdf5.File(other, "r") as f, pytest.raises(NotImplementedError):
        f["y"]


def test_entry_points_refuse_what_is_not_ported(tmp_path):
    from deep_image_matching_tpu_torch.__main__ import run_matching
    from deep_image_matching_tpu_torch.utils.device import resolve_device

    (tmp_path / "images").mkdir()
    demo = Path(__file__).resolve().parents[1] / "notebooks" / "demo_project" / "images"
    for p in sorted(demo.iterdir())[:3]:
        cv2.imwrite(str(tmp_path / "images" / p.name), cv2.resize(cv2.imread(str(p)), (320, 240)))
    args = {"dir": str(tmp_path), "pipeline": "superpoint+lightglue", "strategy": "bruteforce"}
    # --openmvg is ported: on the CPU it exports the project (no OpenMVG
    # binaries here, so the reconstruction is skipped with a warning)
    cfg = tmp_path / "cpu.yaml"
    cfg.write_text("general:\n  tpu:\n    device: cpu\n")
    feats, _, _ = run_matching({**args, "pipeline": "sift+kornia_matcher", "force": True,
                                "skip_reconstruction": True, "config_file": str(cfg),
                                "openmvg": str(tmp_path / "openmvg.yaml")})
    project = feats.parent / "openmvg" / "matches"
    sfm = json.loads((project / "sfm_data.json").read_text())
    assert len(sfm["views"]) == 3 and (project / "matches.f.bin").is_file()
    assert len(list(project.glob("*.feat"))) == 3
    # the LoFTR family and rdd_sparse+lightglue construct on the CPU (random
    # weights are allowed in the tests; se2loftr without its checkpoint runs
    # standard LoFTR)
    from deep_image_matching_tpu_torch.config import Config
    from deep_image_matching_tpu_torch.image_matching import ImageMatcher

    for pipeline, cls in (("loftr", "LOFTRMatcher"), ("se2loftr", "SE2LOFTRMatcher"),
                          ("srif", "SRIFMatcher"), ("rdd_sparse+lightglue", "LightGlueMatcher")):
        im = ImageMatcher(Config(args={**args, "pipeline": pipeline, "force": True,
                                       "config_file": str(cfg)}))
        assert type(im.matcher).__name__ == cls and im.matcher.device == torch.device("cpu")
    assert type(im.extractor).__name__ == "RDDSparseExtractor"
    # ALIKE has no random initialisation: without a checkpoint it refuses
    alike = tmp_path / "alike.yaml"
    alike.write_text("general:\n  tpu:\n    device: cpu\nextractor:\n  name: alike\n")
    with pytest.raises(FileNotFoundError, match="alike-n"):
        ImageMatcher(Config(args={**args, "pipeline": "sift+kornia_matcher", "force": True,
                                  "config_file": str(alike)}))
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")
