"""The extract -> match handoff on the device, in the port alone on the CPU
(the handoff is armed on every device): features.h5 written through it is
byte-equal to the host path's for SuperPoint, ALIKED, XFeat and ALIKE (at
medium quality, so that the keypoints are rescaled, over images in two
shape buckets in batches of two, so that batches come back out of order); the matcher's store
built from it equals the store read from features.h5 bit for bit, for an
untiled and a tiled (device route) extraction, a keypoint cap that is not a
multiple of 128 included; a handoff of part of the images (``--resume``) makes matching wait
for features.h5 and read it; a writer that fails raises from ``flush()`` and
from ``run_matching``."""

import filecmp
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from deep_image_matching_tpu_torch.constants import Quality, TileSelection
from deep_image_matching_tpu_torch.extractors import aliked as taliked
from deep_image_matching_tpu_torch.extractors import alike as talike
from deep_image_matching_tpu_torch.io import writer as writer_mod
from deep_image_matching_tpu_torch.io.h5 import list_h5_names
from deep_image_matching_tpu_torch.matchers import matcher_base
from deep_image_matching_tpu_torch.utils.image import ImageList

from test_torch_alike import alike_state_dict
from test_torch_aliked import aliked_state_dict

DEMO_IMAGES = Path(__file__).resolve().parents[1] / "notebooks" / "demo_project" / "images"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread for this file: its runs are many small ops, which
    in a test worker beside busy others wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def project(tmp_path):
    """Four demo images on disk, two landscape and two portrait (two shape
    buckets, the second image in the other bucket than the first)."""
    root = tmp_path / "proj"
    (root / "images").mkdir(parents=True)
    names = sorted(DEMO_IMAGES.iterdir())[:4]
    for p, size in zip(names, ((320, 240), (240, 320), (320, 240), (240, 320))):
        cv2.imwrite(str(root / "images" / p.with_suffix(".png").name),
                    cv2.resize(cv2.imread(str(p)), size, interpolation=cv2.INTER_AREA))
    return root


@pytest.fixture
def weights(tmp_path, monkeypatch):
    wdir = tmp_path / "weights"
    wdir.mkdir()
    torch.save(aliked_state_dict(), wdir / "aliked-n16rot.pth")
    torch.save(alike_state_dict("alike-n"), wdir / "alike-n.pth")
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(wdir))
    monkeypatch.setattr(taliked, "_PARAM_CACHE", {})
    monkeypatch.setattr(talike, "_PARAM_CACHE", {})
    return wdir


def _extractor(kind, max_kpts=256, tiling=TileSelection.NONE):
    from deep_image_matching_tpu_torch.extractors.alike import AlikeExtractor
    from deep_image_matching_tpu_torch.extractors.aliked import ALIKEDExtractor
    from deep_image_matching_tpu_torch.extractors.superpoint import SuperPointExtractor
    from deep_image_matching_tpu_torch.extractors.xfeat import XFeatExtractor

    cls = {"superpoint": SuperPointExtractor, "aliked": ALIKEDExtractor,
           "xfeat": XFeatExtractor, "alike": AlikeExtractor}[kind]
    return cls({"extractor": {"max_keypoints": max_kpts, "max_num_keypoints": max_kpts,
                              "n_limit": max_kpts},
                "general": {"quality": Quality.MEDIUM, "tile_selection": tiling,
                            "tile_size": (96, 80), "tile_overlap": 8,
                            "tpu": {"device": "cpu", "extract_batch_size": 2}}})


@pytest.mark.parametrize("kind", ["superpoint", "aliked", "xfeat", "alike"])
def test_handoff_h5_bytes_equal_host_path(kind, project, weights, tmp_path):
    images = list(ImageList(project / "images"))
    host = _extractor(kind)
    host.extract_batch(images, tmp_path / "host.h5")
    assert host.device_handoff is None
    dev = _extractor(kind)
    dev.feature_cache = {}
    dev.extract_batch(images, tmp_path / "dev.h5")
    handoff = dev.device_handoff
    assert handoff is not None and handoff.names == [im.name for im in images]
    assert not dev.feature_cache  # the handoff replaces the host mirror
    dev.flush()
    assert filecmp.cmp(tmp_path / "host.h5", tmp_path / "dev.h5", shallow=False)
    assert handoff.counts.min() > 20
    # the host mirrors hold the file's keypoints, padded with zeros
    from deep_image_matching_tpu_torch.io.h5 import get_features

    for i, im in enumerate(images):
        f = get_features(tmp_path / "dev.h5", im.name)
        n = handoff.counts[i]
        np.testing.assert_array_equal(handoff.kpts[i, :n], f["keypoints"])
        assert not handoff.kpts[i, n:].any()
        np.testing.assert_array_equal(handoff.image_size[i], f["image_size"])


@pytest.mark.parametrize("case", ["untiled", "untiled_cap200", "tiled"])
def test_store_from_handoff_equals_store_from_h5(case, project, tmp_path):
    tiling = TileSelection.GRID if case == "tiled" else TileSelection.NONE
    ext = _extractor("superpoint", 200 if case == "untiled_cap200" else 256, tiling)
    ext.feature_cache = {}
    images = list(ImageList(project / "images"))
    ext.extract_batch(images, tmp_path / "f.h5")
    handoff = ext.device_handoff
    assert handoff is not None and (handoff.tile_idx is not None) == (case == "tiled")
    ext.flush()
    names = [im.name for im in images][::-1][:3]   # another order, one image left out
    a = matcher_base._PaddedFeatureStore(tmp_path / "f.h5", names, CPU, handoff=handoff)
    b = matcher_base._PaddedFeatureStore(tmp_path / "f.h5", names, CPU)
    assert a.index == b.index
    assert a.kpts.shape == b.kpts.shape and a.kpts.shape[1] % 128 == 0
    for k in ("kpts", "counts", "image_size"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert getattr(a, k).dtype == getattr(b, k).dtype
    assert a.dev.keys() == b.dev.keys() and a.has_tiles == b.has_tiles == (case == "tiled")
    for k in a.dev:
        assert a.dev[k].dtype == b.dev[k].dtype and torch.equal(a.dev[k], b.dev[k]), k
    assert torch.equal(a.tile_idx, b.tile_idx)


def _run(project, tmp_path, **extra):
    from deep_image_matching_tpu_torch.__main__ import run_matching

    tmp_path.mkdir(exist_ok=True)
    cfg = tmp_path / "cpu.yaml"
    cfg.write_text("general:\n  tpu:\n    device: cpu\nextractor:\n  max_keypoints: 128\n"
                   "matcher:\n  filter_threshold: 0.0\n")
    args = {"dir": str(project), "outs": str(tmp_path / "out"),
            "pipeline": "superpoint+lightglue", "strategy": "bruteforce",
            "skip_reconstruction": True, "graph": False, "config_file": str(cfg)}
    return run_matching({**args, **extra})[0].parent


def _matches(out_dir):
    from deep_image_matching_tpu_torch.io import hdf5

    with hdf5.File(out_dir / "raw_matches.h5", "r") as f:
        return {(a, b): np.asarray(f[a][b]) for a in f for b in f[a]}


def test_partial_handoff_waits_for_features_h5(project, tmp_path, monkeypatch):
    """A first run over three images, then the fourth added and a --resume
    run: the extractor hands over the fourth image only, so matching must
    join the deferred writer and read every image from features.h5. Its new
    pairs' raw matches equal those of a fresh run over all four, whose store
    came from the handoff."""
    seen = []
    real = matcher_base._PaddedFeatureStore

    def spy(feature_path, names, device, cache=None, handoff=None):
        # with a handoff the deferred writer may still be at work on the file
        seen.append((handoff is not None,
                     handoff is None and set(names) <= set(list_h5_names(feature_path))))
        return real(feature_path, names, device, cache=cache, handoff=handoff)

    monkeypatch.setattr(matcher_base, "_PaddedFeatureStore", spy)
    fourth = sorted((project / "images").iterdir())[-1]
    held = tmp_path / fourth.name
    fourth.rename(held)
    _run(project, tmp_path, force=True)
    held.rename(fourth)
    out = _run(project, tmp_path, resume=True)
    assert seen == [(True, False), (False, True)]
    resumed = _matches(out)
    fresh = _matches(_run(project, tmp_path / "fresh", force=True))
    assert seen[-1][0] and resumed.keys() == fresh.keys() and len(fresh) == 6
    for pair in fresh:
        np.testing.assert_array_equal(resumed[pair], fresh[pair])
    assert sorted(list_h5_names(out / "features.h5")) == sorted(
        p.name for p in (project / "images").iterdir())


def test_failing_writer_raises(project, tmp_path, monkeypatch):
    def broken(fd, name, **arrays):
        raise OSError("disk full")

    monkeypatch.setattr(writer_mod, "write_features", broken)
    ext = _extractor("superpoint")
    ext.feature_cache = {}
    ext.extract_batch(list(ImageList(project / "images")), tmp_path / "f.h5")
    with pytest.raises(RuntimeError, match="feature write failed") as err:
        ext.flush()
    assert isinstance(err.value.__cause__, OSError)
    ext.flush()  # joined once: nothing left to raise
    # through run_matching: the error surfaces from the match stage
    with pytest.raises(RuntimeError, match="feature write failed"):
        _run(project, tmp_path, force=True)
