"""The port's exporters against the JAX package's on the same features.h5 /
matches.h5: every file each writes (Bundler, Metashape, MicMac, OpenMVG) is
byte-equal, the MicMac import reads back the same tie points, and the CLI's
``--openmvg`` writes the same project; then the host tools: the match plots
equal the JAX package's, ``--gui`` and the profiler trace. The cases follow
``tests/test_io_exports.py``; the h5 files are written by the port's
``io/hdf5.py``, which h5py reads."""

from pathlib import Path

import cv2
import h5py
import numpy as np
import pytest

from deep_image_matching_tpu.io import h5_to_bundler as jbundler
from deep_image_matching_tpu.io import h5_to_metashape as jmeta
from deep_image_matching_tpu.io import h5_to_micmac as jmicmac
from deep_image_matching_tpu.io import h5_to_openmvg as jopenmvg
from deep_image_matching_tpu.io import micmac_to_h5 as jimport
from deep_image_matching_tpu_torch.io import h5_to_bundler as tbundler
from deep_image_matching_tpu_torch.io import h5_to_metashape as tmeta
from deep_image_matching_tpu_torch.io import h5_to_micmac as tmicmac
from deep_image_matching_tpu_torch.io import h5_to_openmvg as topenmvg
from deep_image_matching_tpu_torch.io import micmac_to_h5 as timport
from deep_image_matching_tpu_torch.io.h5 import save_features, save_matches

DEMO_IMAGES = Path(__file__).resolve().parents[1] / "notebooks" / "demo_project" / "images"


def _tree(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _assert_same_tree(a: Path, b: Path) -> None:
    ta, tb = _tree(a), _tree(b)
    assert ta.keys() == tb.keys()
    assert ta, "nothing was written"
    for k in ta:
        assert ta[k] == tb[k], k


def _toy(tmp_path, image_dir, case: str):
    """features.h5 / matches.h5 over three images (the cases of
    ``tests/test_io_exports.py``)."""
    names = sorted(p.name for p in image_dir.iterdir())[:3]
    feature_path, match_path = tmp_path / "features.h5", tmp_path / "matches.h5"
    rng = np.random.default_rng({"chain": 0, "merge": 3, "gate": 4}[case])
    n = 50 if case == "chain" else 10
    for i, name in enumerate(names):
        h, w = cv2.imread(str(image_dir / name)).shape[:2]
        if case == "chain":
            kpts = rng.uniform([0, 0], [w - 1, h - 1], size=(n, 2)).astype(np.float32)
            descs = rng.normal(size=(n, 64)).astype(np.float32)
        else:
            kpts = rng.uniform([10, 10], [w - 10, h - 10], (n, 2)).astype(np.float32)
            if case == "merge":
                descs = rng.normal(size=(n, 8)).astype(np.float32)
                descs[1] = descs[0]
            else:
                descs = np.zeros((n, 8), np.float32)
                descs[np.arange(n), np.arange(n) % 8] = 1.0
            if i == 1:
                kpts[1] = kpts[0] + 0.4
                if case == "gate":
                    descs[1, :] = 0.0
                    descs[1, 7] = 1.0
        save_features(feature_path, name, keypoints=kpts, descriptors=descs,
                      scores=rng.random(n).astype(np.float32), image_size=np.array([w, h]))
    if case == "chain":
        save_matches(match_path, names[0], names[1], np.stack([np.arange(30)] * 2, 1))
        save_matches(match_path, names[1], names[2], np.stack([np.arange(20)] * 2, 1))
    else:
        save_matches(match_path, names[0], names[1], np.array([[0, 0]]))
        save_matches(match_path, names[1], names[2], np.array([[1, 0]]))
    return names, feature_path, match_path


BUNDLER_CASES = {
    "chain": ("chain", {}),
    "chain_descriptors": ("chain", {"use_descriptors": True}),
    "merge": ("merge", {"px_tolerance": 1.0, "use_descriptors": True}),
    "no_merge": ("merge", {"px_tolerance": 0.0}),
    "gate": ("gate", {"px_tolerance": 1.0, "use_descriptors": True,
                      "descriptor_threshold": 0.8}),
    "cameras": ("chain", {"camera_config": True}),
}


@pytest.mark.parametrize("case", list(BUNDLER_CASES))
@pytest.mark.parametrize("fmt", ["bundler", "metashape"])
def test_bundler_and_metashape_exports_equal_jax(tmp_path, image_dir, fmt, case):
    data, kw = BUNDLER_CASES[case]
    names, feats, matches = _toy(tmp_path, image_dir, data)
    kw = dict(kw)
    if kw.pop("camera_config", False):
        cfg = tmp_path / "cameras.yaml"
        cfg.write_text("general:\n  single_camera: false\n"
                       f"cam0:\n  images: \"{names[0]}\"\n"
                       "  intrinsics: [1234.5, 0, 0, 0.01, -0.002]\n")
        kw["camera_config_path"] = cfg
    fn = {"bundler": (jbundler.export_to_bundler, tbundler.export_to_bundler),
          "metashape": (jmeta.export_to_metashape, tmeta.export_to_metashape)}[fmt]
    out_j = fn[0](image_dir, feats, matches, tmp_path / "jax", **kw)
    out_t = fn[1](image_dir, feats, matches, tmp_path / "port", **kw)
    assert out_t.name == out_j.name
    _assert_same_tree(tmp_path / "jax", tmp_path / "port")


def _datasets(f) -> dict:
    out = {}
    f.visititems(lambda k, v: out.update({k: v[()]}) if isinstance(v, h5py.Dataset) else None)
    return out


def test_micmac_export_and_import_equal_jax(tmp_path, image_dir):
    names, feats, matches = _toy(tmp_path, image_dir, "chain")
    # an empty pair: both write MicMac's one dummy point
    save_matches(matches, names[0], names[2], np.zeros((0, 2)))
    out_j = jmicmac.export_to_micmac(image_dir, feats, matches, tmp_path / "jax")
    out_t = tmicmac.export_to_micmac(image_dir, feats, matches, tmp_path / "port")
    _assert_same_tree(out_j, out_t)
    for a, b in [(names[0], names[1]), (names[2], names[1]), ("x.jpg", names[0])]:
        for got, ref in zip(tmicmac.get_matched_coords(feats, matches, a, b),
                            jmicmac.get_matched_coords(feats, matches, a, b)):
            np.testing.assert_array_equal(got, ref)

    # the Homol tree back into h5: the same datasets through either importer
    jf, jm = jimport.micmac_to_h5(out_j / "Homol", tmp_path / "jf.h5", tmp_path / "jm.h5")
    tf, tm = timport.micmac_to_h5(out_t / "Homol", tmp_path / "tf.h5", tmp_path / "tm.h5")
    for ja, ta in ((jf, tf), (jm, tm)):
        with h5py.File(ja, "r") as a, h5py.File(ta, "r") as b:
            items_a, items_b = _datasets(a), _datasets(b)
            assert items_a.keys() == items_b.keys()
            for k in items_a:
                assert items_a[k].dtype == items_b[k].dtype, k
                np.testing.assert_array_equal(items_a[k], items_b[k], err_msg=k)
    # and the Homol reader of the Metashape module
    f = out_t / "Homol" / f"Pastis{names[0]}" / f"{names[1]}.txt"
    for got, ref in zip(tmeta.read_Homol_matches(f), jmeta.read_Homol_matches(f)):
        np.testing.assert_array_equal(got, ref)
    img_j = jmeta.show_micmac_matches(f, image_dir)
    np.testing.assert_array_equal(tmeta.show_micmac_matches(f, image_dir), img_j)


@pytest.mark.parametrize("cameras", ["default", "yaml"])
def test_openmvg_export_equals_jax(tmp_path, image_dir, cameras):
    names, feats, matches = _toy(tmp_path, image_dir, "chain")
    cfg = None
    if cameras == "yaml":
        cfg = tmp_path / "cameras.yaml"
        cfg.write_text("general:\n  single_camera: true\n  openmvg_camera_model: pinhole_brown_t2\n"
                       f"cam0:\n  images: \"{names[0]}\"\n  camera_model: simple-radial\n"
                       "  openmvg_camera_model: pinhole\n")
    out_j = jopenmvg.export_to_openmvg(image_dir, feats, matches, tmp_path / "jax",
                                       camera_config_path=cfg)
    out_t = topenmvg.export_to_openmvg(image_dir, feats, matches, tmp_path / "port",
                                       camera_config_path=cfg)
    _assert_same_tree(out_j, out_t)
    assert (out_t / "matches" / "matches.f.bin").exists()
    assert len(list((out_t / "matches").glob("*.feat"))) == 3


def test_openmvg_runner_without_binaries(tmp_path, monkeypatch):
    """No ``openMVG_main_SfM``: both runners warn and skip."""
    from deep_image_matching_tpu import openmvg as jrun
    from deep_image_matching_tpu_torch import openmvg as trun

    monkeypatch.setenv("PATH", str(tmp_path))
    conf = tmp_path / "openmvg.yaml"
    conf.write_text("general:\n  path_to_binaries: null\n")
    assert trun.find_openmvg_bin(str(conf)) is None and jrun.find_openmvg_bin(str(conf)) is None
    assert trun.openmvg_reconstruction(tmp_path, str(conf)) is None
    exe = tmp_path / "bin" / "openMVG_main_SfM"
    exe.parent.mkdir()
    exe.write_text("#!/bin/sh\nexit 0\n")
    exe.chmod(0o755)
    assert trun.find_openmvg_bin(str(exe.parent)) == jrun.find_openmvg_bin(str(exe.parent)) == exe


def _demo_project(root: Path, n: int = 3) -> Path:
    (root / "images").mkdir(parents=True)
    for p in sorted(DEMO_IMAGES.iterdir())[:n]:
        img = cv2.imread(str(p))
        cv2.imwrite(str(root / "images" / p.name), cv2.resize(img, (320, 240)))
    return root


def test_cli_openmvg_and_exports_of_a_run_equal_jax(tmp_path):
    """``run_matching`` with ``--openmvg`` on 3 demo images (sift, the CPU):
    the OpenMVG project it writes equals the JAX exporter's over the same
    files, and so do the other exports of that run."""
    from deep_image_matching_tpu_torch.__main__ import run_matching

    proj = _demo_project(tmp_path / "proj")
    cfg = tmp_path / "cpu.yaml"
    cfg.write_text("general:\n  tpu:\n    device: cpu\n")
    conf = tmp_path / "openmvg.yaml"
    conf.write_text("general:\n  path_to_binaries: null\n")
    feats, matches, _ = run_matching({
        "dir": str(proj), "pipeline": "sift+kornia_matcher", "strategy": "bruteforce",
        "skip_reconstruction": True, "force": True, "config_file": str(cfg),
        "openmvg": str(conf)})
    out = feats.parent
    ref = jopenmvg.export_to_openmvg(proj / "images", feats, matches, tmp_path / "jax_openmvg")
    _assert_same_tree(ref, out / "openmvg")
    for name, fn in (("bundler", "export_to_bundler"), ("metashape", "export_to_metashape")):
        mods = {"bundler": (jbundler, tbundler), "metashape": (jmeta, tmeta)}[name]
        getattr(mods[0], fn)(proj / "images", feats, matches, tmp_path / f"jax_{name}")
        getattr(mods[1], fn)(proj / "images", feats, matches, tmp_path / f"port_{name}")
        _assert_same_tree(tmp_path / f"jax_{name}", tmp_path / f"port_{name}")
    jmicmac.export_tie_points(feats, matches, tmp_path / "jax_homol")
    tmicmac.export_tie_points(feats, matches, tmp_path / "port_homol")
    _assert_same_tree(tmp_path / "jax_homol", tmp_path / "port_homol")


def test_visualization_equals_jax():
    from deep_image_matching_tpu import visualization as jviz
    from deep_image_matching_tpu_torch import visualization as tviz

    img0 = cv2.imread(str(DEMO_IMAGES / "sacre_coeur_A.jpg"))
    img1 = cv2.imread(str(DEMO_IMAGES / "sacre_coeur_B.jpg"), cv2.IMREAD_GRAYSCALE)
    rng = np.random.default_rng(7)
    k0 = rng.uniform(0, 470, (1200, 2)).astype(np.float32)
    k1 = rng.uniform(0, 610, (1200, 2)).astype(np.float32)
    np.testing.assert_array_equal(tviz.viz_matches_cv2(img0, img1, k0, k1),
                                  jviz.viz_matches_cv2(img0, img1, k0, k1))
    np.testing.assert_array_equal(tviz.viz_keypoints_cv2(img1, k1),
                                  jviz.viz_keypoints_cv2(img1, k1))


def test_gui_flag_and_profiler_trace(tmp_path, monkeypatch):
    """``--gui`` returns the dialog's arguments (the dialog itself needs a
    display: it is replaced here), and ``DIM_TPU_PROFILE`` makes
    ``run_matching`` write a Chrome trace of the set-up, the matching
    stages and the export, with the port's spans as annotations."""
    import json
    import sys

    from deep_image_matching_tpu_torch import gui, parser
    from deep_image_matching_tpu_torch.__main__ import run_matching

    picked = {"images": "imgs", "pipeline": "sift+kornia_matcher"}
    monkeypatch.setattr(gui, "gui", lambda: picked)
    monkeypatch.setattr(sys, "argv", ["dim", "--gui"])
    assert parser.parse_cli() is picked

    proj = _demo_project(tmp_path / "proj", n=2)
    cfg = tmp_path / "cpu.yaml"
    cfg.write_text("general:\n  tpu:\n    device: cpu\n")
    monkeypatch.setenv("DIM_TPU_PROFILE", str(tmp_path / "trace"))
    run_matching({"dir": str(proj), "pipeline": "sift+kornia_matcher", "strategy": "bruteforce",
                  "skip_reconstruction": True, "graph": False, "force": True,
                  "config_file": str(cfg)})
    trace = json.loads((tmp_path / "trace" / "image_matching" / "trace.json").read_text())
    assert trace["traceEvents"]
    # the port's spans appear over the operators, the export's included
    named = {e.get("name") for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"setup", "setup.matcher", "match", "match.dispatch", "export", "export.db"} <= named
