"""The port's upright stage against the JAX package's, on the CPU: the image
and keypoint rotations, the EXIF and ``rotations.txt`` strategies, the
2clusters probe on a set of planted rotations, the rotate-back of
features.h5, and the ``rotated_project`` scenario of
``tests/test_upright_pipeline.py`` through the port. Both packages load one
seeded SuperPoint checkpoint (the JAX package's random initialisation
carried across by the converter)."""

from pathlib import Path

import cv2
import h5py
import numpy as np
import pytest
from PIL import Image as PILImage

import jax

from deep_image_matching_tpu import upright as jup
from deep_image_matching_tpu.config import Config as JConfig
from deep_image_matching_tpu.image_matching import ImageMatcher as JImageMatcher
from deep_image_matching_tpu.models import superpoint as jsp
from deep_image_matching_tpu.utils.image import ImageList as JImageList
from deep_image_matching_tpu_torch import upright as tup
from deep_image_matching_tpu_torch.config import Config as TConfig
from deep_image_matching_tpu_torch.convert import superpoint_params_from_jax
from deep_image_matching_tpu_torch.image_matching import ImageMatcher as TImageMatcher
from deep_image_matching_tpu_torch.io.h5 import get_features, get_matches, list_pairs
from deep_image_matching_tpu_torch.io.h5 import save_features
from deep_image_matching_tpu_torch.models import superpoint as tsp
from deep_image_matching_tpu_torch.utils.image import ImageList as TImageList

DEMO_IMAGES = Path(__file__).resolve().parents[1] / "notebooks" / "demo_project" / "images"


@pytest.fixture
def sp_weights(tmp_path, monkeypatch):
    """The JAX package's seeded SuperPoint as ``superpoint_v1.pth`` for both
    packages; their default-weight caches start empty."""
    import torch

    wdir = tmp_path / "weights"
    wdir.mkdir()
    torch.save(superpoint_params_from_jax(jsp.init_params(jax.random.PRNGKey(0))),
               wdir / "superpoint_v1.pth")
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(wdir))
    monkeypatch.setattr(jsp, "_DEFAULT_PARAMS", None)
    monkeypatch.setattr(jsp, "_DEFAULT_PARAMS_RANDOM", False)
    monkeypatch.setattr(tsp, "_DEFAULT_MODEL", None)
    monkeypatch.setattr(tsp, "_DEFAULT_MODEL_RANDOM", False)
    return wdir


@pytest.mark.parametrize("deg", [0, 90, 180, 270])
def test_rotations_match_jax(deg):
    img = cv2.imread(str(DEMO_IMAGES / "sacre_coeur_B.jpg"), cv2.IMREAD_GRAYSCALE)
    rot = tup.rotate_image(img, deg)
    np.testing.assert_array_equal(rot, jup.rotate_image(img, deg))
    rh, rw = rot.shape
    rng = np.random.default_rng(deg)
    pts = np.concatenate([rng.integers(0, [rw, rh], (50, 2)),
                          [[0, 0], [rw - 1, rh - 1], [10, 20]]]).astype(np.float32)
    back = tup.rotate_keypoints_back(pts, deg, (rw, rh))
    np.testing.assert_array_equal(back, jup.rotate_keypoints_back(pts, deg, (rw, rh)))
    # the round trip: a pixel of the rotated image maps back onto itself
    for (rx, ry), (ox, oy) in zip(pts.astype(int), np.rint(back).astype(int)):
        assert img[oy, ox] == rot[ry, rx]


def _exif_project(root: Path) -> Path:
    root.mkdir(parents=True)
    img = PILImage.open(DEMO_IMAGES / "sacre_coeur_A.jpg").resize((160, 120))
    for ori in (1, 3, 6, 8, None):
        exif = PILImage.Exif()
        if ori is not None:
            exif[0x0112] = ori
        img.save(root / f"ori_{ori}.jpg", exif=exif)
    return root


def test_exif_and_custom_rotations_match_jax(tmp_path):
    root = _exif_project(tmp_path / "images")
    got = {im.name: tup._exif_rotation(im) for im in TImageList(root)}
    ref = {im.name: jup._exif_rotation(im) for im in JImageList(root)}
    assert got == ref
    assert got == {"ori_1.jpg": 0, "ori_3.jpg": 180, "ori_6.jpg": 90, "ori_8.jpg": 270,
                   "ori_None.jpg": 0}
    with pytest.raises(FileNotFoundError, match="rotations.txt"):
        tup._custom_rotations(root)
    (root / "rotations.txt").write_text("ori_1.jpg 90\nori_3.jpg -90\nbad\nori_6.jpg 450.0\n")
    assert tup._custom_rotations(root) == jup._custom_rotations(root) == {
        "ori_1.jpg": 90, "ori_3.jpg": 270, "ori_6.jpg": 90}


def _rotated_set(root: Path) -> Path:
    """The reference view and copies of it rotated by 90, 180 and 270 degrees
    clockwise (lossless PNG), plus another view: rotations to recover 270,
    180, 90 and 0."""
    root.mkdir(parents=True)
    ref = cv2.resize(cv2.imread(str(DEMO_IMAGES / "sacre_coeur_A.jpg")), (320, 240))
    cv2.imwrite(str(root / "a.png"), ref)
    for deg in (90, 180, 270):
        cv2.imwrite(str(root / f"b_rot{deg}.png"), jup.rotate_image(ref, deg))
    cv2.imwrite(str(root / "c.png"),
                cv2.resize(cv2.imread(str(DEMO_IMAGES / "sacre_coeur_B.jpg")), (240, 320)))
    return root


def test_probe_rotations_match_jax(tmp_path, sp_weights):
    root = _rotated_set(tmp_path / "images")
    ref = jup._probe_rotations(JImageList(root))
    got = tup._probe_rotations(TImageList(root), device="cpu")
    assert got == ref
    assert {k: got[k] for k in ("b_rot90.png", "b_rot180.png", "b_rot270.png")} == {
        "b_rot90.png": 270, "b_rot180.png": 180, "b_rot270.png": 90}


def test_rotate_back_features_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    paths = {k: tmp_path / f"{k}.h5" for k in ("jax", "port")}
    rotated = {"a.jpg": {"deg": 0, "rotated_wh": (40, 30)},
               "b.jpg": {"deg": 90, "rotated_wh": (30, 40)},
               "c.jpg": {"deg": 180, "rotated_wh": (40, 30)},
               "d.jpg": {"deg": 270, "rotated_wh": (30, 40)},
               "missing.jpg": {"deg": 90, "rotated_wh": (30, 40)}}
    for path in paths.values():
        for name in ("a.jpg", "b.jpg", "c.jpg", "d.jpg"):
            wh = rotated[name]["rotated_wh"]
            save_features(path, name,
                          keypoints=(rng.random((7, 2)) * wh).astype(np.float32),
                          descriptors=rng.normal(size=(7, 4)).astype(np.float32),
                          scores=rng.random(7).astype(np.float32), image_size=np.array(wh))
        rng = np.random.default_rng(1)
    jup.rotate_back_features(paths["jax"], rotated)
    tup.rotate_back_features(paths["port"], rotated)
    with h5py.File(paths["jax"], "r") as a, h5py.File(paths["port"], "r") as b:
        assert sorted(a) == sorted(b)
        for name in a:
            assert sorted(a[name]) == sorted(b[name])
            for k in a[name]:
                assert a[name][k].dtype == b[name][k].dtype, (name, k)
                np.testing.assert_array_equal(a[name][k][()], b[name][k][()], err_msg=f"{name}/{k}")
        assert tuple(b["b.jpg"]["image_size"][()]) == (40, 30)


@pytest.fixture
def rotated_project(tmp_path, image_dir):
    """``tests/test_upright_pipeline.py``'s project: a view and the same view
    rotated 90 degrees clockwise, with rotations.txt undoing it."""
    proj = tmp_path / "rot"
    (proj / "images").mkdir(parents=True)
    img = cv2.resize(cv2.imread(str(sorted(image_dir.iterdir())[0])), (400, 304))
    cv2.imwrite(str(proj / "images" / "a.jpg"), img)
    cv2.imwrite(str(proj / "images" / "b.jpg"), cv2.rotate(img, cv2.ROTATE_90_CLOCKWISE))
    (proj / "images" / "rotations.txt").write_text("a.jpg 0\nb.jpg 270\n")
    return proj


def _run(proj, upright, package, strategy="custom"):
    args = {"dir": str(proj), "pipeline": "superpoint+kornia_matcher", "strategy": "bruteforce",
            "quality": "low", "skip_reconstruction": True, "force": True, "upright": upright}
    if package == "jax":
        cfg = JConfig(args=args)
        cfg.general["upright_strategy"] = strategy
        return (cfg, *JImageMatcher(cfg).run())
    cfg = TConfig(args=args)
    cfg.general["upright_strategy"] = strategy
    cfg.general.setdefault("tpu", {})["device"] = "cpu"
    return (cfg, *TImageMatcher(cfg).run())


def test_upright_enables_rotated_matching_in_the_port(rotated_project, sp_weights):
    """The scenario of ``tests/test_upright_pipeline.py`` through the port,
    then the JAX package's run on the same project: the same rotations, and
    features.h5 holding the same keypoints in b.jpg's original frame."""
    _, _, match_path0 = _run(rotated_project, False, "port")
    pairs0 = list_pairs(match_path0)
    n_base = len(get_matches(match_path0, *pairs0[0])) if pairs0 else 0

    cfg, feature_path, match_path = _run(rotated_project, True, "port")
    pairs = list_pairs(match_path)
    assert len(pairs) == 1
    m = get_matches(match_path, *pairs[0])
    assert len(m) >= 15
    assert len(m) > 2 * max(n_base, 1)
    feats_b = get_features(feature_path, "b.jpg")
    assert tuple(feats_b["image_size"]) == (304, 400)
    k = feats_b["keypoints"]
    assert k[:, 0].max() <= 304 and k[:, 1].max() <= 400
    assert (Path(cfg.output_dir) / "upright_images" / "b.jpg").exists()

    out = Path(cfg.output_dir)
    saved = {n: get_features(feature_path, n) for n in ("a.jpg", "b.jpg")}
    _, jfeat, _ = _run(rotated_project, True, "jax")
    assert Path(jfeat).parent == out  # both write results_* of the same project
    with h5py.File(jfeat, "r") as f:
        for name, feats in saved.items():
            np.testing.assert_array_equal(f[name]["image_size"][()], feats["image_size"])
            ref = np.sort(f[name]["keypoints"][()].view([("x", "f4"), ("y", "f4")]), axis=0)
            got = np.sort(feats["keypoints"].view([("x", "f4"), ("y", "f4")]), axis=0)
            assert len(ref) == len(got)
            np.testing.assert_allclose(got.view(np.float32), ref.view(np.float32), atol=1e-3)
