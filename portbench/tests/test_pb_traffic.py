"""The traffic generator: the same seed gives the same files, the pairs
follow the strategy's definition, and the shifts it reports are the
images' true geometry."""

import cv2
import numpy as np

from harness import traffic


def read_image(path):
    return cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)


def test_pairs_by_strategy():
    names = [f"v{i:02d}" for i in range(32)]
    assert len(traffic.expected_pairs(names, {"strategy": "bruteforce"})) == 496
    seq = traffic.expected_pairs(names[:40] + [f"w{i:02d}" for i in range(8)],
                                 {"strategy": "sequential", "overlap": 2})
    assert len(seq) == 77 and seq[:3] == [("v00", "v01"), ("v00", "v02"), ("v01", "v02")]


def test_same_seed_same_files(tmp_path):
    spec = {"kind": "views", "views": 3, "size": [64, 48], "planted": {"-1": [8, -8]}}
    a = traffic.make_project(tmp_path / "a", spec, 2**40 + 3, 1)
    b = traffic.make_project(tmp_path / "b", spec, 2**40 + 3, 1)
    c = traffic.make_project(tmp_path / "c", spec, 2**40 + 3, 2)
    read = [{n: read_image(p["dir"] / "images" / n) for n in p["images"]} for p in (a, b, c)]
    assert all(np.array_equal(read[0][n], read[1][n]) for n in a["images"])
    assert not all(np.array_equal(read[0][n], read[2][n]) for n in a["images"])


def test_planted_views_are_shifted_copies(tmp_path):
    spec = {"kind": "views", "views": 4, "size": [96, 64], "planted": {"-2": [16, -8], "-1": [-8, 8]}}
    p = traffic.make_project(tmp_path, spec, 7, 0)
    img = {n: read_image(p["dir"] / "images" / n).astype(int) for n in p["images"]}
    t = traffic.true_shift(p["offsets"], "view_00.png", "view_02.png")
    assert tuple(t) == (-16.0, 8.0)                      # x_b = x_a + t
    a, b = img["view_00.png"], img["view_02.png"]
    assert np.abs(b[8 + 8:40, 0:40] - a[8:32, 16:56]).max() <= 1
    assert traffic.true_shift(p["offsets"], "view_00.png", "view_01.png") is None


def test_frames_shift_by_whole_cells(tmp_path):
    spec = {"kind": "frames", "views": 5, "size": [80, 48], "step_cells": 2}
    p = traffic.make_project(tmp_path, spec, 11, 0)
    img = {n: read_image(p["dir"] / "images" / n) for n in p["images"]}
    for a, b in traffic.expected_pairs(p["images"], {"strategy": "sequential", "overlap": 2}):
        tx, ty = (int(v) for v in traffic.true_shift(p["offsets"], a, b))
        assert tx % 8 == 0 and ty % 8 == 0
        ia, ib = img[a], img[b]
        h, w = ia.shape
        ys, xs = slice(max(0, -ty), min(h, h - ty)), slice(max(0, -tx), min(w, w - tx))
        yd, xd = slice(ys.start + ty, ys.stop + ty), slice(xs.start + tx, xs.stop + tx)
        assert np.array_equal(ib[yd, xd], ia[ys, xs])
