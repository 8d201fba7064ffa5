"""The port's HDF5 module (``io/hdf5.py``) against h5py on the CPU.

h5py's files under ``libver="earliest"`` and ``"latest"`` read back equal
through the port's ``io/h5.py`` readers (gzip 9, shuffle, a chunked
multi-chunk descriptor array, resizable keypoints appended twice with the
extensible-array and fixed-array chunk indexes, groups of 1, 8, 9 and 200
links, empty datasets, float16, bool); the port's files read back equal
through h5py; an append leaves the earlier datasets' bytes and offsets as
they were and grows the file by about the bytes appended; 16385 names in
one group through both; writing 64 datasets of 4 MB retains less than 16 MB;
appends to h5py's files (in place for ``earliest``, after one copy into the
classic layout for ``latest``); and a JAX-package output folder completed
by the port's ``run_matching --resume`` with a fourth image."""

import os
import tracemalloc

import h5py
import numpy as np
import pytest

from deep_image_matching_tpu_torch.io import hdf5
from deep_image_matching_tpu_torch.io.h5 import (
    get_features, get_matches, list_h5_names, list_pairs, save_features, write_features)


def _h5py_features(path, libver, n_links, rng):
    """A features.h5 and a matches.h5 as the JAX package and the detector-free
    matcher write them; returns what they hold."""
    ref = {}
    with h5py.File(path / "features.h5", "w", libver=libver) as f:
        for i in range(n_links):
            name = f"im{i:03d}.jpg"
            k = (rng.random((i % 5 + 300, 2)) * 500).astype(np.float32)
            d = rng.random((128, len(k))).astype(np.float16)
            s = rng.random(len(k)).astype(np.float16)
            g = f.create_group(name)
            g.create_dataset("keypoints", data=k)
            # gzip 9 and shuffle, chunked in several chunks along both axes
            g.create_dataset("descriptors", data=d, compression="gzip", compression_opts=9,
                             shuffle=True, chunks=(48, 100))
            g.create_dataset("scores", data=s, compression="gzip", compression_opts=9)
            g.create_dataset("image_size", data=np.array([640, 480], np.int64))
            ref[name] = {"keypoints": k, "descriptors": d, "scores": s,
                         "image_size": np.array([640, 480])}
        # the detector-free matcher's keypoints: resizable, appended twice
        g = f.create_group("dense.jpg")
        ds = g.create_dataset("keypoints", shape=(0, 2), maxshape=(None, 2), dtype=np.float32,
                              chunks=(64, 2))
        parts = [(rng.random((n, 2)) * 500).astype(np.float32) for n in (100, 333)]
        for part in parts:
            ds.resize(ds.shape[0] + len(part), axis=0)
            ds[-len(part):] = part
        ref["dense.jpg"] = {"keypoints": np.concatenate(parts)}
        g = f.create_group("empty.jpg")
        g.create_dataset("keypoints", data=np.zeros((0, 2), np.float32))
        g.create_dataset("mask", data=rng.random(7) > 0.5)
        ref["empty.jpg"] = {"keypoints": np.zeros((0, 2), np.float32)}
    matches = {}
    with h5py.File(path / "matches.h5", "w", libver=libver) as f:
        for i in range(1, n_links):
            m = rng.integers(0, 300, (i % 7 * 10, 2)).astype(np.int32)
            f.require_group("im000.jpg").create_dataset(f"im{i:03d}.jpg", data=m,
                                                        compression="gzip", compression_opts=9)
            matches[("im000.jpg", f"im{i:03d}.jpg")] = m
    return ref, matches


@pytest.mark.parametrize("libver", ["earliest", "latest"])
@pytest.mark.parametrize("n_links", [1, 8, 9, 200])
def test_h5py_files_read_back_through_the_port(tmp_path, libver, n_links):
    ref, matches = _h5py_features(tmp_path, libver, n_links, np.random.default_rng(n_links))
    assert list_h5_names(tmp_path / "features.h5") == sorted(ref)
    for name, arrays in ref.items():
        got = get_features(tmp_path / "features.h5", name)
        for k, v in arrays.items():
            np.testing.assert_array_equal(got[k], v.astype(got[k].dtype), err_msg=f"{name}/{k}")
    with hdf5.File(tmp_path / "features.h5", "r") as f:
        mask = f["empty.jpg/mask"]
        assert mask.dtype == np.bool_ and mask.shape == (7,)
        with h5py.File(tmp_path / "features.h5", "r") as g:
            np.testing.assert_array_equal(np.asarray(mask), g["empty.jpg/mask"][()])
            assert f["im000.jpg/descriptors"].dtype == np.float16
    assert sorted(list_pairs(tmp_path / "matches.h5")) == sorted(matches)
    for (a, b), m in matches.items():
        np.testing.assert_array_equal(get_matches(tmp_path / "matches.h5", a, b), m)


def test_every_dtype_and_chunk_index_reads_back(tmp_path):
    """float16/32/64, (u)int8-64 and bool, contiguous, compact and chunked,
    the chunks indexed by a v1 B-tree, a single chunk, a fixed array (paged
    or not) and an extensible array with secondary blocks, under object
    headers with continuation blocks."""
    rng = np.random.default_rng(3)
    for libver in ("earliest", "latest"):
        ref = {}
        path = tmp_path / f"{libver}.h5"
        with h5py.File(path, "w", libver=libver) as f:
            for dt in ("f2", "f4", "f8", "i1", "u1", "i2", "u2", "i4", "u4", "i8", "u8", "?"):
                a = (rng.random((6, 7)) * 100).astype(dt)
                f.create_dataset(f"plain/{dt}", data=a)
                f.create_dataset(f"gz/{dt}", data=a, compression="gzip", shuffle=True,
                                 chunks=(4, 3))
                ref[f"plain/{dt}"] = ref[f"gz/{dt}"] = a
            big = rng.integers(0, 1 << 30, (3000, 2)).astype(np.int32)
            f.create_dataset("fixed/paged", data=big, chunks=(1, 2))
            f.create_dataset("fixed/single", data=big, chunks=big.shape, compression="gzip")
            f.create_dataset("fixed/single_plain", data=big, chunks=big.shape)
            # a compact dataset (its bytes in the layout message)
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            space = h5py.h5s.create_simple((4,))
            h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_INT64, space, dcpl=dcpl).write(
                h5py.h5s.ALL, h5py.h5s.ALL, np.arange(4))
            # attributes grow the object headers into continuation blocks
            for i in range(40):
                f["plain/f4"].attrs[f"attribute_{i:02d}"] = np.arange(16)
                f["plain"].attrs[f"attribute_{i:02d}"] = np.arange(16)
            ext = f.create_dataset("ext", shape=(0, 2), maxshape=(None, 2), dtype=np.int32,
                                   chunks=(1, 2))
            ext.resize(3000, axis=0)
            ext[:] = big
            ref.update({"fixed/paged": big, "fixed/single": big, "fixed/single_plain": big,
                        "compact": np.arange(4),
                        "ext": big})
        with hdf5.File(path, "r") as f:
            for k, v in ref.items():
                got = np.asarray(f[k])
                assert got.dtype == v.dtype and got.shape == v.shape, k
                np.testing.assert_array_equal(got, v, err_msg=f"{libver} {k}")


def test_port_files_read_back_through_h5py(tmp_path):
    rng = np.random.default_rng(4)
    ref = {}
    with hdf5.File(tmp_path / "f.h5", "w") as f:
        for dt in ("f2", "f4", "f8", "i1", "u1", "i2", "u2", "i4", "u4", "i8", "u8", "?"):
            a = (rng.random((3, 5)) * 100).astype(dt)
            f.create_dataset(f"g/{dt}", data=a)
            ref[f"g/{dt}"] = a
        f.create_dataset("g/empty", data=np.zeros((0, 2), np.float32))
        ref["g/empty"] = np.zeros((0, 2), np.float32)
    with h5py.File(tmp_path / "f.h5", "r") as f:
        for k, v in ref.items():
            got = f[k][()]
            assert got.dtype == v.dtype and got.shape == v.shape, k
            np.testing.assert_array_equal(got, v)


def _offsets(path):
    """Each dataset's (object header address, bytes) as the port reads them."""
    out = {}
    with hdf5.File(path, "r") as f:
        def walk(g):
            for k, v in g.items():
                if isinstance(v, hdf5.Dataset):
                    out[v.name] = (v._addr, np.asarray(v).tobytes())
                else:
                    walk(v)
        walk(f)
    return out


def test_append_writes_in_place(tmp_path):
    rng = np.random.default_rng(5)
    path = tmp_path / "features.h5"
    with hdf5.File(path, "w") as fd:
        for i in range(40):
            write_features(fd, f"im{i:02d}.jpg", keypoints=rng.random((500, 2), dtype=np.float32),
                           descriptors=rng.random((500, 128), dtype=np.float32))
    before, size0 = _offsets(path), os.path.getsize(path)
    raw0 = path.read_bytes()
    added = rng.random((2000, 2), dtype=np.float32)
    save_features(path, "new.jpg", keypoints=added,
                  descriptors=rng.random((2000, 128), dtype=np.float32))
    after = _offsets(path)
    for name, (addr, data) in before.items():
        assert after[name] == (addr, data), name
        # the bytes on disk have not moved either
        assert raw0[addr:addr + 16] == path.read_bytes()[addr:addr + 16]
    appended = added.nbytes + 2000 * 128 * 2
    grew = os.path.getsize(path) - size0
    assert appended <= grew < appended + 32 * 1024, grew
    # overwrite-on-rewrite unlinks the old datasets and leaves their space
    save_features(path, "im03.jpg", keypoints=added[:10])
    with h5py.File(path, "r") as f:
        assert f["im03.jpg/keypoints"].shape == (10, 2) and "descriptors" not in f["im03.jpg"]
        np.testing.assert_array_equal(f["new.jpg/keypoints"][()], added)
        assert len(f) == 41


def test_groups_take_more_than_16384_names(tmp_path):
    # h5py's dense group of 40000 links: a v2 B-tree name index two levels
    # deep over a fractal heap past its 512 KB of direct blocks, so that its
    # root indirect block has indirect children
    dense = tmp_path / "dense.h5"
    with h5py.File(dense, "w", libver="latest") as f:
        for i in range(40000):
            f.create_group(f"g{i:05d}")
    with hdf5.File(dense, "r") as f:
        assert f.keys() == [f"g{i:05d}" for i in range(40000)]
    path = tmp_path / "many.h5"
    with hdf5.File(path, "w") as f:
        for i in range(16385):
            f.create_dataset(f"n{i:05d}", data=np.array([i], np.int32))
    with h5py.File(path, "r") as f:
        assert len(f) == 16385 and f["n16384"][0] == 16384 and f["n00000"][0] == 0
    with hdf5.File(path, "r") as f:
        assert f.keys() == [f"n{i:05d}" for i in range(16385)]
        assert np.asarray(f["n12345"])[0] == 12345
    # and after an append, through h5py's own append too
    with hdf5.File(path, "a") as f:
        f.create_dataset("z", data=np.arange(3))
        del f["n00001"]
    with h5py.File(path, "a") as f:
        assert len(f) == 16385 and "n00001" not in f
        f.create_dataset("zz", data=np.arange(2))
    with hdf5.File(path, "r") as f:
        assert len(f.keys()) == 16386 and np.asarray(f["zz"]).tolist() == [0, 1]


def test_writer_keeps_no_array(tmp_path):
    arr = np.zeros((1024, 1024), np.float32)  # 4 MB
    tracemalloc.start()
    try:
        with hdf5.File(tmp_path / "big.h5", "w") as f:
            for i in range(64):
                arr[0, 0] = i
                f.create_dataset(f"d{i:02d}", data=arr)
            retained, _ = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert retained < 16 * 2**20, retained
    with h5py.File(tmp_path / "big.h5", "r") as f:
        assert len(f) == 64 and f["d63"][0, 0] == 63 and f["d63"].shape == (1024, 1024)


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_append_to_h5py_files(tmp_path, libver):
    path = tmp_path / "h.h5"
    with h5py.File(path, "w", libver=libver) as f:
        for i in range(20):
            f.create_dataset(f"a/d{i:02d}", data=np.arange(i + 1), compression="gzip")
    size0 = os.path.getsize(path)
    with hdf5.File(path, "a") as f:
        f.create_dataset("a/new", data=np.arange(3))
        del f["a/d00"]
    with h5py.File(path, "r") as f:
        assert sorted(f["a"]) == [f"d{i:02d}" for i in range(1, 20)] + ["new"]
        np.testing.assert_array_equal(f["a/d05"][()], np.arange(6))
        # earliest appends in place (the gzip chunks stay); latest was
        # copied once into the uncompressed classic layout
        assert (f["a/d05"].compression == "gzip") == (libver == "earliest")
        assert f.libver[0] == "earliest"
    assert (os.path.getsize(path) >= size0) or libver == "latest"


@pytest.mark.parametrize("writer", ["port", "h5py"])
def test_append_reads_no_member_it_does_not_touch(tmp_path, monkeypatch, writer):
    """Adding one image to a features file of 50 reads none of the other 50
    image groups, also when the index is rewritten on close; their entries
    keep the header and cached (B-tree, heap) that they held."""
    rng = np.random.default_rng(11)
    path = tmp_path / "features.h5"
    feats = {f"im{i:02d}.jpg": rng.random((20 + i, 2), dtype=np.float32) for i in range(50)}
    if writer == "port":
        with hdf5.File(path, "w") as fd:
            for name, kp in feats.items():
                write_features(fd, name, keypoints=kp)
    else:
        with h5py.File(path, "w", libver="earliest") as f:
            for name, kp in feats.items():
                f.create_dataset(f"{name}/keypoints", data=kp)
    reads = []
    real = hdf5._Reader.read_object

    def counted(self, parent, name, addr):
        reads.append(parent._child_name(name))
        return real(self, parent, name, addr)

    monkeypatch.setattr(hdf5._Reader, "read_object", counted)
    added = rng.random((7, 2), dtype=np.float32)
    save_features(path, "new.jpg", keypoints=added)
    assert reads == [], reads
    monkeypatch.setattr(hdf5._Reader, "read_object", real)
    with h5py.File(path, "r") as f:
        assert len(f) == 51
        for name, kp in feats.items():
            np.testing.assert_array_equal(f[name]["keypoints"][()], kp)
        np.testing.assert_array_equal(f["new.jpg/keypoints"][()], added)
    for name, kp in list(feats.items())[::7] + [("new.jpg", added)]:
        np.testing.assert_array_equal(get_features(path, name)["keypoints"], kp)


def test_resume_completes_a_jax_package_output(tmp_path, monkeypatch):
    """The JAX package's sift+kornia_matcher output on three demo images at a
    quarter of their size (h5py, ``libver="latest"``, gzip 9), then the
    port's ``run_matching --resume`` with a fourth image: only that image is
    extracted and only its pairs are matched, and the files equal a fresh
    port run on the four. The JAX package's features.h5 against its classic
    copy gives the size ratio of uncompressed to gzip-9 files."""
    import cv2
    from test_torch_pipeline import _read

    from deep_image_matching_tpu.__main__ import run_matching as jax_run_matching
    from deep_image_matching_tpu_torch.__main__ import run_matching as torch_run_matching
    from deep_image_matching_tpu_torch.extractors import sift as tsift
    from deep_image_matching_tpu_torch.matchers import kornia_matcher as tkm
    from test_torch_disk import DEMO_IMAGES

    proj = tmp_path / "proj"
    (proj / "images").mkdir(parents=True)
    names = sorted(p.name for p in DEMO_IMAGES.iterdir())[:4]
    for name in names:
        im = cv2.imread(str(DEMO_IMAGES / name))
        cv2.imwrite(str(tmp_path / name), cv2.resize(im, (im.shape[1] // 4, im.shape[0] // 4)))
    for name in names[:3]:
        os.replace(tmp_path / name, proj / "images" / name)
    cfg = tmp_path / "config.yaml"
    cfg.write_text("general:\n  tpu:\n    device: cpu\n    dtype: float32\n")
    args = {"dir": str(proj), "pipeline": "sift+kornia_matcher", "strategy": "bruteforce",
            "skip_reconstruction": True, "graph": False, "config_file": str(cfg)}
    feature_path, _, _ = jax_run_matching({**args, "outs": str(tmp_path / "out"), "force": True})
    with h5py.File(feature_path, "r") as f:
        assert open(feature_path, "rb").read(9)[8] >= 2  # superblock 2 or 3
        assert f[f"{names[0]}/descriptors"].compression == "gzip"
    classic = tmp_path / "classic.h5"
    classic.write_bytes(feature_path.read_bytes())
    with hdf5.File(classic, "a"):
        pass  # copies it into the classic layout
    ratio = os.path.getsize(classic) / os.path.getsize(feature_path)
    print(f"uncompressed / gzip-9 features.h5 on 3 demo images: {ratio:.3f}")
    assert 1.0 < ratio < 3.0

    os.replace(tmp_path / names[3], proj / "images" / names[3])
    extracted, matched = [], []
    orig_extract, orig_match = tsift.SIFTExtractor._extract, tkm.NNMatcher.match_all
    monkeypatch.setattr(tsift.SIFTExtractor, "_extract",
                        lambda self, image: extracted.append(image.shape) or
                        orig_extract(self, image))
    monkeypatch.setattr(tkm.NNMatcher, "match_all",
                        lambda self, pairs, *a: matched.extend(map(tuple, pairs)) or
                        orig_match(self, pairs, *a))
    torch_run_matching({**args, "outs": str(tmp_path / "out"), "resume": True})
    assert len(extracted) == 1
    assert sorted(matched) == sorted(tuple(sorted((n, names[3]))) for n in names[:3])
    torch_run_matching({**args, "outs": str(tmp_path / "fresh"), "force": True})
    rf, rraw, rver, rtab, rimg, rcam = _read(tmp_path / "out")
    ff, fraw, fver, ftab, fimg, fcam = _read(tmp_path / "fresh")
    assert rf.keys() == ff.keys() == set(names)
    for name in names:
        np.testing.assert_array_equal(rf[name]["keypoints"], ff[name]["keypoints"])
        np.testing.assert_allclose(rf[name]["descriptors"].astype(np.float32),
                                   ff[name]["descriptors"].astype(np.float32), atol=1e-3)
        np.testing.assert_array_equal(rf[name]["image_size"], ff[name]["image_size"])
    assert rraw == fraw and len(rraw) == 6
    assert rver == fver
    assert rtab == ftab and rimg == fimg and rcam == fcam
