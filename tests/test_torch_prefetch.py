"""Decode prefetch and padded batches of the port (``utils/prefetch.py``,
``ops/assemble.py``) on the CPU: prefetched images equal the inline decode
(grey and colour, with and without a resize), the pool works no more than
``DEPTH`` images ahead of the consumer and closing the generator cancels
the rest, a failed decode raises where the image is taken,
``assemble_batch`` equals padding on the host, and ``padded_batches`` runs
each bucket as it fills, bounds the images that wait, keeps every batch
within its pixel budget, halves a batch that runs out of device memory and
gives the same outputs for host arrays and device tensors."""

import threading

import cv2
import numpy as np
import pytest
import torch

from deep_image_matching_tpu_torch.ops.assemble import (assemble_batch, is_device_array,
                                                        padded_batches, unpad)
from deep_image_matching_tpu_torch.utils import prefetch
from deep_image_matching_tpu_torch.utils.image import Image, read_image
from deep_image_matching_tpu_torch.utils.prefetch import prefetch_device_images

CPU = torch.device("cpu")


@pytest.fixture
def image_dir(tmp_path):
    """Three random PNGs."""
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(120, 160), (120, 160), (90, 140)]):
        cv2.imwrite(str(tmp_path / f"im{i}.png"), rng.integers(0, 255, (h, w, 3), np.uint8))
    return tmp_path


def _halve(a):
    return cv2.resize(a, (a.shape[1] // 2, a.shape[0] // 2), interpolation=cv2.INTER_AREA)


@pytest.mark.parametrize("grayscale", [True, False])
@pytest.mark.parametrize("resize", ["none", "half"])
def test_prefetch_equals_inline_decode(image_dir, grayscale, resize):
    fn = _halve if resize == "half" else (lambda a: a)
    imgs = [Image(p) for p in sorted(image_dir.glob("*.png"))]
    got = list(prefetch_device_images(imgs, grayscale, fn, CPU))
    assert len(got) == len(imgs)
    for img, (t, cur_hw, (w0, h0)) in zip(imgs, got):
        raw = read_image(img.path, grayscale=grayscale)
        ref = fn(raw)
        assert is_device_array(t) and t.dtype == torch.uint8 and t.device == CPU
        assert cur_hw == ref.shape[:2] and (w0, h0) == (raw.shape[1], raw.shape[0])
        np.testing.assert_array_equal(t.numpy(), ref)


def test_prefetch_works_a_bounded_depth_ahead(image_dir, monkeypatch):
    """Forty images, a consumer that holds after the first: no more than
    ``DEPTH`` + 1 were decoded; closing the generator cancels the work not
    started, and nothing decodes after that."""
    path = sorted(image_dir.glob("*.png"))[0]
    decoded, gate = [], threading.Event()

    def slow_read(p, grayscale=True):
        gate.wait(timeout=30)
        decoded.append(p)
        return np.zeros((8, 8), np.uint8)

    monkeypatch.setattr(prefetch, "read_image", slow_read)
    gen = prefetch_device_images([Image(path)] * 40, True, lambda a: a, CPU)
    gate.set()
    next(gen)
    prefetch._pool().submit(lambda: None).result()
    assert len(decoded) <= prefetch.DEPTH + 1
    gen.close()
    # the pool drains what had started; the cancelled rest never runs
    for _ in range(prefetch.WORKERS):
        prefetch._pool().submit(lambda: None).result()
    assert len(decoded) <= prefetch.DEPTH + 1


def test_failed_decode_raises_on_take(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    gen = prefetch_device_images([Image(bad)], True, lambda a: a, CPU)
    with pytest.raises(ValueError, match="Cannot read image"):
        next(gen)


def test_assemble_batch_equals_host_padding():
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 255, (h, w), np.uint8) for h, w in [(60, 80), (50, 70)]]
    dev = [torch.from_numpy(a) for a in imgs]
    assert all(is_device_array(d) for d in dev) and not is_device_array(imgs[0])
    out = assemble_batch(dev, (64, 96), channels=1).numpy()
    host = np.zeros((2, 64, 96, 1), np.uint8)
    for j, a in enumerate(imgs):
        host[j, :a.shape[0], :a.shape[1], 0] = a
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, host)
    out3 = assemble_batch(dev[:1], (64, 96), channels=3).numpy()
    np.testing.assert_array_equal(out3, np.repeat(host[:1], 3, axis=-1))
    rgb = torch.from_numpy(rng.integers(0, 255, (20, 30, 3), np.uint8))
    np.testing.assert_array_equal(assemble_batch([rgb], (32, 32)).numpy()[0, :20, :30],
                                  rgb.numpy())
    with pytest.raises(ValueError, match="channels"):
        assemble_batch([rgb], (32, 32), channels=1)


def _recording_run(log):
    """A stand-in model: records each batch's shape and returns per image
    its sum as one 'keypoint' row (mask all set)."""

    def run(batch, vhw):
        log.append((tuple(batch.shape), vhw.tolist()))
        s = batch.reshape(batch.shape[0], -1).double().sum(1).float()
        return {"keypoints": s[:, None, None].expand(-1, 1, 2).contiguous(),
                "scores": s[:, None], "descriptors": s[:, None, None],
                "mask": torch.ones(batch.shape[0], 1, dtype=torch.bool)}

    return run


def test_padded_batches_run_buckets_as_they_fill():
    """Shapes L P L P L: the landscape bucket runs when it holds two, the
    portrait one too, the last image at the end; every index comes once."""
    shapes = [(40, 100), (100, 40), (40, 100), (100, 40), (40, 100)]
    imgs = [np.full(s, i, np.uint8) for i, s in enumerate(shapes)]
    log = []
    got = list(padded_batches(iter(imgs), 32, 1, 2, _recording_run(log), CPU))
    assert [idx for idx, _ in got] == [[0, 2], [1, 3], [4]]
    assert [shape for shape, _ in log] == [(2, 64, 128, 1), (2, 128, 64, 1), (1, 64, 128, 1)]
    assert log[0][1] == [[40, 100], [40, 100]]
    for idx, out in got:
        for i, f in zip(idx, unpad(out)):
            assert f["scores"][0] == i * shapes[i][0] * shapes[i][1]


def test_padded_batches_bound_the_waiting_images():
    """Seven shapes, one image each, batch size 2: no bucket fills, so the
    fullest runs once more than four images wait; no more than five are
    ever held."""
    imgs = [np.zeros((32 * (k + 1), 32), np.uint8) for k in range(7)]
    held, got = [], []

    def source():
        for i, im in enumerate(imgs):
            held.append(i - sum(len(idx) for idx, _ in got))
            yield im

    for item in padded_batches(source(), 32, 1, 2, _recording_run([]), CPU):
        got.append(item)
    assert max(held) <= 4 and sorted(i for idx, _ in got for i in idx) == list(range(7))


def test_padded_batches_pixel_budget_and_oom_halving():
    imgs = [np.zeros((64, 64, 3), np.uint8) for _ in range(8)]
    log = []
    list(padded_batches(imgs, 32, 3, 8, _recording_run(log), CPU, pixel_budget=3 * 64 * 64))
    assert [s[0] for s, _ in log] == [3, 3, 2]
    calls = []

    def oom_above_two(batch, vhw):
        calls.append(batch.shape[0])
        if batch.shape[0] > 2:
            raise torch.cuda.OutOfMemoryError("simulated")
        return _recording_run([])(batch, vhw)

    got = list(padded_batches(imgs, 32, 3, 8, oom_above_two, CPU, pixel_budget=1 << 30))
    assert calls == [8, 4, 2, 2, 2, 2] and [len(idx) for idx, _ in got] == [2, 2, 2, 2]
    with pytest.raises(torch.cuda.OutOfMemoryError):  # without a budget it propagates
        list(padded_batches(imgs, 32, 3, 8, oom_above_two, CPU))


def test_padded_batches_host_and_device_agree():
    """The same uint8 images as host arrays, as device tensors, and grey
    images broadcast to three channels: the batches handed to the model
    are equal."""
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 255, s, np.uint8) for s in [(50, 70), (60, 40), (50, 90)]]
    batches = {}
    for kind, src in (("host", imgs), ("dev", [torch.from_numpy(a) for a in imgs])):
        seen = []
        list(padded_batches(src, 32, 3, 2,
                            lambda b, v: seen.append(b) or _recording_run([])(b, v), CPU))
        batches[kind] = seen
    assert len(batches["host"]) == 2
    for a, b in zip(batches["host"], batches["dev"]):
        assert a.dtype == b.dtype == torch.uint8 and torch.equal(a, b)
    # a float image in a batch scales the uint8 ones to [0, 1]
    seen = []
    list(padded_batches([imgs[0], imgs[2].astype(np.float32) / 255.0], 32, 1, 2,
                        lambda b, v: seen.append(b) or _recording_run([])(b, v), CPU))
    assert seen[0].dtype == torch.float32
    np.testing.assert_allclose(seen[0][0, :50, :70, 0].numpy(), imgs[0] / 255.0, rtol=1e-6)
