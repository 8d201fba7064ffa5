"""The port's tracing (``utils/profiler.py``): spans nest on their thread
and carry their run on every thread, a full ring counts what it drops,
device spans run only under a profiler or when switched on and add no host
synchronisation, and a CPU ``run_matching`` is covered by its stage spans,
with one ``sync.*`` span per blocking point of LightGlue's match stage."""

import re
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest
import torch

from deep_image_matching_tpu_torch.utils import profiler


@pytest.fixture
def ring():
    """An empty ring before and after the test."""
    profiler.reset()
    yield
    profiler.reset()
    profiler.set_device_spans(False)


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_spans_nest_and_carry_the_run_on_every_thread(ring):
    def pooled():
        with profiler.span("decode"):
            pass

    def written():
        with profiler.span("write"):
            with profiler.span("sync.download"):
                pass

    with ThreadPoolExecutor(2) as pool, profiler.run_scope() as run:
        with profiler.span("match"):
            with profiler.span("match.dispatch"):
                with profiler.span("sync.exit_flag"):
                    pass
                profiler.count("lightglue.layers", 48)
            pool.submit(pooled).result()
            t = threading.Thread(target=written)
            t.start()
            t.join()
    with profiler.span("outside"):
        pass
    recs = _by_name(profiler.records())
    assert recs["match"][0].parent is None
    assert recs["match.dispatch"][0].parent == "match"
    assert recs["sync.exit_flag"][0].parent == "match/match.dispatch"
    layers = recs["lightglue.layers"][0]
    assert layers.value == 48 and layers.start_ns == layers.end_ns
    assert layers.parent == "match/match.dispatch"
    # other threads start their own stack, in the same run
    assert recs["decode"][0].parent is None and recs["write"][0].parent is None
    assert recs["sync.download"][0].parent == "write"
    for name in ("match", "match.dispatch", "sync.exit_flag", "lightglue.layers", "decode",
                 "write", "sync.download"):
        assert recs[name][0].run == run, name
    assert recs["outside"][0].run is None
    outer = recs["match"][0]
    inner = recs["sync.exit_flag"][0]
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_runs_differ_and_nest(ring):
    with profiler.run_scope() as a:
        with profiler.run_scope() as b:
            with profiler.span("inner"):
                pass
        with profiler.span("outer"):
            pass
    recs = _by_name(profiler.records())
    assert a != b and recs["inner"][0].run == b and recs["outer"][0].run == a


def test_a_full_ring_counts_what_it_drops(ring):
    profiler.reset(capacity=8)
    for i in range(20):
        with profiler.span("s", value=i):
            pass
    recs = profiler.records()
    assert [r.value for r in recs] == list(range(12, 20))
    n, last = profiler.dropped()
    assert n == 12 and last <= recs[0].start_ns
    profiler.reset()
    assert profiler.dropped() == (0, 0) and not profiler.records()


def test_a_span_costs_microseconds(ring):
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        with profiler.span("sync.result"):
            pass
    per = (time.perf_counter() - t0) / n
    assert len(profiler.records()) == n
    # about a microsecond on an idle core; loose for a loaded test host
    assert per < 20e-6, per


class _FakeEvent:
    """A CUDA event on the CPU: counts records and host waits."""
    log = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()
        _FakeEvent.log.append("record")

    def synchronize(self):
        _FakeEvent.log.append("synchronize")

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


@pytest.fixture
def fake_cuda(monkeypatch):
    _FakeEvent.log = []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")
    return _FakeEvent.log


def test_device_spans_only_under_a_profiler_or_switched_on(ring, fake_cuda):
    cuda = torch.device("cuda", 0)
    assert not torch.autograd._profiler_enabled()
    with profiler.device_span("ransac", cuda):
        pass
    with profiler.device_span("ransac", "cpu"):
        pass
    assert not profiler.records() and not fake_cuda

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiler.device_span("ransac", cuda):
            time.sleep(0.002)
    profiler.set_device_spans(True)
    with profiler.span("match.dispatch"):
        with profiler.device_span("ransac", cuda):
            with profiler.span("sync.eigh"):
                pass
    with profiler.device_span("ransac", "cpu"):
        pass
    # two events each, and no host wait while the spans ran
    assert fake_cuda == ["record"] * 4
    recs = profiler.records()
    assert fake_cuda.count("synchronize") == 2
    ransac = [r for r in recs if r.name == "ransac"]
    assert len(ransac) == 2 and ransac[0].value >= 2.0 and ransac[1].value >= 0.0
    assert ransac[1].parent == "match.dispatch"
    assert _by_name(recs)["sync.eigh"][0].parent == "match.dispatch/ransac"
    profiler.records()
    assert fake_cuda.count("synchronize") == 2      # resolved once


@pytest.mark.cuda
def test_device_span_on_the_card_adds_no_sync(ring):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    x = torch.randn(2048, 2048, device=dev)
    profiler.set_device_spans(True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profiler.device_span("ransac", dev):
            for _ in range(4):
                x = x @ x.T / 2048
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    (rec,) = profiler.records()
    assert rec.name == "ransac" and rec.value > 0


# --------------------------------------------------------- run_matching


def _project(root, n=4, size=(320, 240)):
    """``n`` views of one seeded texture, each shifted by a few pixels."""
    rng = np.random.default_rng(7)
    tex = cv2.GaussianBlur((rng.random((size[1] + 64, size[0] + 64)) * 255).astype(np.uint8),
                           (0, 0), 2.0)
    (root / "images").mkdir(parents=True)
    for i in range(n):
        dx, dy = 8 * i, 4 * i
        cv2.imwrite(str(root / "images" / f"v{i}.png"),
                    tex[dy:dy + size[1], dx:dx + size[0]])
    return root


@pytest.fixture
def lightglue_project(tmp_path, monkeypatch):
    """Four views, a 3-layer LightGlue checkpoint whose token-confidence
    heads are zero (every point reads 0.5, so the depth exit never fires),
    SuperPoint's seeded random weights, and the port's model caches empty."""
    from deep_image_matching_tpu_torch.models import lightglue, superpoint

    def clear():
        superpoint._DEFAULT_MODEL = None
        superpoint._DEFAULT_MODEL_RANDOM = False
        lightglue._DEFAULT_MODELS.clear()
        lightglue._DEFAULT_RANDOM.clear()

    model = lightglue.LightGlue(n_layers=3).reset_random(torch.Generator().manual_seed(3))
    sd = model.state_dict()
    for k in sd:
        if k.startswith("token_confidence"):
            sd[k] = torch.zeros_like(sd[k])
    weights = tmp_path / "weights"
    weights.mkdir()
    torch.save(sd, weights / "superpoint_lightglue.pth")
    monkeypatch.setenv("DIM_TPU_WEIGHTS_DIR", str(weights))
    cfg = tmp_path / "cpu.yaml"
    cfg.write_text("general:\n  allow_random_weights: true\n  tpu:\n    device: cpu\n"
                   "    match_batch_size: 2\n"
                   "extractor:\n  max_keypoints: 256\n"
                   "matcher:\n  n_layers: 3\n  depth_confidence: 0.95\n"
                   "  width_confidence: 0.99\n")
    proj = _project(tmp_path / "proj")
    clear()
    yield proj, cfg
    clear()


def _run(proj, cfg, out):
    from deep_image_matching_tpu_torch.__main__ import run_matching

    return run_matching({"dir": str(proj), "outs": str(out), "pipeline": "superpoint+lightglue",
                         "strategy": "bruteforce", "skip_reconstruction": True,
                         "graph": False, "force": True, "config_file": str(cfg)})


def test_run_matching_is_covered_by_its_spans(ring, lightglue_project, tmp_path):
    import logging

    proj, cfg = lightglue_project
    _run(proj, cfg, tmp_path / "out0")
    profiler.reset()
    messages = []
    handler = logging.Handler()
    handler.emit = lambda rec: messages.append(rec.getMessage())
    logging.getLogger("dim_tpu_torch").addHandler(handler)
    try:
        t0 = time.time_ns()
        _run(proj, cfg, tmp_path / "out1")
        wall = time.time_ns() - t0
    finally:
        logging.getLogger("dim_tpu_torch").removeHandler(handler)
    recs = profiler.records()
    runs = {r.run for r in recs}
    assert len(runs) == 1 and None not in runs
    stages = [r for r in recs if r.name in ("setup", "pairs", "extract", "match", "export")]
    assert sorted(r.name for r in stages) == ["export", "extract", "match", "pairs", "setup"]
    assert all(r.parent is None for r in stages)
    covered = sum(r.end_ns - r.start_ns for r in stages)
    assert covered >= 0.95 * wall, (covered, wall)
    names = {r.name for r in recs}
    assert {"setup.extractor", "setup.matcher", "match.store", "match.dispatch",
            "match.finish", "wait.decode", "wait.writer_join", "export.h5_read",
            "export.camera", "export.db"} <= names
    (line,) = [m for m in messages if m.startswith("[Timer] | [ImageMatcher]")]
    assert re.fullmatch(r"\[Timer\] \| \[ImageMatcher\] generate_pairs=\d+\.\d{3}s, "
                        r"extract_features=\d+\.\d{3}s, match_pairs=\d+\.\d{3}s "
                        r"\(total=\d+\.\d{3}s\)", line), line


def test_one_sync_span_per_exit_flag_and_result(ring, lightglue_project, tmp_path):
    """Six pairs in chunks of two: three chunks, each reading the exit flag
    after layers 0 and 1 (the last layer has no flag) and its result once;
    every sync span lies inside ``match``."""
    proj, cfg = lightglue_project
    _run(proj, cfg, tmp_path / "out")
    recs = profiler.records()
    by = _by_name(recs)
    chunks, layers = 3, 3
    assert len(by["match.dispatch"]) == len(by["match.finish"]) == chunks
    assert len(by["sync.exit_flag"]) == chunks * (layers - 1)
    assert len(by["sync.result"]) == chunks
    assert all(r.parent == "match/match.dispatch" for r in by["sync.exit_flag"])
    assert all(r.parent == "match/match.finish" for r in by["sync.result"])
    # the exit never fired: every chunk ran all its layers over its 2 rows
    assert [r.value for r in by["lightglue.layers"]] == [layers * 2] * chunks
    (match,) = by["match"]
    for r in recs:
        if r.name.startswith("sync.") and r.parent and r.parent.startswith("match"):
            assert match.start_ns <= r.start_ns <= r.end_ns <= match.end_ns


@pytest.mark.cuda
def test_every_sync_of_match_on_the_card_lies_in_a_sync_span(ring, lightglue_project, tmp_path):
    """On the card, under ``set_sync_debug_mode("warn")`` and with every
    CUDA event wait counted too (the debug mode does not see those), each
    synchronising call of the job's thread inside ``match`` lies in a
    ``sync.*`` span, and each such span holds one."""
    import warnings

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proj, cfg = lightglue_project
    cfg.write_text(cfg.read_text().replace("device: cpu", "device: cuda"))
    _run(proj, cfg, tmp_path / "warm")          # kernels built outside the check
    torch.cuda.synchronize()
    profiler.reset()
    job = threading.get_ident()
    calls = []

    def note():
        if threading.get_ident() == job:
            calls.append(time.time_ns())

    def show(message, *args, **kwargs):
        if "synchroniz" in str(message).lower():
            note()

    event_sync = torch.cuda.Event.synchronize

    def timed_sync(self):
        note()
        return event_sync(self)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.Event.synchronize = timed_sync
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _run(proj, cfg, tmp_path / "out")
        finally:
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.Event.synchronize = event_sync
    recs = profiler.records()
    (match,) = [r for r in recs if r.name == "match"]
    syncs = [r for r in recs if r.name.startswith("sync.") and r.parent
             and r.parent.split("/")[0] == "match"]
    inside = [t for t in calls if match.start_ns <= t <= match.end_ns]
    assert syncs and inside
    unheld = [t for t in inside if not any(s.start_ns <= t <= s.end_ns for s in syncs)]
    assert not unheld, f"{len(unheld)} of {len(inside)} synchronising calls outside sync spans"
    empty = [s.name for s in syncs if not any(s.start_ns <= t <= s.end_ns for t in inside)]
    assert not empty, f"sync spans holding no synchronising call: {sorted(set(empty))}"
