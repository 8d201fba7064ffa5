"""Shared pieces of the benchmark's CPU tests: a cell cut to a size the CPU
runs in seconds, and a clean slate of the port's model caches between two
runs in one process (a run is one process on the card)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))
SRC = BENCH.parent / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))


def tiny_spec(cell: str = "splg-brute32-k4096") -> dict:
    """``cell`` as ``run.cell_of`` gives it, with its traffic cut to six
    384 x 384 views, 512 keypoints and shifts of whole cells that stay
    inside the views, its matcher in float32 and its RANSAC the card's."""
    import run

    spec = run.cell_of(cell)
    spec["traffic"] = {**spec["traffic"], "views": 6, "size": [384, 384], "max_keypoints": 512,
                       "planted": {"-2": [32, -16], "-1": [-48, 16]},
                       "check": {"images": 2, "pairs": 4, "truth_px": 0.5}}
    spec["cell"] = {**spec["cell"], "chips": 1}
    # the matcher in float32, as the reference computes on the CPU, so an
    # unbroken run reads near nought and every fault stands out; and the
    # card's verification, the batched RANSAC of ops/ransac.py, not OpenCV
    general = spec["config"]["general"]
    tpu = {**general["tpu"], "dtype": "float32", "device_ransac": True,
           "force_device_ransac": True}
    spec["config"] = {**spec["config"], "general": {**general, "tpu": tpu}}
    return spec


@pytest.fixture
def fresh_port():
    """The port's default-model caches emptied before and after the test."""
    from deep_image_matching_tpu_torch.models import lightglue, superglue, superpoint

    def clear():
        superpoint._DEFAULT_MODEL = None
        superpoint._DEFAULT_MODEL_RANDOM = False
        lightglue._DEFAULT_MODELS.clear()
        lightglue._DEFAULT_RANDOM.clear()
        superglue._DEFAULT_MODELS.clear()
        superglue._DEFAULT_RANDOM.clear()

    clear()
    yield
    clear()


def run_tiny(capsys, tmp_path, monkeypatch, seed: int = 424242424242, cell="splg-brute32-k4096",
             spec=None):
    """One run of the tiny cell on the CPU; (exit code, the last line as
    JSON or None)."""
    import json

    import run

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    rc = run.run(["--workload", cell, "--seed", str(seed), "--seconds", "0.5", "--trace", "0"],
                 device="cpu", spec=spec or tiny_spec(cell))
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out and out[-1].startswith("{") else None)
