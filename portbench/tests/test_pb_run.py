"""A whole run of a cell cut to a CPU size: the last line's shape, the
numbers it compares, and the refusal without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

from conftest import run_tiny

BENCH = Path(__file__).resolve().parents[1]


def test_last_line_shape_and_correct(capsys, tmp_path, monkeypatch, fresh_port):
    rc, line = run_tiny(capsys, tmp_path, monkeypatch)
    assert rc == 0 and line is not None
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] % 15 == 0
    assert set(line["metrics"]) == {"pairs_per_s", "peak_device_gib", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert not list(tmp_path.iterdir())          # the run removed what it wrote


def test_compared_numbers_end_standard_error(capsys, tmp_path, monkeypatch, fresh_port):
    import run

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    from conftest import tiny_spec

    run.run(["--workload", "splg-brute32-k4096", "--seed", "5", "--seconds", "0.1",
             "--trace", "0"], device="cpu", spec=tiny_spec())
    err = capsys.readouterr().err.strip().splitlines()
    limits = json.loads((BENCH / "limits" / "splg-brute32-k4096.json").read_text())
    tail = err[-len(limits):]
    assert [ln.split()[1] for ln in tail] == list(limits)
    assert all(ln.startswith("check ") and " limit " in ln for ln in tail)


def test_without_a_card_exits_nonzero(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "TMPDIR": str(tmp_path)}
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "splg-brute32-k4096",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=BENCH.parent, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_without_the_port_exits_nonzero(tmp_path):
    """A checkout holding only BENCHMARK.json and portbench/ gives no result."""
    import shutil

    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "splg-brute32-k4096",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, env={**os.environ, "TMPDIR": str(tmp_path)},
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_mesh_of_four_slots(capsys, tmp_path, monkeypatch, fresh_port):
    """The path across cards, a mesh of four slots (here the CPU named four
    times), judged as one card's run is."""
    import torch

    from deep_image_matching_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "_DEFAULT_MESH", mesh.MeshRunner([torch.device("cpu")] * 4))
    rc, line = run_tiny(capsys, tmp_path, monkeypatch)
    assert rc == 0 and line["correct"] is True, line["checks"]
