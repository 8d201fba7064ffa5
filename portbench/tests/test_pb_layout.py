"""BENCHMARK.json and the files it names: every cell finds its
configuration, traffic and limits by name, every per-layer metric its
reader, and every name and unit keeps to the allowed characters."""

import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"] and SPEC["command"][1] == "portbench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    assert NAME.fullmatch(cell["name"]) and NAME.fullmatch(cell["traffic"])
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    cfg = json.loads((BENCH / "configs" / f"{cell['config']}.json").read_text())
    assert cfg["name"] == cell["config"]
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    assert traffic["kind"] in ("views", "frames")
    limits = json.loads((BENCH / "limits" / f"{cell['name']}.json").read_text())
    assert limits and all(v >= 0 for v in limits.values())


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entries(config):
    assert NAME.fullmatch(config["name"])
    assert (BENCH.parent / config["file"]).exists() and config["file"].startswith("portbench/")
    body = json.loads((BENCH.parent / config["file"]).read_text())
    assert body["reduced"] == config["reduced"]
    for key in config["reduced"]:
        assert NAME.fullmatch(key) and key in body["assumed"]
    assert set(body["published"]) <= set(config["reduced"])
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_names_its_references(config):
    """The configuration names its reference models; each is a file of
    ``portbench/reference/`` with its checkpoint and its seeded recipe."""
    from harness import plugins

    body = json.loads((BENCH.parent / config["file"]).read_text())
    assert set(body["reference"]) == {"extractor", "matcher"}
    for role, entry in (("extractor", "extract_image"), ("matcher", "match_pair")):
        ref = plugins.reference(body["reference"][role])
        assert callable(getattr(ref, entry)) and ref.FILE.endswith(".pth")
        assert all(ref.std(k, s) >= 0 for k, s in ref.shapes().items())


def test_end_to_end():
    names = [m["name"] for m in SPEC["end_to_end"]]
    assert "setup_s" in names and "pairs_per_s" in names
    for m in SPEC["end_to_end"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    assert NAME.fullmatch(metric["name"]) and UNIT.fullmatch(metric["unit"])
    assert metric["moves"] == "pairs_per_s"
    assert (BENCH / "metrics" / f"{metric['name']}.py").exists()
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    assert metric["better"] in ("lower", "higher")
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%" and (BENCH / "kernels" /
                                          f"{metric['name'][:-9]}.py").exists()
