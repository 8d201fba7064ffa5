"""The correctness check catches a broken timed path: a whole run of a cell
cut to a CPU size, with the program broken underneath, comes out not
correct, once for each fault the cells can have; and the control, the
reference computed in float8 and put in the program's place, fails the
numbers that its float32 form passes."""

import pytest

from conftest import run_tiny, tiny_spec
from faults import FAULTS


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_the_run_incorrect(fault, capsys, tmp_path, monkeypatch, fresh_port):
    FAULTS[fault](monkeypatch)
    rc, line = run_tiny(capsys, tmp_path, monkeypatch)
    assert rc == 0 and line is not None
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("precision,fails", [("fp8", True), ("f32", False)])
def test_control(precision, fails, capsys):
    import control

    rows = control.main(["--workload", "splg-brute32-k4096", "--seeds", "11,12,13",
                         "--device", "cpu", "--precision", precision], spec=tiny_spec())
    assert all(bool(r["fails"]) == fails for r in rows), rows
