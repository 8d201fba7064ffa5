"""``run_matching`` with superpoint+lightglue and ``--tiling preselection`` on three
demo images, against the JAX package: the ``lightglue-preselection`` case of
``tests/test_torch_tiled_pipeline.py``'s ``RUNS``, in a file of its own so that
parallel workers run it beside that file's other cases."""

import pytest

from test_torch_tiled_pipeline import demo3, tiled_run_matching_equals_jax  # noqa: F401 (fixture)


@pytest.mark.parametrize("run", ["lightglue-preselection"])
def test_tiled_run_matching_equals_jax(tmp_path, demo3, monkeypatch, run):  # noqa: F811
    tiled_run_matching_equals_jax(tmp_path, demo3, monkeypatch, run)
