"""A traced run of the cell cut to a CPU size: the per-layer metrics that
read the port's own records (``utils/profiler.py``) are there, and the two
that need the card's device trace or CUDA events are not."""

import json
import time

from conftest import tiny_spec

PROGRAM = ("setup_ms_per_job", "match_host_ms_per_pair", "host_syncs_per_pair",
           "export_h5_ms_per_pair", "lightglue_layers_per_pair")
DEVICE = ("ransac_stream_ms_per_pair", "match_idle_ms_per_pair")


def test_traced_run_reads_the_port_records(capsys, tmp_path, monkeypatch, fresh_port):
    import run

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    rc = run.run(["--workload", "splg-brute32-k4096", "--seed", "3000000019", "--seconds", "0.5",
                  "--trace", "1"], device="cpu", spec=tiny_spec())
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True, line["checks"]
    metrics = line["metrics"]
    for name in PROGRAM:
        assert metrics[name]["value"] > 0, name
    assert not set(DEVICE) & set(metrics)
    # 15 pairs in chunks of 32: one chunk a job, one result sync, one exit
    # flag a layer but the last, two index uploads, RANSAC's two solvers
    jobs = len(line["jobs"])
    pairs = line["attempted"]
    assert metrics["host_syncs_per_pair"]["value"] * pairs >= jobs * (1 + 8)
    # the zero token-confidence heads never stop a pair: all 9 layers run
    assert metrics["lightglue_layers_per_pair"]["value"] == 9.0
    # the stage spans cover the jobs and match the harness's wrappers
    (report,) = [ln for ln in out.err.splitlines() if ln.startswith("portbench: port spans ")]
    report = json.loads(report[len("portbench: port spans "):])
    assert report["cover"] > 0.97 and report["device_ops_named_as_spans"] == []
    for stage, ratio in report["over_wrappers"].items():
        assert abs(ratio - 1) < 0.02, stage
    assert report["idle_s_per_job"] == {}


def test_idle_time_is_named_by_the_innermost_span():
    """One job, a card busy in [20, 30) and [60, 100): its idle time falls
    to the innermost span of the job's thread, and the port's spans join
    the harness's so that ``breakdown.idle_gaps`` names gaps by them."""
    from harness import layers, program
    from harness.trace import DeviceTrace

    from deep_image_matching_tpu_torch.utils.profiler import Record

    def rec(name, a, b, parent=None):
        return Record(name, a, b, parent, 1, None)

    own = [rec("extract", 0, 40), rec("wait.decode", 5, 15, "extract"),
           rec("match", 40, 100), rec("sync.result", 45, 55, "match"),
           rec("decode", 0, 100)]      # the pool's thread: not the job's
    ctx = layers.Context(config={}, window_s=1e-7, n_cards=1, n_images=1, n_pairs=1,
                         spans=[("job", 0, 100)], trace=DeviceTrace([(0, "k", 20, 30),
                                                                     (0, "k", 60, 100)]))
    idle = program.idle_by_span(ctx, program.job_thread(own))
    assert idle == {"extract": 20e-9, "match/sync.result": 10e-9, "match": 10e-9,
                    "extract/wait.decode": 10e-9}
    gaps = ctx.trace.idle_gaps([(0, 100)], ctx.spans + [
        (program.path(r), r.start_ns, r.end_ns) for r in program.job_thread(own)])
    # named by the innermost span at their middle, longest first
    assert [g[0] for g in gaps] == ["match/sync.result", "extract/wait.decode"]


def test_ring_overwritten_inside_the_window_reads_nothing(fresh_port):
    from harness import layers, program

    from deep_image_matching_tpu_torch.utils import profiler

    profiler.reset(capacity=4)
    try:
        t0 = time.time_ns()
        with profiler.run_scope():
            for _ in range(6):
                with profiler.span("sync.result"):
                    pass
        recs = profiler.records()
        hi = recs[-1].end_ns + 10

        def ctx(lo):
            return layers.Context(config={}, window_s=1.0, n_cards=1, n_images=2, n_pairs=1,
                                  spans=[("job", lo, hi)])

        assert len(recs) == 4 and profiler.dropped()[0] == 2
        assert program.records(ctx(t0)) is None
        # a window that starts after the overwritten records keeps its own
        assert profiler.dropped()[1] <= recs[0].start_ns
        assert len(program.records(ctx(recs[0].start_ns))) == 4
    finally:
        profiler.reset()
