"""The port's own records of a traced run (``utils/profiler.py`` of the
port: spans, counters and device spans in a ring), kept to the window:
the records that lie inside the window's ``job`` spans. None where the port
keeps no such records (a tree without them) or where the ring overwrote a
record of the window.

Reading them also names the window's idle time by the port's spans: the
spans of the job's own thread join ``ctx.spans`` under their paths
(``match/match.dispatch/sync.exit_flag``), so that the line's
``breakdown.idle_gaps`` names each gap by the innermost of them, and one
line of standard error (``portbench: port spans {...}``) gives the card's
idle seconds a job by innermost span, how much of the job walls the stage
spans cover, their totals over the harness's wrappers at the same
boundaries, the records a job, and any device operator named after a
span."""

from __future__ import annotations

import json
import sys
from bisect import bisect_right
from collections import defaultdict
from typing import List, Optional

STAGES = ("setup", "pairs", "extract", "match", "export")
WRAPPERS = {"extract": "extract_features", "match": "match_pairs", "export": "export_to_colmap"}


def records(ctx) -> Optional[List[tuple]]:
    if "_program" not in ctx.__dict__:
        ctx.__dict__["_program"] = recs = _read(ctx)
        if recs:
            _name_idle(ctx, recs)
    return ctx.__dict__["_program"]


def _read(ctx):
    try:
        from deep_image_matching_tpu_torch.utils import profiler

        read, dropped = profiler.records, profiler.dropped
    except (ImportError, AttributeError):
        return None
    jobs = sorted((a, b) for n, a, b in ctx.spans if n == "job")
    if not jobs:
        return None
    n, last = dropped()
    if n and last >= jobs[0][0]:
        return None
    starts = [a for a, _ in jobs]
    out = []
    for r in read():
        k = bisect_right(starts, r.start_ns) - 1
        if k >= 0 and r.end_ns <= jobs[k][1]:
            out.append(r)
    return out


def named(ctx, name: str) -> list:
    """The window's records called ``name`` ([] where there are none)."""
    return [r for r in records(ctx) or [] if r.name == name]


def spans_s(ctx, *names: str) -> Optional[float]:
    """Seconds summed over the window's spans of ``names``; None where the
    port keeps no records or none is there."""
    recs = [r for r in records(ctx) or [] if r.name in names]
    return sum(r.end_ns - r.start_ns for r in recs) / 1e9 if recs else None


def n_jobs(ctx) -> int:
    return sum(1 for n, _, _ in ctx.spans if n == "job")


def path(r) -> str:
    return f"{r.parent}/{r.name}" if r.parent else r.name


def job_thread(recs) -> list:
    """The spans of the job's own thread: the stage spans and those under
    them (the prefetch pool's and the feature writer's threads have their
    own roots)."""
    return [r for r in recs if r.end_ns > r.start_ns and path(r).split("/")[0] in STAGES]


def innermost(spans, lo: int, hi: int) -> list:
    """[(a, b, path)] covering [lo, hi): the innermost of one thread's
    nested spans at each instant ("job" where none is open)."""
    points = []
    for r in spans:
        p = path(r)
        points.append((r.start_ns, 1, r.start_ns - r.end_ns, p))
        points.append((r.end_ns, 0, 0, p))
    points.sort()
    out, stack, at = [], ["job"], lo
    for t, opens, _, p in points:
        t = min(max(t, lo), hi)
        if t > at:
            out.append((at, t, stack[-1]))
            at = t
        if opens:
            stack.append(p)
        elif p in stack:
            stack.remove(p)
    if hi > at:
        out.append((at, hi, stack[-1]))
    return out


def idle_by_span(ctx, own) -> dict:
    """Seconds of card idle time a job by the innermost span of ``own``,
    mean over the cards, largest first; {} without a device trace."""
    from harness.trace import clip, gaps, union_ns

    if ctx.trace is None or not ctx.trace.events:
        return {}
    jobs = sorted((a, b) for n, a, b in ctx.spans if n == "job")
    by_dev = defaultdict(list)
    for d, _, a, b in ctx.trace.events:
        by_dev[d].append((a, b))
    busy = {d: union_ns(by_dev.get(d, [])) for d in range(ctx.n_cards)}
    out = defaultdict(float)
    for lo, hi in jobs:
        segs = innermost([r for r in own if lo <= r.start_ns < hi], lo, hi)
        for d in range(ctx.n_cards):
            i = 0
            for a, b in gaps(clip(busy[d], lo, hi), lo, hi):
                while i < len(segs) and segs[i][1] <= a:
                    i += 1
                j = i
                while j < len(segs) and segs[j][0] < b:
                    s0, s1, p = segs[j]
                    out[p] += (min(b, s1) - max(a, s0)) / 1e9
                    j += 1
    n = ctx.n_cards * len(jobs)
    return dict(sorted(((k, v / n) for k, v in out.items()), key=lambda kv: -kv[1]))


def _name_idle(ctx, recs) -> None:
    own = job_thread(recs)
    walls = sum(b - a for n, a, b in ctx.spans if n == "job")
    stage = {s: sum(r.end_ns - r.start_ns for r in own if r.name == s and not r.parent)
             for s in STAGES}
    wrap = {s: ctx.span_s(w) * 1e9 for s, w in WRAPPERS.items()}
    names = {r.name for r in recs}
    ops = {n for _, n, _, _ in ctx.trace.events} if ctx.trace is not None else set()
    report = {"idle_s_per_job": idle_by_span(ctx, own),
              "cover": sum(stage.values()) / walls if walls else None,
              "over_wrappers": {s: stage[s] / wrap[s] for s in WRAPPERS if wrap[s]},
              "records_per_job": len(recs) / max(n_jobs(ctx), 1),
              "device_ops_named_as_spans": sorted(ops & names)}
    print("portbench: port spans " + json.dumps(report), file=sys.stderr)
    ctx.spans.extend((path(r), r.start_ns, r.end_ns) for r in own)
