"""The measured window: jobs of ``run_matching`` back to back from one
client, and, in traced runs, the spans and call records the per-layer
metrics read.

Spans wrap the program's calls from outside, at the attributes through
which ``run_matching`` reaches them: ``ImageMatcher.extract_features`` and
``ImageMatcher.match_pairs`` (class attributes) and
``io.h5_to_db.export_to_colmap`` (a module attribute that
``run_matching`` imports at call time). Call records wrap the kernel
wrappers that ``portbench/kernels/*.py`` name, in every module of the
port that holds them; they keep tensors by reference and reduce nothing
until the window has closed, so the window gains no synchronisation.
"""

from __future__ import annotations

import importlib
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List

PORT = "deep_image_matching_tpu_torch"


@dataclass
class Job:
    index: int
    project: dict
    out_dir: Path
    start_ns: int = 0
    end_ns: int = 0
    seconds: float = 0.0
    error: str = ""


@dataclass
class Recorder:
    """Spans (name, start ns, end ns) and per-kernel call records."""
    spans: List[tuple] = field(default_factory=list)
    calls: Dict[str, list] = field(default_factory=dict)
    _undo: List[Callable] = field(default_factory=list)

    def _patch(self, owner, attr: str, wrapper) -> None:
        orig = getattr(owner, attr)
        setattr(owner, attr, wrapper)
        self._undo.append(lambda: setattr(owner, attr, orig))

    def span(self, owner, attr: str, name: str) -> None:
        orig = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return orig(*args, **kwargs)
            finally:
                self.spans.append((name, t0, time.time_ns()))

        self._patch(owner, attr, wrapped)

    def record(self, kernel: str, module: str, attr: str, note: Callable) -> None:
        """Wrap ``module.attr`` wherever the port holds it: ``note(args,
        kwargs, out)`` makes each call's record."""
        base = importlib.import_module(module)
        orig = getattr(base, attr)
        log = self.calls.setdefault(kernel, [])

        def wrapped(*args, **kwargs):
            out = orig(*args, **kwargs)
            log.append(note(args, kwargs, out))
            return out

        for name, mod in list(sys.modules.items()):
            if (name == PORT or name.startswith(PORT + ".")) and getattr(mod, attr, None) is orig:
                self._patch(mod, attr, wrapped)

    def close(self) -> None:
        while self._undo:
            self._undo.pop()()


def install_spans(rec: Recorder) -> None:
    from deep_image_matching_tpu_torch import image_matching
    from deep_image_matching_tpu_torch.io import h5_to_db

    rec.span(image_matching.ImageMatcher, "extract_features", "extract_features")
    rec.span(image_matching.ImageMatcher, "match_pairs", "match_pairs")
    rec.span(h5_to_db, "export_to_colmap", "export_to_colmap")


def run_jobs(args_of: Callable[[Job], dict], projects: List[dict], out_root: Path,
             seconds: float, rec: Recorder = None, after: Callable[[Job], None] = None
             ) -> List[Job]:
    """Jobs back to back, project after project, until ``seconds`` have
    passed at the start of a job; each job's wall from the host clock, and
    ``after(job)`` called between one job and the next. A job that raises
    is kept with its traceback and the window goes on."""
    from deep_image_matching_tpu_torch.__main__ import run_matching

    jobs: List[Job] = []
    t0 = time.perf_counter()
    while not jobs or time.perf_counter() - t0 < seconds:
        k = len(jobs)
        job = Job(k, projects[k % len(projects)], out_root / f"job{k:03d}")
        job.start_ns = time.time_ns()
        s = time.perf_counter()
        try:
            run_matching(args_of(job))
        except Exception:
            job.error = traceback.format_exc()
        job.seconds = time.perf_counter() - s
        job.end_ns = time.time_ns()
        if rec is not None:
            rec.spans.append(("job", job.start_ns, job.end_ns))
        jobs.append(job)
        if after is not None:
            after(job)
    return jobs


class Reservoir:
    """One job drawn uniformly from all the window's jobs as they finish
    (reservoir sampling), so that only its files are kept: every other
    job's output directory is removed as soon as the job is done, before
    its pages reach the disk, and the next job's writes do not wait
    behind them. ``count(job)`` (when given) reads what a job's files
    must give before they go."""

    def __init__(self, rng, count: Callable[[Job], None] = None):
        self.rng, self.count = rng, count
        self.kept = None
        self.seen = 0

    def __call__(self, job: Job) -> None:
        import shutil

        if self.count is not None and not job.error:
            self.count(job)
        self.seen += 1
        if self.rng.random() < 1.0 / self.seen:
            job, self.kept = self.kept, job
        if job is not None:
            shutil.rmtree(job.out_dir, ignore_errors=True)
