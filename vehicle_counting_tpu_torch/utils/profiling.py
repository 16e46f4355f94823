"""Tracing/profiling hooks (counterpart of the JAX package's
`utils/profiling.py`).

`RECORDER` is the process's span recorder, always on: `span(name)` times a
region on the calling thread (a stack per thread, so a span knows its
parent), `step_span(frames)` opens one record per call of the counting
step that holds every span opened inside it on that thread, stamped with
the batch's id. The last 1024 batch records are kept in memory; a span
opened outside a batch only adds to the totals. Nothing is written to disk.
While a `torch.profiler` is recording, each span also opens a
`record_function("vct.<name>")`, so a trace shows the program's names.
Stamps are `time.perf_counter_ns()`; `trace_us` puts one on the timeline of
an exported Chrome trace.

`StageTimer` records wall time per pipeline stage (`--debug`), each stage a
span of the recorder; `trace` wraps `torch.profiler` around a region and
writes a Chrome trace that `tools/profile_summary.py` reads.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

_now = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled
# Kineto puts an exported trace's `ts` at (unix ns - base) / 1000, the base
# being the wall clock rounded down to this many seconds (its trimonth)
_TRIMONTH_S = 7889238
_ZERO = (0, 0, 0)


class Span:
    """One timed region: `name`, `start_ns` / `end_ns` (perf_counter_ns),
    `parent` (the span open on the same thread when it opened, or None),
    `thread` (its ident) and `batch` (the id of the step record it belongs
    to, or None). Use it as a context manager; `end_ns` is None while open."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "batch", "_rec", "_st", "_child_ns", "_rf")
    _opens_batch = False

    def __init__(self, rec: "Recorder", name: str):
        self._rec, self.name = rec, name
        self.end_ns = self.batch = self._rf = None

    def __enter__(self):
        rec = self._rec
        try:
            st = rec._local.st
        except AttributeError:
            st = rec._state()
        self._st = st
        stack = st.stack
        self.parent = stack[-1] if stack else None
        self._child_ns = 0
        record = st.batch
        if record is None and self._opens_batch:
            record = st.batch = rec._new_record(st.ident, self.frames)
        if record is not None:
            self.batch = record.id
            record.spans.append(self)
        stack.append(self)
        self.start_ns = _now()
        if _profiling():
            self._rf = torch.autograd.profiler.record_function("vct." + self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        end = self.end_ns = _now()
        st = self._st
        st.stack.pop()
        dur = end - self.start_ns
        parent = self.parent
        if parent is not None:
            parent._child_ns += dur
        if self._opens_batch and st.batch is not None and st.batch.spans[0] is self:
            st.batch = None
        tot = st.totals
        t, n, s = tot.get(self.name, _ZERO)
        tot[self.name] = (t + dur, n + 1, s + dur - self._child_ns)
        return False

    @property
    def thread(self) -> int:
        return self._st.ident

    def __repr__(self):
        return f"Span({self.name!r}, batch={self.batch}, {self.start_ns}..{self.end_ns})"


class StepSpan(Span):
    """The counting step's span: opened on a thread with no batch open, it
    starts a batch record (`Recorder.batches`) with `frames` frames."""

    __slots__ = ("frames",)
    _opens_batch = True

    def __init__(self, rec: "Recorder", frames: int):
        super().__init__(rec, "step")
        self.frames = int(frames)


class BatchRecord:
    """One call of the step: `id`, `thread`, `frames`, `profiled` (a
    torch.profiler was recording when it opened) and `spans`, the step's
    span first, then every span opened inside it on that thread, in the
    order they opened."""

    __slots__ = ("id", "thread", "frames", "profiled", "spans")

    def __init__(self, id_: int, thread: int, frames: int, profiled: bool):
        self.id, self.thread, self.frames, self.profiled = id_, thread, frames, profiled
        self.spans: List[Span] = []


class _ThreadState:
    __slots__ = ("ident", "owner", "stack", "batch", "totals")

    def __init__(self):
        self.ident = threading.get_ident()
        self.owner = threading.current_thread()
        self.stack: List[Span] = []
        self.batch: Optional[BatchRecord] = None
        self.totals: Dict[str, Tuple[int, int, int]] = {}  # name -> (total ns, count, self ns)


class Recorder:
    """Spans of every thread of the process: per-name totals (total, count,
    self time) and a ring of the last `capacity` batch records. A thread
    that has ended leaves its totals behind (a pipeline starts a producer
    thread per video)."""

    def __init__(self, capacity: int = 1024):
        self._ring = collections.deque(maxlen=capacity)
        self._local = threading.local()
        self._threads: List[_ThreadState] = []
        self._ended: Dict[str, Tuple[int, int, int]] = {}
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self.anchor_ns, self.anchor_unix_ns = _anchor()

    def span(self, name: str) -> Span:
        return Span(self, name)

    def step_span(self, frames: int) -> StepSpan:
        return StepSpan(self, frames)

    def _state(self) -> _ThreadState:
        try:
            return self._local.st
        except AttributeError:
            st = self._local.st = _ThreadState()
            with self._lock:
                live = [st]
                for old in self._threads:
                    if old.owner.is_alive():  # read once: a thread may end meanwhile
                        live.append(old)
                    else:
                        self._ended = _merged(self._ended, old.totals)
                self._threads = live
            return st

    def _new_record(self, thread: int, frames: int) -> BatchRecord:
        record = BatchRecord(next(self._ids), thread, frames, bool(_profiling()))
        self._ring.append(record)
        return record

    def batches(self) -> List[BatchRecord]:
        """The kept batch records, oldest first."""
        return list(self._ring)

    def totals(self) -> Dict[str, Tuple[int, int, int]]:
        """{name: (total ns, count, self ns)} over every thread."""
        with self._lock:
            out, states = self._ended, list(self._threads)
        for st in states:
            out = _merged(out, dict(st.totals))
        return out

    def summary(self, since: Optional[Dict[str, Tuple[int, int, int]]] = None) -> str:
        """One line per span name, most total time first: total, mean,
        count and self time, over the spans closed since the `totals()`
        snapshot `since` (all, without one)."""
        since = since or {}
        rows = []
        for name, (t, n, s) in self.totals().items():
            t0, n0, s0 = since.get(name, (0, 0, 0))
            if n > n0:
                rows.append((name, (t - t0) * 1e-9, n - n0, (s - s0) * 1e-9))
        return "\n".join(f"{name}: {t:.3f}s total, {t / n * 1e3:.2f}ms avg x{n}, {s:.3f}s self"
                         for name, t, n, s in sorted(rows, key=lambda r: -r[1]))

    def trace_us(self, ns: int, base_ns: Optional[int] = None) -> float:
        """A perf_counter_ns stamp on an exported Chrome trace's timeline
        (`ts`, us), whose base is the trace's `baseTimeNanoseconds`: given,
        or recomputed as Kineto sets it, the wall clock rounded down to its
        trimonth."""
        unix = ns - self.anchor_ns + self.anchor_unix_ns  # time.time_ns()'s clock
        if base_ns is None:
            base_ns = unix // 1_000_000_000 // _TRIMONTH_S * _TRIMONTH_S * 1_000_000_000
        return (unix - base_ns) / 1000.0


def _merged(a: Dict[str, Tuple[int, int, int]], b: Dict[str, Tuple[int, int, int]]):
    out = dict(a)
    for name, (t, n, s) in b.items():
        t0, n0, s0 = out.get(name, _ZERO)
        out[name] = (t0 + t, n0 + n, s0 + s)
    return out


def _anchor(tries: int = 5) -> Tuple[int, int]:
    """(perf_counter_ns, time_ns) taken together, the tightest of a few tries."""
    best = None
    for _ in range(tries):
        a = _now()
        u = time.time_ns()
        b = _now()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, u)
    return best[1], best[2]


RECORDER = Recorder()


def span(name: str) -> Span:
    """A span of the process's recorder: `with span("detect"): ...`."""
    return Span(RECORDER, name)


def step_span(frames: int) -> StepSpan:
    """The counting step's span on the process's recorder: one batch record
    per call (a step inside a step is a plain span of the outer one)."""
    return StepSpan(RECORDER, frames)


def spanned(name: str):
    """Decorator: every call of the function is a span of the process's
    recorder named `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with Span(RECORDER, name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def trace_us(ns: int, base_ns: Optional[int] = None) -> float:
    """`Recorder.trace_us` of the process's recorder."""
    return RECORDER.trace_us(ns, base_ns)


class StageTimer:
    """Accumulates wall time per named stage; cheap enough to always run.
    Each stage is a span of the process's recorder."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._since = RECORDER.totals()

    @contextlib.contextmanager
    def stage(self, name: str):
        s = span(name)
        try:
            with s:
                yield
        finally:
            self.totals[name] += (s.end_ns - s.start_ns) * 1e-9
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name}: {t:.3f}s total, {t / max(n, 1) * 1e3:.2f}ms avg x{n}")
        return "\n".join(lines)

    def spans(self) -> str:
        """Every span of the process closed since this timer was made, the
        stages and the step's own (`Recorder.summary`)."""
        return RECORDER.summary(self._since)


@contextlib.contextmanager
def trace(log_dir: str = "vct_trace"):
    """`torch.profiler` capture of the enclosed region (host ops and, where
    there is a card, its kernels and copies). On exit the Chrome trace is
    written to `log_dir/trace_<ns>.json`; the yielded dict gets its path
    under "path". View it in Perfetto or chrome://tracing, or summarise it
    with `python -m vehicle_counting_tpu_torch.tools.profile_summary`. Host
    ops carry their input shapes, from which `profile_summary --convs`
    counts each convolution's FLOPs; the recorder's spans show as
    `vct.<name>` ranges.

    The trace holds one event per host op and per device kernel: a B=128
    batch of the counting step is ~67,000 device events and ~160 MB of
    JSON, and the traced run is several times slower, so trace a batch or
    two, not a whole video.
    """
    from torch.profiler import ProfilerActivity, profile, supported_activities

    acts = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA) if a in supported_activities()]
    os.makedirs(log_dir, exist_ok=True)
    info = {"path": None}
    prof = profile(activities=acts, record_shapes=True)
    prof.__enter__()
    try:
        yield info
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        path = os.path.join(log_dir, f"trace_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        info["path"] = path
