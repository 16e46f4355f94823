"""Which of the counting step's spans launched each device operation of a
traced run's device-only window, and the device's busy time of the
operations that one span launched.

`trace.Window` keeps the device's operations without their correlation ids
and the host's runtime calls without their threads. Importing this module
wraps `Window.read` (`install`) so that every window read afterwards also
keeps, beside `w.ops`, the launch call of each operation, matched by
correlation id: `w.launched`, one (start us of the launch call on the
host's clock, thread id) per operation or None where the trace holds no
such call, and `w.step_tid`, the thread that launched the two marker
kernels, which is the thread that runs the profiled steps. The readers
that use it import it when the harness loads them, before the run starts.
What the wrapped `read` returns is otherwise the window it returned.

`busy_ms_per_frame(r, name)`: the union of the intervals of the operations
that the step's thread launched while inside a span `name` of a profiled
batch (the program's span recorder, `cellbench/spans.py`), over the
profiled frames. None where there is nothing to read: no device window (a
CPU run), a window read before the wrap, no recorder (an older program) or
no such span.

`cell_config()`: the configuration of the cell this process runs, named
by `--workload` on the command line of `cellbench/run.py` (or of another
script of the harness that takes it), or None.
"""

from __future__ import annotations

import bisect
import json
import os
import sys

from cellbench import spans, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launches(w, events):
    """(w.launched, w.step_tid) of a window read from `events`."""
    calls = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None and e.get("cat") in trace.HOST_CALLS:
            calls[corr] = (float(e["ts"]), e.get("tid"))
    device = sorted((e for e in events if e.get("cat") in trace.DEVICE_CATS), key=lambda e: float(e["ts"]))
    launched, marks = [], []
    for e in device:
        call = calls.get((e.get("args") or {}).get("correlation"))
        if trace.SPIN in str(e.get("name", "")):
            marks.append(call)
        elif w.lo <= float(e["ts"]) <= w.hi:
            launched.append(call)
    tids = {m[1] for m in marks if m is not None}
    return launched, tids.pop() if len(tids) == 1 else None


def install():
    """Wrap `trace.Window.read` once (see the module's docstring)."""
    if getattr(trace.Window.read, "keeps_launches", False):
        return
    read = trace.Window.read.__func__

    def read_with_launches(cls, events):
        w = read(cls, events)
        if w is not None:
            w.launched, w.step_tid = _launches(w, events)
        return w

    read_with_launches.keeps_launches = True
    trace.Window.read = classmethod(read_with_launches)


install()


def busy_us(r, name, rec=None):
    """(busy us of the operations launched inside spans `name`, profiled
    frames), or None (see the module's docstring)."""
    rec = spans.recorder() if rec is None else rec
    w = r.device_window
    if rec is None or w is None or getattr(w, "launched", None) is None or w.step_tid is None:
        return None
    batches = spans.profiled_batches(r, rec)
    if not batches:
        return None
    inside = sorted((rec.trace_us(s.start_ns), rec.trace_us(s.end_ns)) for b in batches for s in b.spans
                    if s.name == name)
    if not inside:
        return None
    starts = [a for a, _ in inside]
    busy, end = 0.0, w.lo
    for (_, ts, dur), call in zip(w.ops, w.launched):
        if call is None or call[1] != w.step_tid:
            continue
        i = bisect.bisect_right(starts, call[0]) - 1
        if i < 0 or call[0] > inside[i][1]:
            continue
        a, b = max(ts, end), min(ts + dur, w.hi)
        if b > a:
            busy += b - a
            end = b
    return busy, sum(b.frames for b in batches)


def busy_ms_per_frame(r, name, rec=None):
    got = busy_us(r, name, rec)
    if got is None or not got[1]:
        return None
    return got[0] * 1e-3 / got[1]


def cell_config(argv=None, root=ROOT):
    """The configuration file's contents of the cell named by `--workload`
    in `argv` (the process's command line), or None."""
    argv = sys.argv if argv is None else argv
    names = [a.split("=", 1)[1] for a in argv if a.startswith("--workload=")]
    names += [argv[i + 1] for i, a in enumerate(argv[:-1]) if a == "--workload"]
    if len(names) != 1:
        return None
    try:
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            bench = json.load(f)
        cell = next(w for w in bench["workloads"] if w["name"] == names[0])
        conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
        with open(os.path.join(root, conf["file"])) as f:
            return json.load(f)
    except (OSError, StopIteration, KeyError, ValueError):
        return None
