"""What the readers of the program's own spans share.

The port records a span at each layer boundary inside its counting step
and keeps one record per call of the step (`utils/profiling.py` of the
port: `RECORDER`, a ring of batch records, each with the step's span first
and every span opened inside it on the step's thread). These functions
read that recorder after a traced run:

- the timed window's batches: the `len(r.latencies)` records just before
  the records made under a profiler, which the traced run makes last;
- the profiled batches: those of the profiled records whose step span lies
  inside `r.device_window`'s bounds on the trace's clock;
- the device's idle time in `r.device_window`, split by where the step's
  thread was: in a `detect`, `embed` or `track` span, or in no `step` span
  (`idle_split`), or by the innermost span it was in (`report`).

A program without the recorder (an older checkout) gives None everywhere,
and so does a run without a device window (the CPU). The idle time is read
only from a window of the device's activity alone (`device_only`): where
that trace lost a marker and the harness fell back to a trace of the
host's operations, the idle readers give None.
"""

from __future__ import annotations

LAYERS = ("detect", "embed", "track")
OUTSIDE = "outside_step"


def recorder():
    """The program's span recorder, or None where the program has none."""
    try:
        from vehicle_counting_tpu_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "RECORDER", None)


def window_batches(r, rec=None):
    """The batch records of the traced run's timed window, or None."""
    rec = recorder() if rec is None else rec
    if rec is None or r.device_window is None or not r.latencies:
        return None
    records = rec.batches()
    i = len(records)
    while i and records[i - 1].profiled:
        i -= 1
    n = len(r.latencies)
    if i == len(records) or i < n:
        return None
    return records[i - n:i]


def device_only(w):
    """Whether the window records the device's activity alone: its host
    side holds the CUDA runtime's calls, the two marker launches among them,
    and none of the host's operations. A trace that records those (the
    harness's fallback when the device-only trace lost a marker) stretches
    the batch and keeps no launch to fit the clocks with, so its gaps are
    no reading of the device's idle time."""
    cats = {cat for _, _, _, cat in w.host}
    launches = sum(name.startswith("cudaLaunchKernel") for _, _, name, _ in w.host)
    return not cats & {"cpu_op", "user_annotation"} and launches >= 2


def host_clock(w):
    """The device window's clock -> the host's, both in the trace's us: the
    line through the two marker kernels, each put at the end of the runtime
    call that launched it. `Window.read` finds those calls by correlation id
    (`w.marks_host`); a window without them takes its first
    `cudaLaunchKernel` and the last one before its last
    `cudaDeviceSynchronize` (the harness launches the second marker, then
    synchronizes and pauses). The profiler maps the device's clock onto the
    host's with a drift that grows as a process runs; the markers bound the
    window on both clocks. Where the window holds no such calls (a trace of
    the host's operations), the identity."""
    marks = getattr(w, "marks_host", None)
    if marks is None:
        launches = [(a, b) for a, b, name, _ in w.host if name.startswith("cudaLaunchKernel")]
        syncs = [a for a, _, name, _ in w.host if name == "cudaDeviceSynchronize"]
        if syncs and launches and launches[0][0] < syncs[-1]:
            launches = [ab for ab in launches if ab[0] < syncs[-1]]
        if len(launches) >= 2:
            marks = launches[0][1], launches[-1][1]
    if marks is None or w.hi <= w.lo:
        return lambda us: us
    h0, h1 = marks
    scale = (h1 - h0) / (w.hi - w.lo)
    return lambda us: h0 + (us - w.lo) * scale


def profiled_batches(r, rec=None):
    """The profiled records inside the device window, or None."""
    rec = recorder() if rec is None else rec
    if rec is None or r.device_window is None or not device_only(r.device_window):
        return None
    w = r.device_window
    to_host = host_clock(w)
    lo, hi = to_host(w.lo), to_host(w.hi)
    got = [b for b in rec.batches() if b.profiled
           and lo <= rec.trace_us(b.spans[0].start_ns) and rec.trace_us(b.spans[0].end_ns) <= hi]
    return got or None


def _segments(batch, trace_us):
    """[(start_us, end_us, layer)] covering the batch's step span: each
    layer span owns the step's time from its start to the next layer span's
    start, the first also the step's head and the last its tail."""
    s0, s1 = trace_us(batch.spans[0].start_ns), trace_us(batch.spans[0].end_ns)
    starts = sorted((trace_us(s.start_ns), s.name) for s in batch.spans if s.name in LAYERS)
    if not starts:
        return []
    cuts = [s0] + [t for t, _ in starts[1:]] + [s1]
    return [(cuts[i], cuts[i + 1], name) for i, (_, name) in enumerate(starts)]


def _innermost(batch, trace_us):
    """[(start_us, end_us, span name)] covering the batch's step span: at
    each moment, the innermost span open on the step's thread (they nest on
    one thread; of two opened at the same stamp, the later-opened)."""
    spans = [(trace_us(s.start_ns), trace_us(s.end_ns), i, s.name) for i, s in enumerate(batch.spans)]
    cuts = sorted({t for a, b, _, _ in spans for t in (a, b)})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        open_ = [(s0, i, name) for s0, s1, i, name in spans if s0 <= a and b <= s1]
        if open_:
            name = max(open_)[2]
            if out and out[-1][2] == name and out[-1][1] == a:
                out[-1] = (out[-1][0], b, name)
            else:
                out.append((a, b, name))
    return out


def _split(gaps, to_host, segs):
    """{segment name or `OUTSIDE`: idle us}: each idle gap (start, length
    on the device's clock) split over the segments that cover it on the
    host's clock, in proportion to the time they cover; the rest of the gap
    is outside."""
    out = {OUTSIDE: 0.0}
    for g0, length in gaps:
        h0, h1 = to_host(g0), to_host(g0 + length)
        if h1 <= h0:
            out[OUTSIDE] += length
            continue
        covered = 0.0
        for a, b, name in segs:
            part = min(b, h1) - max(a, h0)
            if part > 0:
                share = length * part / (h1 - h0)
                out[name] = out.get(name, 0.0) + share
                covered += share
        out[OUTSIDE] += length - covered
    return out


def idle_split(r, rec=None):
    """{layer: idle us} over `LAYERS` and `OUTSIDE`, and the profiled
    frames, or None. Each layer span owns the step from its start to the
    next layer span's start (`_segments`); the parts add up to the window's
    idle time."""
    rec = recorder() if rec is None else rec
    batches = profiled_batches(r, rec)
    if not batches:
        return None
    segs = sorted(seg for b in batches for seg in _segments(b, rec.trace_us))
    out = dict.fromkeys(LAYERS + (OUTSIDE,), 0.0)
    out.update(_split(r.device_window.gaps(), host_clock(r.device_window), segs))
    return out, sum(b.frames for b in batches)


def report(r, rec=None, longest=10):
    """What a traced run's spans say of its device-only window, for a
    reader (`cellbench/span_report.py`), or None: the idle time by the
    innermost span the step's thread was in (us, and `OUTSIDE`), the
    `longest` gaps each with the innermost span that covers most of it, the
    lead of the window's first device operation over the first profiled
    step's opening (us on the host's clock; negative if the device ran
    first), and the mean count of each `sync.*` span per batch of the timed
    window."""
    rec = recorder() if rec is None else rec
    batches = profiled_batches(r, rec)
    if not batches:
        return None
    w = r.device_window
    to_host = host_clock(w)
    segs = sorted(seg for b in batches for seg in _innermost(b, rec.trace_us))
    gaps = []
    for g0, length in w.gaps()[:longest]:
        part = _split([(g0, length)], to_host, segs)
        gaps.append((length, max(part, key=part.get)))
    first = min(b.spans[0].start_ns for b in batches)
    window = window_batches(r, rec) or []
    names = sorted({s.name for b in window for s in b.spans if s.name.startswith("sync.")})
    return {"idle_us": _split(w.gaps(), to_host, segs), "longest_gaps": gaps,
            "first_op_lead_us": to_host(w.ops[0][1]) - rec.trace_us(first) if w.ops else None,
            "syncs_per_batch": {n: sum(s.name == n for b in window for s in b.spans) / len(window)
                                for n in names},
            "profiled_frames": sum(b.frames for b in batches)}


def idle_ms_per_frame(r, layer, rec=None):
    got = idle_split(r, rec)
    if got is None:
        return None
    split, frames = got
    return split[layer] * 1e-3 / frames if frames else None


def syncs(r, rec=None):
    """[(count, seconds)] of `sync.*` spans per batch of the timed window,
    and its frames, or None."""
    batches = window_batches(r, rec)
    if batches is None:
        return None
    per = [[s.end_ns - s.start_ns for s in b.spans if s.name.startswith("sync.")] for b in batches]
    return [(len(p), sum(p) * 1e-9) for p in per], sum(b.frames for b in batches)
