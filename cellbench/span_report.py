"""A traced run of one cell, then what the program's spans say of its
device-only window, as one more JSON line:

    python3 cellbench/span_report.py --workload <name> --seed <n> --seconds <s>

from the root of a checkout, on a card. The run is `cellbench/run.py
--trace 1` as the benchmark makes it (its line is printed first); the
report (`cellbench/spans.py::report`) follows on the last line: the
device's idle time by the innermost span the counting step's thread was
in, in ms a profiled frame and in shares of the idle time; the longest
gaps with their span; the lead of the window's first device operation
over the profiled step's opening; the `sync.*` spans per batch of the
timed window; and a span's cost in us on this host, without a profiler
and under a device-only and a host-and-device one. The report is null
where the run kept no device-only window (a run without a card, or one
whose device-only trace lost a marker).
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def span_cost_us(n=20000):
    """The mean cost of one empty span of the program's recorder, in us:
    without a profiler, and under a profiler of the device alone and of the
    host and the device (each span then also opens a named range)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from vehicle_counting_tpu_torch.utils.profiling import span

    def per():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span("span_report.cost"):
                pass
        return (time.perf_counter_ns() - t0) / n * 1e-3

    out = {"none": per()}
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for name, acts in (("device", [ProfilerActivity.CUDA]), ("host_device", both)):
        with profile(activities=acts):
            out[name] = per()
    return out


def main(argv=None):
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from cellbench import run, spans

    kept = []

    class Kept(run.Record):
        def __init__(self):
            super().__init__()
            kept.append(self)

    run.Record = Kept
    argv = list(sys.argv[1:] if argv is None else argv)
    rc = run.main(argv + ["--trace", "1"])
    got = spans.report(kept[-1]) if kept else None
    if got is not None:
        idle, frames = got["idle_us"], got["profiled_frames"]
        total = sum(idle.values())
        got = {"idle_ms_per_frame": {k: v * 1e-3 / frames for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
               "idle_share_pct": {k: 100.0 * v / total for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
               "longest_gaps_ms": [[us * 1e-3, name] for us, name in got["longest_gaps"]],
               "first_op_lead_ms": None if got["first_op_lead_us"] is None else got["first_op_lead_us"] * 1e-3,
               "syncs_per_batch": got["syncs_per_batch"], "profiled_frames": frames,
               "span_cost_us": span_cost_us()}
    print(json.dumps({"span_report": got}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
