"""A `torch.profiler` window of a run, read back from its Chrome trace:
the device's operations between two marker kernels and, where the host's
operations were recorded with their shapes, each `aten::convolution` with
its shapes and the device time of the kernels it launched, and the host's
activity over the device's idle gaps. Recording the host's operations and
shapes slows the host, so the device's idle share and busy time are taken
from a window that records the device's activity alone, where the host
shows only its CUDA runtime calls.

The markers: the profiler maps the device's clock onto the host's with a
drift of either sign, so a window bounded on the host's clock can lose its
first or last kernels. The region is bracketed on the device by two
launches of the spin kernel of `torch.cuda._sleep`, which the program never
launches, with pauses before and after them inside the trace, and found on
the device by name. A later profiler session of a process can lose the
device records of its first few kernels, so a few other kernels are
launched ahead of the first marker to take that loss. A trace without
exactly two markers on the device is taken again with pauses twice as
long (the method of the port's `chip_smoke.py`).
"""

from __future__ import annotations

import ast
import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CALLS = ("cuda_runtime", "cuda_driver")
REGION = "cellbench_region"
SPIN = "spin_kernel"  # the kernel of torch.cuda._sleep
SPIN_CYCLES = 1000
AHEAD = 8  # kernels launched ahead of the first marker


def profile(fn, host=True, shapes=True, tries=(0.25, 0.5, 1.0)):
    """Run fn() once under the profiler, between the markers, with the
    host's operations (`host`) and their shapes (`shapes`) recorded, or the
    device's activity alone. Returns the parsed `Window`; raises when every
    try lost a marker."""
    import torch
    from torch.profiler import ProfilerActivity

    ahead = torch.zeros(8, device="cuda")
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    seen = []
    for pause in tries:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            with torch.profiler.profile(activities=activities, record_shapes=host and shapes) as prof:
                for _ in range(AHEAD):
                    ahead.add_(1.0)
                torch.cuda.synchronize()
                time.sleep(pause)
                with torch.profiler.record_function(REGION):
                    torch.cuda._sleep(SPIN_CYCLES)
                    out = fn()
                    torch.cuda._sleep(SPIN_CYCLES)
                    torch.cuda.synchronize()
                time.sleep(pause)
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        events = [e for e in (data["traceEvents"] if isinstance(data, dict) else data) if e.get("ph") == "X"]
        del data
        w = Window.read(events)
        if w is not None:
            w.result = out
            return w
        seen.append(pause)
    raise RuntimeError(f"the profiled window lost a marker kernel in every try (pauses {seen} s)")


class Window:
    """The device's operations [(name, start_us, dur_us)] between the
    markers (device clock), the window's bounds, the convolutions and the
    host's named ranges."""

    @classmethod
    def read(cls, events):
        """The window of a trace, or None unless the device shows exactly two
        markers. A trace of the device's activity alone (no host region)
        also gives `marks_host`: the end of each marker's launch call on the
        host's clock, found by correlation id, or None."""
        region = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
                  if e.get("name") == REGION and e.get("cat") != "gpu_user_annotation"]
        start = min((r[0] for r in region), default=float("-inf"))
        stop = max((r[1] for r in region), default=float("inf"))
        device = sorted((e for e in events if e.get("cat") in DEVICE_CATS), key=lambda e: float(e["ts"]))
        marks = [e for e in device if SPIN in str(e.get("name", ""))]
        if len(marks) != 2:
            return None
        self = cls()
        self.lo = float(marks[0]["ts"]) + float(marks[0].get("dur", 0.0))
        self.hi = float(marks[1]["ts"])
        self.ops = [(str(e.get("name", "")), float(e["ts"]), float(e.get("dur", 0.0))) for e in device
                    if SPIN not in str(e.get("name", "")) and self.lo <= float(e["ts"]) <= self.hi]
        self.marks_host = None
        if not region:
            ends = {(e.get("args") or {}).get("correlation"): float(e["ts"]) + float(e.get("dur", 0.0))
                    for e in events if e.get("cat") in HOST_CALLS}
            got = [ends.get((m.get("args") or {}).get("correlation")) for m in marks]
            self.marks_host = None if None in got else tuple(got)
        self.convs = _conv_calls(events, start, stop)
        host_cats = ("cpu_op", "user_annotation") if region else HOST_CALLS
        self.host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), str(e.get("name", "")),
                            e.get("cat")) for e in events
                           if e.get("cat") in host_cats and start <= float(e["ts"]) <= stop
                           and e.get("name") != REGION)
        return self

    @property
    def window_us(self) -> float:
        return self.hi - self.lo

    def busy_us(self) -> float:
        """The union of the device operations' intervals."""
        busy, end = 0.0, self.lo
        for _, ts, dur in self.ops:
            a, b = max(ts, end), min(ts + dur, self.hi)
            if b > a:
                busy += b - a
                end = b
        return busy

    def gaps(self):
        """[(start_us, length_us)] of the device's idle gaps, longest first."""
        out, end = [], self.lo
        for _, ts, dur in self.ops + [("", self.hi, 0.0)]:
            if ts > end:
                out.append((end, ts - end))
            end = max(end, ts + dur)
        return sorted(out, key=lambda g: -g[1])

    def host_at(self, ts: float) -> str:
        """The innermost named range and host op running at `ts` (the
        host's clock)."""
        label, op = "", ""
        for a, b, name, cat in self.host:
            if a > ts:
                break
            if b >= ts:
                if cat == "user_annotation":
                    label = name
                else:
                    op = name
        return f"{label} {op}".strip() or "idle host"

    def kernel_us(self, needle: str):
        """(total device us, count) of the operations whose name holds `needle`."""
        hits = [dur for name, _, dur in self.ops if needle in name]
        return sum(hits), len(hits)


def _conv_calls(events, start, stop):
    """[(x dims, w dims, stride, pad, dil, groups, dtype, device us)] of
    every `aten::convolution` in the region: the launch calls on its thread
    inside its span, matched to device operations by correlation id (the
    arithmetic of the port's `tools/profile_summary.py --convs`)."""
    dev_us = defaultdict(float)
    launches = defaultdict(list)
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if corr is None:
            continue
        if e.get("cat") in DEVICE_CATS:
            dev_us[corr] += float(e.get("dur", 0.0))
        elif e.get("cat") in HOST_CALLS:
            launches[(e.get("pid"), e.get("tid"))].append((float(e["ts"]), corr))
    for v in launches.values():
        v.sort()
    out = []
    for e in events:
        args = e.get("args") or {}
        if e.get("name") != "aten::convolution" or "Concrete Inputs" not in args:
            continue
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if not start <= t0 <= stop:
            continue
        stride, pad, dil, transposed, _, groups = args["Concrete Inputs"][3:9]
        if transposed == "True":
            continue
        run = launches.get((e.get("pid"), e.get("tid")), [])
        lo = bisect.bisect_left(run, (t0, -1))
        us = sum(dev_us[corr] for _, corr in run[lo:bisect.bisect_right(run, (t1, float("inf")))])
        out.append((args["Input Dims"][0], args["Input Dims"][1], ast.literal_eval(stride), ast.literal_eval(pad),
                    ast.literal_eval(dil), int(groups), args["Input type"][0], us))
    return out
