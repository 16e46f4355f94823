"""Summarize a torch.profiler Chrome trace: device self time by kernel and by category.

Companion to the CLI's --profile flag (utils/profiling.py::trace) and
stage_bench's --trace. From the exported trace it prints what matters for
this workload on the card: the top device kernels by self time, self time
by category (convolution/GEMM, elementwise/index, this package's own
kernels, memcpy), the share of the traced window in which the card was
busy, device kernels per frame (with --frames) and the longest idle gaps.

Usage:
    python -m vehicle_counting_tpu_torch.tools.profile_summary <dir-or-trace.json> [-n TOP] [--frames N]

Only `json` and the standard library: no profiler package is needed to
read a trace.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")



def own_kernel_names() -> List[str]:
    """The names of the __global__ functions of this package's csrc/*.cu,
    read from the sources, so that a new kernel is recognised as ours."""
    csrc = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
    names = []
    for path in sorted(glob.glob(os.path.join(csrc, "*.cu"))):
        with open(path) as f:
            names += re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", f.read())
    return names


_OWN = re.compile("|".join(rf"\b{n}\b" for n in own_kernel_names()) or r"(?!)")
_GEMM_CONV = re.compile(r"gemm|gemv|cutlass|cublas|cudnn|xmma|convolve|fprop|wgrad|dgrad|winograd|implicit|sm\d+_|nchwToNhwc|nhwcToNchw", re.I)


class DeviceEvent(NamedTuple):
    name: str
    cat: str
    ts_us: float
    dur_us: float


def find_trace(path: str) -> str:
    """`path` itself when it is a .json trace, else the newest under it."""
    if os.path.isfile(path):
        return path
    hits = glob.glob(os.path.join(path, "**", "*.json"), recursive=True)
    if not hits:
        raise SystemExit(f"no .json trace under {path}")
    return max(hits, key=os.path.getmtime)


def load_device_events(trace_path: str) -> List[DeviceEvent]:
    """The device's kernels, copies and memsets of a Chrome trace, by start."""
    with open(trace_path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    out = [DeviceEvent(str(e.get("name", "")), e["cat"], float(e["ts"]), float(e.get("dur", 0.0)))
           for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    out.sort(key=lambda e: e.ts_us)
    return out


def category(ev: DeviceEvent) -> str:
    if ev.cat != "kernel":
        return "memcpy/memset"
    if _OWN.search(ev.name):
        return "vct kernels (csrc/)"
    if _GEMM_CONV.search(ev.name):
        return "convolution/GEMM"
    return "elementwise/index/other"


def summarize(events: List[DeviceEvent], frames: Optional[int] = None, top: int = 25, gaps: int = 10) -> Dict:
    """Numbers of one trace. Times in us; `busy_us` is the union of the
    device events' intervals (kernels on several streams may overlap),
    `window_us` the span from the first event's start to the last one's
    end, idle gaps the stretches of the window no event covers."""
    by_name, by_cat, count = defaultdict(float), defaultdict(float), defaultdict(int)
    for e in events:
        by_name[e.name] += e.dur_us
        count[e.name] += 1
        by_cat[category(e)] += e.dur_us
    busy, idle, end = 0.0, [], None
    for e in events:
        if end is None:
            end = e.ts_us
        if e.ts_us > end:
            idle.append((e.ts_us - end, end))
            end = e.ts_us
        stop = e.ts_us + e.dur_us
        if stop > end:
            busy += stop - end
            end = stop
    window = (end - events[0].ts_us) if events else 0.0
    n_kernels = sum(1 for e in events if e.cat == "kernel")
    t0 = events[0].ts_us if events else 0.0
    return {
        "device_events": len(events),
        "device_kernels": n_kernels,
        "self_us": sum(by_name.values()),
        "busy_us": busy,
        "window_us": window,
        "busy_share": busy / window if window else 0.0,
        "kernels_per_frame": n_kernels / frames if frames else None,
        "by_category": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
        "top": [(n, t, count[n]) for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [(d, at - t0) for d, at in sorted(idle, reverse=True)[:gaps]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="trace dir (from --profile / --trace) or a trace .json")
    ap.add_argument("-n", "--top", type=int, default=25)
    ap.add_argument("--frames", type=int, default=None,
                    help="frames the traced region processed: prints us/frame and device kernels per frame")
    args = ap.parse_args(argv)

    path = find_trace(args.trace)
    s = summarize(load_device_events(path), frames=args.frames, top=args.top)
    div = args.frames or 1
    unit = "us/frame" if args.frames else "us"
    print(path)
    if not s["device_events"]:
        print("no device events in this trace (a CPU run, or the profiler did not trace the card)")
        return 0
    print(f"device events: {s['device_events']} ({s['device_kernels']} kernels); "
          f"total device self time: {s['self_us'] / div:.1f} {unit}")
    print(f"traced window {s['window_us'] / 1e3:.3f} ms, device busy {s['busy_us'] / 1e3:.3f} ms "
          f"= {100 * s['busy_share']:.1f} % (idle {100 * (1 - s['busy_share']):.1f} %)")
    if args.frames:
        print(f"device kernels per frame: {s['kernels_per_frame']:.1f}")
    print("\n== self time by category ==")
    for c, t in s["by_category"].items():
        print(f"  {t / div:12.1f} {unit}  {100 * t / s['self_us']:5.1f} %  {c}")
    print(f"\n== top {args.top} device kernels by self time ==")
    for name, t, n in s["top"]:
        print(f"  {t / div:12.1f} {unit} x{n:7d}  {name[:110]}")
    print("\n== longest idle gaps (us, at us from the first device event) ==")
    for d, at in s["idle_gaps"]:
        print(f"  {d:12.1f} us  at {at:14.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
