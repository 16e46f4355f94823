"""Summarize a torch.profiler Chrome trace: device self time by kernel and by category.

Companion to the CLI's --profile flag (utils/profiling.py::trace) and
stage_bench's --trace. From the exported trace it prints what matters for
this workload on the card: the top device kernels by self time, self time
by category (convolution/GEMM, elementwise/index, this package's own
kernels, memcpy), the share of the traced window in which the card was
busy, device kernels per frame (with --frames) and the longest idle gaps.
With --convs, a roofline table of the convolutions: per distinct shape,
the device time of the kernels each `aten::convolution` launched, its
FLOPs from the recorded shapes, and the achieved share of the H100's
dense peak for its type.

Usage:
    python -m vehicle_counting_tpu_torch.tools.profile_summary <dir-or-trace.json> [-n TOP] [--frames N] [--convs]

Only `json` and the standard library: no profiler package is needed to
read a trace.
"""

from __future__ import annotations

import argparse
import ast
import bisect
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


def read_events(trace_path: str) -> List[dict]:
    """Every event of a Chrome trace."""
    with open(trace_path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def device_events(events: List[dict]) -> List[DeviceEvent]:
    """The device's kernels, copies and memsets among a trace's events, by start."""
    out = [DeviceEvent(str(e.get("name", "")), e["cat"], float(e["ts"]), float(e.get("dur", 0.0)))
           for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    out.sort(key=lambda e: e.ts_us)
    return out


def load_device_events(trace_path: str) -> List[DeviceEvent]:
    """`device_events` of the trace at `trace_path`."""
    return device_events(read_events(trace_path))


# Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; at the
# full 700 W power limit) in TFLOP/s, by a convolution's input type as the
# trace names it. cuDNN runs f32 convolutions on the tensor cores as TF32
# (PyTorch's default `torch.backends.cudnn.allow_tf32`).
H100_PEAK_TFLOPS = {"c10::BFloat16": 989.0, "c10::Half": 989.0, "float": 495.0}


class ConvCall(NamedTuple):
    shape: str        # input and weight dims, stride, padding, groups
    dtype: str        # the input's type as the trace names it
    flops: float
    device_us: float  # the kernels it launched


def conv_calls(events: List[dict]) -> List[ConvCall]:
    """Every `aten::convolution` host op of a trace recorded with shapes
    (`utils/profiling.py::trace` records them), with its FLOPs from the
    shapes and the device time of the kernels it launched: the launch calls
    on its thread inside its span, matched to kernels by correlation id."""
    kernel_us = defaultdict(float)
    launches = defaultdict(list)  # (pid, tid) -> [(ts, correlation)]
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("ph") != "X" or corr is None:
            continue
        if e.get("cat") == "kernel":
            kernel_us[corr] += float(e.get("dur", 0.0))
        elif e.get("cat") in ("cuda_runtime", "cuda_driver"):
            launches[(e.get("pid"), e.get("tid"))].append((float(e["ts"]), corr))
    for v in launches.values():
        v.sort()
    out = []
    for e in events:
        args = e.get("args") or {}
        if e.get("ph") != "X" or e.get("name") != "aten::convolution" or "Concrete Inputs" not in args:
            continue
        (n, c, h, w), (o, i, kh, kw) = args["Input Dims"][:2]
        stride, pad, dil, transposed, _, groups = args["Concrete Inputs"][3:9]
        if transposed == "True":
            continue
        (sh, sw), (ph, pw), (dh, dw) = (ast.literal_eval(v) for v in (stride, pad, dil))
        ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
        wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        run = launches.get((e.get("pid"), e.get("tid")), [])
        lo = bisect.bisect_left(run, (t0, -1))
        us = sum(kernel_us[corr] for ts, corr in run[lo:bisect.bisect_right(run, (t1, float("inf")))])
        out.append(ConvCall(f"x=[{n}, {c}, {h}, {w}] w=[{o}, {i}, {kh}, {kw}] s={sh} p={ph} g={groups}",
                            args["Input type"][0], 2.0 * n * o * ho * wo * i * kh * kw, us))
    return out


def print_conv_roofline(calls: List[ConvCall], div: float, unit: str) -> None:
    by_shape = defaultdict(lambda: [0, 0.0, 0.0])
    for cc in calls:
        row = by_shape[(cc.shape, cc.dtype)]
        row[0] += 1
        row[1] += cc.flops
        row[2] += cc.device_us
    print("\n== convolution roofline (H100 dense peak: "
          + ", ".join(f"{k} {v:g}" for k, v in H100_PEAK_TFLOPS.items()) + " TFLOP/s) ==")
    if not calls:
        print("  no aten::convolution with recorded shapes in this trace")
        return
    total_us = sum(cc.device_us for cc in calls)
    if not total_us:
        print(f"  {len(calls)} convolutions, no device kernels under them (a CPU trace)")
        return
    for (shape, dtype), (n, flops, us) in sorted(by_shape.items(), key=lambda kv: -kv[1][2])[:20]:
        tflops = flops / (us * 1e-6) / 1e12 if us else 0.0
        peak = H100_PEAK_TFLOPS.get(dtype)
        share = f"{100.0 * tflops / peak:5.1f} %" if peak else "    -  "
        print(f"  {us / div:10.1f} {unit} x{n:6d}  {tflops:7.1f} TF/s ({share})  {dtype:14s} {shape}")
    agg = sum(cc.flops for cc in calls if cc.device_us) / (total_us * 1e-6) / 1e12
    print(f"  ALL convs: {total_us / div:.1f} {unit} over {len(calls)} calls, {agg:.1f} TF/s")


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
    ap.add_argument("--convs", action="store_true",
                    help="per-convolution roofline table: FLOPs from the recorded shapes, the device time of "
                    "each convolution's kernels, achieved TFLOP/s and %% of the H100 dense peak per distinct shape")
    args = ap.parse_args(argv)

    path = find_trace(args.trace)
    events = read_events(path)
    s = summarize(device_events(events), frames=args.frames, top=args.top)
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
    if args.convs:
        print_conv_roofline(conv_calls(events), div, unit)
    print("\n== longest idle gaps (us, at us from the first device event) ==")
    for d, at in s["idle_gaps"]:
        print(f"  {d:12.1f} us  at {at:14.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
