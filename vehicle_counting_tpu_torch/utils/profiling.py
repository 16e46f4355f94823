"""Tracing/profiling hooks (counterpart of the JAX package's
`utils/profiling.py`).

`StageTimer` records wall time per pipeline stage (`--debug`); `trace`
wraps `torch.profiler` around a region and writes a Chrome trace that
`tools/profile_summary.py` reads.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict


class StageTimer:
    """Accumulates wall time per named stage; cheap enough to always run."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name}: {t:.3f}s total, {t / max(n, 1) * 1e3:.2f}ms avg x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str = "vct_trace"):
    """`torch.profiler` capture of the enclosed region (host ops and, where
    there is a card, its kernels and copies). On exit the Chrome trace is
    written to `log_dir/trace_<ns>.json`; the yielded dict gets its path
    under "path". View it in Perfetto or chrome://tracing, or summarise it
    with `python -m vehicle_counting_tpu_torch.tools.profile_summary`. Host
    ops carry their input shapes, from which `profile_summary --convs`
    counts each convolution's FLOPs.

    The trace holds one event per host op and per device kernel: a B=128
    batch of the counting step is ~67,000 device events and ~160 MB of
    JSON, and the traced run is several times slower, so trace a batch or
    two, not a whole video.
    """
    import torch
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
