"""Per-stage wall-time accounting for the pipeline (`--debug`).

Copy of `vehicle_counting_tpu/utils/profiling.py::StageTimer`; that
module's package also carries the JAX trace hooks.
"""

from __future__ import annotations

import contextlib
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
