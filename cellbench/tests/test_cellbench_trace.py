"""A profiled window is bounded by the two spin kernels it finds on the
device by name, whatever records the trace lost ahead of them."""

import pytest

from cellbench import spans, trace


def _call(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 2.0,
            "args": {"correlation": corr}}


def _dev(corr, ts, dur, name="void k()", cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _events(spins=(9, 11)):
    events = [_call(c, 10.0 * c) for c in range(1, 12)]
    # the first three kernels ahead of the markers lost their device records
    events += [_dev(c, 50.0 + c, 0.5) for c in range(4, 9)]
    events += [_dev(c, 100.0 if c == 9 else 200.0, 5.0, name="at::cuda::spin_kernel(long)") for c in spins]
    events += [_dev(10, 110.0, 20.0), _dev(10, 120.0, 10.0, name="Memcpy HtoD", cat="gpu_memcpy")]
    return events


def test_the_window_lies_between_the_spin_kernels():
    w = trace.Window.read(_events())
    assert (w.lo, w.hi) == (105.0, 200.0)
    assert [o[0] for o in w.ops] == ["void k()", "Memcpy HtoD"]
    assert w.busy_us() == 20.0 and w.window_us == 95.0
    # the markers' launch calls end at 92 and 112 on the host's clock
    assert w.marks_host == (92.0, 112.0)
    to_host = spans.host_clock(w)
    assert to_host(105.0) == pytest.approx(92.0) and to_host(200.0) == pytest.approx(112.0)


@pytest.mark.parametrize("spins", [(9,), (9, 10, 11)])
def test_a_trace_without_exactly_two_markers_is_refused(spins):
    assert trace.Window.read(_events(spins)) is None
