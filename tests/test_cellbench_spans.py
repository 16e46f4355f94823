"""The benchmark's readers of the program's spans (`cellbench/spans.py` and
the six `cellbench/metrics/*.py` that use it) on a hand-built device window
and hand-built batch records: exact values, the idle split adding up to the
window's idle time, the window's batches without warm-up or profiled ones,
and None wherever there is nothing to read."""

import os
import types

import pytest

from cellbench import run, spans
from cellbench.trace import Window

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("host_syncs_per_batch", "sync_wait_ms_per_frame", "detect_idle_ms_per_frame", "embed_idle_ms_per_frame",
         "track_idle_ms_per_frame", "outside_step_idle_ms_per_frame")
US = 1000  # ns per us: the fake recorder's trace clock is its stamps in us


def _span(name, start_us, end_us):
    return types.SimpleNamespace(name=name, start_ns=int(start_us * US), end_ns=int(end_us * US))


def _batch(profiled, frames, step, *others):
    return types.SimpleNamespace(profiled=profiled, frames=frames, thread=1, spans=[_span("step", *step)]
                                 + [_span(*o) for o in others])


class FakeRecorder:
    def __init__(self, records):
        self.records = records

    def batches(self):
        return list(self.records)

    def trace_us(self, ns, base_ns=None):
        return ns / US


def _window(shift=0.0, scale=1.0):
    """Device ops at [100, 200], [400, 500], [700, 900] between markers at 0
    and 1000 (device clock): idle 100 + 200 + 200 + 100 = 600 us. The host
    clock is the device's times `scale` plus `shift`: the marker launches
    end at `shift` and `shift + 1000 * scale`."""
    w = Window()
    w.lo, w.hi = 0.0, 1000.0
    w.ops = [("k", 100.0, 100.0), ("k", 400.0, 100.0), ("k", 700.0, 200.0)]
    w.host = [(shift - 5.0, shift, "cudaLaunchKernel", "cuda_runtime"),
              (shift + 300.0, shift + 302.0, "cudaGraphLaunch", "cuda_runtime"),
              (shift + 1000.0 * scale - 5.0, shift + 1000.0 * scale, "cudaLaunchKernel", "cuda_runtime")]
    return w


def _records(shift=0.0, scale=1.0):
    h = lambda us: shift + us * scale  # noqa: E731  (device us -> host us)
    warm = [_batch(False, 4, (-9000, -8900), ("sync.nms", -8990, -8900)) for _ in range(2)]
    timed = [
        _batch(False, 4, (-7000, -6000), ("detect", -6990, -6500), ("sync.nms", -6900, -6899),
               ("sync.nms", -6800, -6798), ("embed", -6500, -6300), ("sync.embed_count", -6490, -6487),
               ("track", -6300, -6010)),
        _batch(False, 4, (-5000, -4000), ("detect", -4990, -4500), ("sync.nms", -4900, -4896),
               ("embed", -4500, -4300), ("sync.embed_count", -4490, -4485), ("track", -4300, -4010)),
    ]
    # profiled: one under the host-recorded trace (outside the device window), one inside it
    host_traced = _batch(True, 4, (-3000, -2000), ("sync.nms", -2990, -2000))
    device_traced = _batch(True, 4, (h(50), h(950)), ("detect", h(60), h(300)), ("sync.nms", h(70), h(80)),
                           ("embed", h(300), h(600)), ("track", h(650), h(940)))
    return warm + timed + [host_traced, device_traced]


@pytest.fixture
def readers():
    return {n: run._reader(os.path.join(ROOT, "cellbench", "metrics", n + ".py")) for n in NAMES}


def _record(window):
    r = run.Record()
    r.device_window = window
    r.latencies = [0.5, 0.5]  # the two timed batches
    r.frames = 8
    return r


@pytest.mark.parametrize("shift, scale", [(0.0, 1.0), (12345.0, 1.0), (-250.0, 1.01)])
def test_each_reader_gives_the_exact_value(monkeypatch, readers, shift, scale):
    monkeypatch.setattr(spans, "recorder", lambda: FakeRecorder(_records(shift, scale)))
    got = {n: f(_record(_window(shift, scale))) for n, f in readers.items()}
    # timed batches: 3 and 2 syncs; waits 1 + 2 + 3 and 4 + 5 us over 8 frames
    assert got["host_syncs_per_batch"] == pytest.approx(2.5)
    assert got["sync_wait_ms_per_frame"] == pytest.approx(15e-3 / 8)
    # the step [50, 950] cut at the layers' starts: detect [50, 300), embed
    # [300, 650), track [650, 950); outside [0, 50) and [950, 1000)
    assert got["detect_idle_ms_per_frame"] == pytest.approx(150e-3 / 4)
    assert got["embed_idle_ms_per_frame"] == pytest.approx(250e-3 / 4)
    assert got["track_idle_ms_per_frame"] == pytest.approx(100e-3 / 4)
    assert got["outside_step_idle_ms_per_frame"] == pytest.approx(100e-3 / 4)


def test_the_idle_split_adds_up_to_the_windows_idle_time(monkeypatch):
    w = _window(7.0, 0.98)
    w.ops = [("k", 30.0, 45.0), ("k", 60.0, 10.0), ("k", 333.0, 1.0), ("k", 640.0, 200.0), ("k", 990.0, 3.0)]
    r = _record(w)
    split, frames = spans.idle_split(r, FakeRecorder(_records(7.0, 0.98)))
    assert frames == 4 and set(split) == {"detect", "embed", "track", "outside_step"}
    assert sum(split.values()) == pytest.approx(w.window_us - w.busy_us(), rel=1e-12)
    assert all(v >= 0.0 for v in split.values())


def test_warm_up_and_profiled_batches_stay_out_of_the_window():
    records = _records()
    r = _record(_window())
    got = spans.window_batches(r, FakeRecorder(records))
    assert got == records[2:4]
    assert spans.profiled_batches(r, FakeRecorder(records)) == [records[-1]]
    # a window longer than what precedes the profiled records has nothing to read
    r.latencies = [0.5] * 5
    assert spans.window_batches(r, FakeRecorder(records)) is None
    # nor has a run whose records hold no profiled batch
    assert spans.window_batches(_record(_window()), FakeRecorder(records[:4])) is None


def test_every_reader_gives_none_without_a_device_window_or_a_recorder(monkeypatch, readers):
    monkeypatch.setattr(spans, "recorder", lambda: FakeRecorder(_records()))
    assert {n: f(_record(None)) for n, f in readers.items()} == dict.fromkeys(NAMES)
    monkeypatch.setattr(spans, "recorder", lambda: None)  # a program without the recorder
    assert {n: f(_record(_window())) for n, f in readers.items()} == dict.fromkeys(NAMES)


def test_the_programs_recorder_is_found():
    from vehicle_counting_tpu_torch.utils.profiling import RECORDER

    assert spans.recorder() is RECORDER


def test_a_window_without_marker_launches_keeps_the_trace_clock():
    w = _window(500.0, 2.0)
    w.host = [(10.0, 20.0, "aten::add", "cpu_op")]
    to_host = spans.host_clock(w)
    assert to_host(123.5) == 123.5
    fitted = spans.host_clock(_window(500.0, 2.0))
    assert fitted(0.0) == pytest.approx(500.0) and fitted(1000.0) == pytest.approx(2500.0)


def test_a_host_recorded_window_gives_no_idle_reading(monkeypatch, readers):
    """The harness's fallback, a trace of the host's operations, keeps no
    marker launch and stretches the batch: the idle readers give None and
    the sync readers still read the window's records."""
    monkeypatch.setattr(spans, "recorder", lambda: FakeRecorder(_records()))
    w = _window()
    w.host = [(-5.0, 1200.0, "vct.step", "user_annotation"), (60.0, 70.0, "aten::add", "cpu_op")]
    got = {n: f(_record(w)) for n, f in readers.items()}
    assert not spans.device_only(w) and spans.device_only(_window())
    assert got["host_syncs_per_batch"] == pytest.approx(2.5)
    assert {n: v for n, v in got.items() if "idle" in n} == dict.fromkeys(NAMES[2:])
    assert spans.report(_record(w)) is None


def test_the_second_marker_is_the_last_launch_before_the_trailing_sync():
    w = _window(500.0, 2.0)
    # the harness synchronizes after the second marker; a launch after that
    # (another thread's) is no marker
    w.host += [(2501.0, 2510.0, "cudaDeviceSynchronize", "cuda_runtime"),
               (2600.0, 2605.0, "cudaLaunchKernel", "cuda_runtime")]
    to_host = spans.host_clock(w)
    assert to_host(0.0) == pytest.approx(500.0) and to_host(1000.0) == pytest.approx(2500.0)


@pytest.mark.parametrize("shift, scale", [(0.0, 1.0), (12345.0, 1.0), (-250.0, 1.01)])
def test_the_report_puts_idle_time_on_the_innermost_span(shift, scale):
    got = spans.report(_record(_window(shift, scale)), FakeRecorder(_records(shift, scale)))
    # innermost on the step's thread: step [50, 60), detect [60, 70),
    # sync.nms [70, 80), detect [80, 300), embed [300, 600), step [600,
    # 650), track [650, 940), step [940, 950); the gaps [0, 100), [200,
    # 400), [500, 700), [900, 1000)
    want = {"outside_step": 100.0, "step": 70.0, "detect": 130.0, "sync.nms": 10.0, "embed": 200.0, "track": 90.0}
    assert got["idle_us"] == pytest.approx(want)
    assert got["profiled_frames"] == 4
    assert [g[0] for g in got["longest_gaps"]] == pytest.approx([200.0, 200.0, 100.0, 100.0])
    assert [g[1] for g in got["longest_gaps"]][1:] == ["embed", "outside_step", "outside_step"]
    assert got["first_op_lead_us"] == pytest.approx(50.0 * scale)
    assert got["syncs_per_batch"] == {"sync.embed_count": 1.0, "sync.nms": 1.5}
