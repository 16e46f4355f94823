"""The readers of the detector's busy time and roofline
(`cellbench/launch_spans.py`, `cellbench/detector_counts.py` and their
three metrics) on hand-built traces: each device operation goes to the
span the step's thread was in when it launched it, matched by correlation
id; the roofline's FLOPs and bytes of one convolution by hand; None
wherever there is nothing to read."""

import types

import pytest

from cellbench import counts, detector_counts, launch_spans, run
from cellbench.metrics import detect_net_busy_ms_per_frame, detect_net_roofline, detect_tail_busy_ms_per_frame
from cellbench.trace import Window

US = 1000  # ns per us: the fake recorder's trace clock is its stamps in us
STEP_TID, FEED_TID = 7, 9


def _event(cat, name, ts, dur, corr, tid=STEP_TID):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": {"correlation": corr}}


def _events():
    """Markers at 0 and 1000 on the device, launched at host 0 and 990 by
    the step's thread. Device operations (device clock = host clock):
    A [100, 200] and B [150, 250], launched at 50 and 60 (in `detect.net`);
    C [300, 350] launched at 120 (in `detect.tail`); D [400, 450] launched at
    55 by the feed's thread; E [500, 600] launched at 300 (in `track`); F
    [700, 720], a copy whose launch the trace lost."""
    ev = [_event("cuda_runtime", "cudaLaunchKernel", 0, 1, 1), _event("kernel", "spin_kernel", -10, 10, 1),
          _event("cuda_runtime", "cudaLaunchKernel", 990, 1, 2), _event("kernel", "spin_kernel", 1000, 10, 2)]
    for corr, (launch, tid, start, end) in enumerate([(50, STEP_TID, 100, 200), (60, STEP_TID, 150, 250),
                                                      (120, STEP_TID, 300, 350), (55, FEED_TID, 400, 450),
                                                      (300, STEP_TID, 500, 600)], start=10):
        ev.append(_event("cuda_runtime", "cudaLaunchKernel", launch, 2, corr, tid))
        ev.append(_event("kernel", f"k{corr}", start, end - start, corr, tid=0))
    ev.append(_event("gpu_memcpy", "Memcpy HtoD", 700, 20, 99, tid=0))
    return ev


def _span(name, start_us, end_us):
    return types.SimpleNamespace(name=name, start_ns=int(start_us * US), end_ns=int(end_us * US))


class FakeRecorder:
    def __init__(self, *spans):
        self.records = [types.SimpleNamespace(profiled=True, frames=4, thread=1,
                                              spans=[_span("step", 5, 900)] + [_span(*s) for s in spans])]

    def batches(self):
        return list(self.records)

    def trace_us(self, ns, base_ns=None):
        return ns / US


REC = FakeRecorder(("detect", 40, 200), ("detect.pixels", 40, 45), ("detect.net", 45, 100), ("detect.tail", 100, 200),
                   ("track", 200, 900))


def _record(w):
    return types.SimpleNamespace(device_window=w, window=None, peaks=counts.PEAKS["NVIDIA H100"], latencies=[])


def test_the_read_window_keeps_each_operations_launch():
    w = Window.read(_events())
    assert [name for name, _, _ in w.ops] == ["k10", "k11", "k12", "k13", "k14", "Memcpy HtoD"]
    assert w.launched == [(50.0, STEP_TID), (60.0, STEP_TID), (120.0, STEP_TID), (55.0, FEED_TID),
                          (300.0, STEP_TID), None]
    assert w.step_tid == STEP_TID and w.marks_host == (1.0, 991.0)
    launch_spans.install()  # a second install keeps the one wrap
    assert Window.read(_events()).launched == w.launched


def test_busy_time_by_the_span_that_launched_it():
    """`detect.net`: A and B, whose union is 150 us; D ran then too but
    the feed's thread launched it. `detect.tail`: C, 50 us. Over 4 frames."""
    r = _record(Window.read(_events()))
    assert launch_spans.busy_us(r, "detect.net", REC) == (150.0, 4)
    assert launch_spans.busy_us(r, "detect.tail", REC) == (50.0, 4)
    assert launch_spans.busy_us(r, "track", REC) == (100.0, 4)
    assert launch_spans.busy_us(r, "detect.pixels", REC) == (0.0, 4)
    assert launch_spans.busy_ms_per_frame(r, "detect.net", REC) == pytest.approx(0.0375)


def test_the_readers(monkeypatch):
    from cellbench import spans

    monkeypatch.setattr(spans, "recorder", lambda: REC)
    r = _record(Window.read(_events()))
    assert detect_net_busy_ms_per_frame.read(r) == pytest.approx(0.0375)
    assert detect_tail_busy_ms_per_frame.read(r) == pytest.approx(0.0125)
    cfg = launch_spans.cell_config(["run.py", "--workload", "s6-1280-dense"])
    monkeypatch.setattr(launch_spans, "cell_config", lambda: cfg)
    want = 100.0 * detector_counts.net_bound_s(cfg, r.peaks) * 1e3 / 0.0375
    assert detect_net_roofline.read(r) == pytest.approx(want)


def test_nothing_to_read_gives_none(monkeypatch):
    from cellbench import spans

    w = Window.read(_events())
    r = _record(w)
    assert launch_spans.busy_us(r, "detect.net", FakeRecorder(("detect", 40, 200))) is None  # no such span
    monkeypatch.setattr(spans, "recorder", lambda: None)  # a program without the recorder
    assert detect_net_busy_ms_per_frame.read(r) is None and detect_net_roofline.read(r) is None
    assert launch_spans.busy_us(_record(None), "detect.net", REC) is None  # a CPU run
    del w.launched  # a window read before the wrap
    assert launch_spans.busy_us(r, "detect.net", REC) is None


def test_the_cell_on_the_command_line():
    assert launch_spans.cell_config(["run.py", "--workload", "s6-1280-dense", "--seed", "1"])["name"] == "yolov5s6-1280"
    assert launch_spans.cell_config(["run.py", "--workload=s640-dense"])["name"] == "yolov5s-640"
    assert launch_spans.cell_config(["pytest", "-q"]) is None
    assert launch_spans.cell_config(["run.py", "--workload", "nowhere"]) is None


def test_one_convolution_by_hand():
    """yolov5s's stem at 384x640: 6x6, stride 2, pad 2, 3 -> 32 channels,
    out 192x320. FLOPs 2 x 192 x 320 x 32 x 3 x 36; input 3 x 384 x 640,
    weights 32 x 3 x 36, output 32 x 192 x 320 elements; at B=128 in bf16
    its bound is the bytes: (128 x (737,280 + 1,966,080) + 3,456) x 2 at
    3.35 TB/s, against 128 x 424.7 MFLOP at 989 TFLOP/s."""
    cfg = run._load_json(f"{run.ROOT}/cellbench/configs/yolov5s-640.json", "configuration")
    convs = detector_counts.detector_convs(cfg, cfg["net_hw"])
    assert convs[0] == (2.0 * 192 * 320 * 32 * 3 * 36, 3 * 384 * 640, 32 * 3 * 36, 32 * 192 * 320)
    assert sum(c[0] for c in convs) == counts.detector_flops(cfg, cfg["net_hw"])
    assert len(convs) == 60
    stem = dict(cfg, backbone=cfg["backbone"][:1], head=[[[0, 0, 0], 1, "Detect", ["nc", "anchors"]]])
    peaks = counts.PEAKS["NVIDIA H100"]
    head = 2.0 * 192 * 320 * 255 * 32  # one 1x1 head conv per Detect input, each on the 32-channel stem output
    nbytes = 2 * (128 * (737_280 + 1_966_080) + 3_456) / peaks["hbm_bytes_per_s"]
    head_s = max(128 * head / peaks["bf16_flops"], 2 * (128 * (32 * 192 * 320 + 255 * 192 * 320) + 255 * 32)
                 / peaks["hbm_bytes_per_s"])
    assert nbytes > 128 * convs[0][0] / peaks["bf16_flops"]
    assert detector_counts.net_bound_s(stem, peaks) == pytest.approx((nbytes + 3 * head_s) / 128)
