"""The port's span recorder (`utils/profiling.py`): nesting, parents and
batch records per thread, the ring's bound, `StageTimer` on top of it, the
shared clock with a `torch.profiler` trace, and the spans of one counting
step on the CPU counted against what the step does."""

import json
import math
import re
import sys
import threading

import numpy as np
import pytest
import torch

from vehicle_counting_tpu_torch.models.detector import fused_detect_tail
from vehicle_counting_tpu_torch.models.reid import init_reid
from vehicle_counting_tpu_torch.models.yolo import YoloConfig, decode_predictions, init_yolov5, yolov5_forward_nchw
from vehicle_counting_tpu_torch.ops import nms as nms_mod
from vehicle_counting_tpu_torch.ops.letterbox import (
    autoshape_hw,
    content_upload_exact,
    host_letterbox_yuv420,
    yuv420_content_to_full,
    yuv420_to_rgb_u8_planar,
)
from vehicle_counting_tpu_torch.pipeline import step as step_mod
from vehicle_counting_tpu_torch.testing import one_torch_thread
from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, init_states
from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams
from vehicle_counting_tpu_torch.utils import profiling
from vehicle_counting_tpu_torch.utils.profiling import RECORDER, Recorder, StageTimer

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def test_spans_nest_with_parents_and_the_batch_id():
    rec = Recorder()
    with rec.span("outer") as outer:
        with rec.step_span(4) as step:
            with rec.span("detect") as detect:
                with rec.span("sync.nms") as sync:
                    pass
            with rec.step_span(4) as inner_step:  # a step inside a step: a plain span of the outer record
                pass
    (record,) = rec.batches()
    assert record.frames == 4 and record.profiled is False
    assert record.spans == [step, detect, sync, inner_step]
    assert {s.batch for s in record.spans} == {record.id} and outer.batch is None
    assert step.parent is outer and detect.parent is step and sync.parent is detect and inner_step.parent is step
    assert outer.parent is None
    assert {s.thread for s in (outer, step, detect, sync)} == {threading.get_ident()} == {record.thread}
    for s in (outer, step, detect, sync, inner_step):
        assert s.start_ns <= s.end_ns
    assert outer.start_ns <= step.start_ns <= detect.start_ns <= sync.start_ns <= sync.end_ns <= detect.end_ns
    # a span opened after the step closed belongs to no batch
    with rec.span("readback") as after:
        pass
    assert after.batch is None and len(rec.batches()) == 1


def test_another_threads_spans_stay_out_of_the_steps_record():
    rec = Recorder()
    inside, started, release = {}, threading.Event(), threading.Event()

    def producer():
        with rec.span("feed.letterbox") as s:
            started.set()
            release.wait(10)
        inside["span"] = s

    with rec.step_span(2) as step:
        t = threading.Thread(target=producer)
        t.start()
        assert started.wait(10)
        with rec.span("detect"):
            pass
        release.set()
        t.join(10)
    assert not t.is_alive()
    feed = inside["span"]
    (record,) = rec.batches()
    assert [s.name for s in record.spans] == ["step", "detect"]
    assert feed.batch is None and feed.parent is None and feed.thread != step.thread
    assert rec.totals()["feed.letterbox"][1] == 1
    # an ended thread's state is dropped when another thread starts
    # recording, and its totals stay
    t2 = threading.Thread(target=lambda: rec.span("feed.upload").__enter__().__exit__())
    t2.start()
    t2.join(10)
    assert not t2.is_alive() and len(rec._threads) == 2  # t2 (ended, not yet dropped) and this thread
    assert rec.totals()["feed.letterbox"][1] == 1 and rec.totals()["feed.upload"][1] == 1


def test_self_time_is_the_duration_less_the_childrens():
    rec = Recorder()
    with rec.span("a") as a:
        with rec.span("b") as b:
            with rec.span("c") as c:
                pass
        with rec.span("b") as b2:
            pass
    da, db, db2, dc = (x.end_ns - x.start_ns for x in (a, b, b2, c))
    tot = rec.totals()
    assert tot["a"] == (da, 1, da - db - db2)
    assert tot["b"] == (db + db2, 2, db - dc + db2)
    assert tot["c"] == (dc, 1, dc)
    lines = rec.summary().splitlines()
    assert [ln.split(":")[0] for ln in lines] == sorted(("a", "b", "c"), key=lambda n: -tot[n][0])
    assert all(re.fullmatch(r"[a-c]: \d+\.\d{3}s total, \d+\.\d{2}ms avg x\d+, -?\d+\.\d{3}s self", ln)
               for ln in lines)
    # a snapshot leaves out what was recorded before it
    since = rec.totals()
    with rec.span("c"):
        pass
    assert [ln.split(":")[0] for ln in rec.summary(since).splitlines()] == ["c"]


def test_a_span_closes_when_its_body_raises():
    rec = Recorder()
    with pytest.raises(ValueError):
        with rec.step_span(1):
            with rec.span("detect"):
                raise ValueError("boom")
    with rec.span("after") as after:
        pass
    assert after.parent is None and after.batch is None
    assert [s.name for s in rec.batches()[0].spans] == ["step", "detect"]
    assert all(s.end_ns is not None for s in rec.batches()[0].spans)


def test_the_ring_keeps_the_last_1024_batches():
    rec = Recorder()
    for i in range(1030):
        with rec.step_span(i):
            with rec.span("detect"):
                pass
    kept = rec.batches()
    assert len(kept) == 1024
    assert [b.id for b in kept] == list(range(6, 1030)) and [b.frames for b in kept] == list(range(6, 1030))
    assert rec.totals()["step"][1] == 1030 and rec.totals()["detect"][1] == 1030


def test_threads_record_apart_under_contention():
    """More threads than cores, the interpreter switching threads as often as
    it can: every record holds only its own thread's spans, and no count is
    lost."""
    rec = Recorder(capacity=4096)
    n_threads, steps, errors = 16, 40, []

    def work(k):
        try:
            for _ in range(steps):
                with rec.step_span(k):
                    for _ in range(3):
                        with rec.span("embed.chunk"):
                            pass
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    records = rec.batches()
    assert len(records) == n_threads * steps
    for b in records:
        assert [s.name for s in b.spans] == ["step"] + ["embed.chunk"] * 3
        assert {s.thread for s in b.spans} == {b.thread} and {s.batch for s in b.spans} == {b.id}
    assert rec.totals()["embed.chunk"][1] == 3 * n_threads * steps
    assert len({b.id for b in records}) == len(records)


def test_stage_timer_keeps_its_api_and_records_spans():
    timer = StageTimer()
    with timer.stage("decode"):
        pass
    with timer.stage("dispatch"):
        with profiling.step_span(2):
            with profiling.span("detect"):
                pass
    with timer.stage("decode"):
        pass
    assert set(timer.totals) == {"decode", "dispatch"} and timer.counts == {"decode": 2, "dispatch": 1}
    assert all(v >= 0.0 for v in timer.totals.values())
    lines = timer.summary().splitlines()
    assert len(lines) == 2
    assert all(re.fullmatch(r"(decode|dispatch): \d+\.\d{3}s total, \d+\.\d{2}ms avg x[12]", ln) for ln in lines)
    step = RECORDER.batches()[-1]
    assert step.spans[0].parent.name == "dispatch"
    listed = {ln.split(":")[0] for ln in timer.spans().splitlines()}
    assert listed == {"decode", "dispatch", "step", "detect"}


def test_span_stamps_lie_on_the_profilers_clock(tmp_path):
    """Under a CPU torch.profiler a span is also a `vct.<name>` range, which
    it encloses, and its start put on the exported trace's timeline lies
    within 100 us of that range's start, with the file's base or the
    recomputed one: never more than 100 us after it (clock error), and in
    the median less than 100 us before it (a thread preempted between the
    two stamps may lie further before it). The profiler's first range takes
    ~1 ms to open, so a span opens before the measured ones."""
    x = torch.ones(64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("warm"):
            pass
        spans = []
        for i in range(9):
            with profiling.span(f"clock{i}") as s:
                x = x + 1.0
            spans.append(s)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    base = int(data["baseTimeNanoseconds"])
    ranges = {e["name"]: e for e in data["traceEvents"] if str(e.get("name", "")).startswith("vct.clock")}
    assert set(ranges) == {f"vct.clock{i}" for i in range(9)}
    for base_ns in (base, None):
        leads = []
        for s in spans:
            ev = ranges["vct." + s.name]
            start, end = profiling.trace_us(s.start_ns, base_ns), profiling.trace_us(s.end_ns, base_ns)
            assert start < float(ev["ts"]) + 100.0 and end > float(ev["ts"]) + float(ev["dur"]) - 100.0
            leads.append(float(ev["ts"]) - start)
        assert abs(float(np.median(leads))) < 100.0


K, C, B = 16, 4, 4


def _passes(overlap, valid, threshold):
    """Greedy NMS's fixpoint passes, counted on NumPy copies."""
    ov, keep0 = overlap.numpy(), valid.numpy()
    k = ov.shape[-1]
    pred = (np.arange(k)[:, None] < np.arange(k)[None, :]) & (ov > float(threshold))
    keep, n = keep0, 0
    while True:
        n += 1
        new = keep0 & ~np.any(pred & keep[..., :, None], axis=-2)
        if np.array_equal(new, keep):
            return n
        keep = new


def test_one_cpu_step_has_the_spans_of_its_work(monkeypatch):
    """yolov5n, B=4, 72x128 -> 96x128, f32, the threshold at the 20th score
    of a frame so NMS suppresses and the embed takes several chunks of 8:
    `sync.nms` as many as greedy NMS's passes counted apart, one
    `sync.embed_count`, ceil(valid / max_embed) `embed.chunk`, one record."""
    src_hw = (72, 128)
    net = autoshape_hw(src_hw, 128)
    g = torch.Generator().manual_seed(3)
    ycfg = YoloConfig("yolov5n", 80)
    yp = init_yolov5(g, ycfg)
    rp, rs = init_reid(g)
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, src_hw + (3,)).astype(np.int16)
    frames = np.clip(base + rng.integers(-3, 4, (B,) + src_hw + (3,)), 0, 255).astype(np.uint8)
    yuv = host_letterbox_yuv420(frames, net, content_only=content_upload_exact(src_hw, net))
    y = torch.from_numpy(yuv)
    if y.shape[1] != net[0] * 3 // 2:
        y = yuv420_content_to_full(y, src_hw, net)
    with torch.no_grad():
        heads = [h.permute(0, 2, 3, 1) for h in yolov5_forward_nchw(yp, yuv420_to_rgb_u8_planar(y).float() / 255.0)]
        scores = decode_predictions(heads, ycfg)["scores"]
    conf = float(torch.sort(scores[0].flatten(), descending=True).values[20])
    hp = DeepSortParams(tracker=TrackerParams(capacity=K), num_classes=C, max_embed=8, min_confidence=0.0)
    lut = torch.from_numpy(np.arange(80) % C).to(torch.int32)

    calls = []
    real = nms_mod.greedy_suppress

    def counted(overlap, valid, threshold):
        calls.append(_passes(overlap, valid, threshold))
        return real(overlap, valid, threshold)

    monkeypatch.setattr(nms_mod, "greedy_suppress", counted)
    before = len(RECORDER.batches())
    candidates = fused_detect_tail.candidates
    with torch.no_grad():
        _, det, _ = step_mod.pipeline_batch_step(
            yp, rp, rs, init_states(hp), torch.from_numpy(yuv), torch.ones(B, dtype=torch.bool), lut,
            ycfg=ycfg, hp=hp, image_size=net, src_hw=src_hw, conf_thres=conf, iou_thres=0.45, max_det=100,
            dtype=torch.float32, frames_format="letterboxed_yuv420")
    records = RECORDER.batches()
    assert len(records) == before + 1
    record = records[-1]
    names = [s.name for s in record.spans]
    valid = int(det["valid"].sum())
    assert valid > 2 * hp.max_embed and sum(calls) > len(calls) >= 2  # some pass suppressed
    assert names.count("sync.nms") == sum(calls)
    assert names.count("sync.embed_count") == 1
    assert names.count("embed.chunk") == math.ceil(valid / hp.max_embed)
    for name in ("step", "detect", "detect.pixels", "detect.net", "detect.tail", "embed", "track", "track.inputs",
                 "track.scan"):
        assert names.count(name) == 1, name
    assert record.frames == B and names[0] == "step"
    by_name = {s.name: s for s in record.spans}
    assert by_name["detect"].parent is by_name["step"] and by_name["detect.net"].parent is by_name["detect"]
    assert by_name["detect.pixels"].parent is by_name["detect"]
    assert by_name["detect.pixels"].end_ns <= by_name["detect.net"].start_ns  # the network alone
    # every anchor of the three heads at 96x128 (strides 8, 16, 32) enters the tail's top-k
    assert fused_detect_tail.candidates - candidates == B * ycfg.na * (12 * 16 + 6 * 8 + 3 * 4)
    assert by_name["sync.embed_count"].parent is by_name["embed"]
    assert by_name["track.inputs"].parent is by_name["track"] and by_name["track.scan"].parent is by_name["track"]
    replays = [s for s in record.spans if s.name == "track.replay"]  # one per frame, inside the scan
    assert len(replays) == B and all(s.parent is by_name["track.scan"] for s in replays)
