"""The measurement entry points of the port on the CPU: the launch-cost
probe kernel (K7) against the TPU kernel's body, the upload helper, bench
and stage_bench at a tiny size, the trace hook with its summary tool, and
the CLI's --profile / --check_numerics."""

import io
import json
import os
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from test_torch_pipeline import _synthetic_video, fake_pipeline_batch_step
from vehicle_counting_tpu_torch import bench, stage_bench
from vehicle_counting_tpu_torch.benchmarks import load
from vehicle_counting_tpu_torch.benchmarks.micro import conv_s2_alone, noop_launch
from vehicle_counting_tpu_torch.configs import Config, config_from_dict, default_cam_config, default_config
from vehicle_counting_tpu_torch.ops import noop
from vehicle_counting_tpu_torch.pipeline import CountingPipeline
from vehicle_counting_tpu_torch.pipeline import step as step_mod
from vehicle_counting_tpu_torch.tools import profile_summary
from vehicle_counting_tpu_torch.utils import device as device_mod
from vehicle_counting_tpu_torch.utils import transfer
from vehicle_counting_tpu_torch.utils.profiling import trace
from vehicle_counting_tpu_torch.testing import one_torch_thread

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

# the synthetic boxes of stage_bench want a source larger than 200 px each way
SMALL = dict(src_hw=(216, 384), size=384, variant="yolov5n")


# ---- K7 -------------------------------------------------------------------

def _tpu_noop(x):
    """The TPU kernel's body (benchmarks/micro/noop_launch.py:11), rebuilt
    here as a pallas_call in interpret mode: the script itself runs its
    timing loop at import and has no interpret switch."""
    def noop_kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] + 1.0

    return pl.pallas_call(noop_kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype), interpret=True)(x)


def test_noop_plain_equals_tpu_kernel_body():
    x = np.random.default_rng(0).standard_normal((64, 128)).astype(np.float32)
    want = np.asarray(_tpu_noop(jnp.asarray(x)))
    np.testing.assert_array_equal(noop.noop_add1_plain(torch.from_numpy(x)).numpy(), want)
    before = noop.noop_add1.launches
    np.testing.assert_array_equal(noop.noop_add1(torch.from_numpy(x)).numpy(), want)  # CPU tensor -> plain version
    assert noop.noop_add1.launches == before  # no kernel launched, none counted


def test_noop_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        noop.noop_add1(torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        noop.bare_launcher(torch.zeros(4))


@pytest.mark.cuda
def test_noop_kernel_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((64, 128)).astype(np.float32)).cuda()
    before = noop.noop_add1.launches
    assert torch.equal(noop.noop_add1(x), noop.noop_add1_plain(x))
    assert noop.noop_add1.launches == before + 1
    with pytest.raises(ValueError):
        noop.noop_add1(x.double())


def test_launch_probe_runs_on_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = noop_launch.main("cpu")
    assert res["cuda_noop_eager_us"] > 0 and res["torch_equiv_eager_us"] > 0
    assert res["cuda_noop_graph_us"] is None and res["bare_launch_us"] is None and res["wrapper_launches"] == 0
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("cuda noop:") and lines[1].startswith("torch equiv:")
    assert json.loads(lines[-1])["noop_launch"]["iters"] == 256


def test_conv_s2_alone_runs_on_cpu_and_refuses_cuda_without_a_card():
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = conv_s2_alone.main("cpu")
    assert res["finite"] and res["kernel_ms"] is None and res["shape"] == [1, 32, 64, 32]
    assert json.loads(buf.getvalue().splitlines()[-1])["conv_s2_alone"]["device"] == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            conv_s2_alone.main("cuda")


# ---- devices ----------------------------------------------------------------

def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mod.require_device("cuda")
    for main in (bench.main, stage_bench.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        noop_launch.main("cuda")
    assert device_mod.require_device("cpu").type == "cpu"


def test_devices_info():
    info = device_mod.get_devices_info()
    assert info.startswith("Backend: ")
    assert isinstance(device_mod.card_line(), str) and device_mod.card_line()


# ---- upload -----------------------------------------------------------------

@pytest.mark.parametrize("streams", [1, 4, None])
@pytest.mark.parametrize("shape,dtype", [((8, 700, 400), np.uint8),   # > 2 MiB: split along axis 0
                                         ((3, 1000, 1000), np.uint8),  # fewer rows than 4 streams: one chunk
                                         ((16,), np.bool_),            # small: one chunk
                                         ((), np.float32)])
def test_parallel_device_put_cpu_equals_input(streams, shape, dtype):
    rng = np.random.default_rng(2)
    x = (rng.integers(0, 255, shape) if shape else np.asarray(3.5)).astype(dtype)
    got = transfer.parallel_device_put(x, streams, device="cpu")
    assert got.device.type == "cpu" and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), x)


def test_upload_streams_default_env(monkeypatch):
    monkeypatch.delenv("VCT_UPLOAD_STREAMS", raising=False)
    assert transfer.upload_streams_default() == 4
    monkeypatch.setenv("VCT_UPLOAD_STREAMS", "2")
    assert transfer.upload_streams_default() == 2


def test_staging_buffers_alternate():
    """Two pinned buffers per shape in turns 0, 1, 0, 1: an upload never
    re-takes the buffer the previous upload is still being copied from."""
    x = np.zeros((4, 3), np.uint8)
    key = ("staging-test", x.shape, x.dtype.str)
    transfer._STAGING.pop(key, None)
    bufs = [transfer._staging("staging-test", x, pin=False)[0] for _ in range(5)]
    assert bufs[0] is not bufs[1]
    assert bufs[2] is bufs[0] and bufs[3] is bufs[1] and bufs[4] is bufs[0]
    assert len(transfer._STAGING.pop(key)["bufs"]) == 2


# ---- the load: held against the reference benches' recipes -----------------------

def _reference_calibration(det, k):
    """Root bench.py:135-146 on numpy arrays, restated (the script runs its
    measurement at import level of main() and cannot be called in parts)."""
    import collections

    scores, classes, ok = det["scores"][0], det["classes"][0], det["valid"][0]
    top4 = [c for c, _ in collections.Counter(classes[ok].tolist()).most_common(4)]
    lut = np.full((80,), -1, np.int32)
    for d, src in enumerate(top4):
        lut[src] = d
    pool_scores = np.sort(scores[ok & np.isin(classes, top4)])
    return float(pool_scores[-min(k, pool_scores.size)]), lut, top4


@pytest.mark.parametrize("k,n_valid", [(30, 300), (5, 300), (30, 12)])
def test_calibration_equals_reference_recipe(k, n_valid):
    rng = np.random.default_rng(11)
    det = {"scores": rng.random((2, 300)).astype(np.float32),
           "classes": rng.choice(80, size=(2, 300), p=np.r_[[0.3, 0.2, 0.15, 0.1, 0.05], np.full(75, 0.2 / 75)]).astype(np.int32),
           "valid": np.arange(300)[None].repeat(2, 0) < n_valid}
    want_conf, want_lut, want_top4 = _reference_calibration(det, k)
    conf, lut, top4 = load.calibrate_from_det({n: torch.from_numpy(v) for n, v in det.items()}, k)
    assert conf == want_conf and top4 == want_top4
    np.testing.assert_array_equal(lut, want_lut)
    assert lut.dtype == want_lut.dtype
    kept = det["valid"][0] & (lut[det["classes"][0]] >= 0) & (det["scores"][0] >= conf)
    assert kept.sum() == min(k, (det["valid"][0] & (lut[det["classes"][0]] >= 0)).sum())


def _reference_stage_detections(B, H, W, n_det, k, num_classes, dominant_frac):
    """Root stage_bench.py:134-160 on numpy arrays, restated (they are
    locals of its main())."""
    def boxes_for(seed):
        r = np.random.default_rng(seed)
        cx = r.uniform(100, W - 100, size=(B, n_det))
        cy = r.uniform(100, H - 100, size=(B, n_det))
        bw = r.uniform(40, 160, size=(B, n_det))
        bh = r.uniform(40, 160, size=(B, n_det))
        return np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)

    det_valid = np.zeros((B, n_det), bool)
    det_valid[:, :k] = True
    classes_h = np.asarray(np.random.default_rng(1).integers(0, num_classes, size=(B, n_det)), np.int32)
    if dominant_frac > 0:
        dom = np.random.default_rng(9).random(size=(B, n_det)) < dominant_frac
        classes_h = np.where(dom, 0, classes_h).astype(np.int32)
    scores_h = np.asarray(np.random.default_rng(2).uniform(0.3, 0.9, size=(B, n_det)), np.float32)
    return boxes_for, det_valid, classes_h, scores_h


@pytest.mark.parametrize("dominant_frac", [0.0, 0.6])
def test_stage_bench_detections_equal_reference_recipe(dominant_frac):
    B, H, W, n_det, k = 3, 720, 1280, 300, 30
    boxes_for, want_valid, want_cls, want_sco = _reference_stage_detections(B, H, W, n_det, k, 4, dominant_frac)
    valid, cls, sco = load.synthetic_detections(B, n_det, k, 4, dominant_frac)
    for got, want in ((valid, want_valid), (cls, want_cls), (sco, want_sco)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for seed in (3, 5, 7):  # churn, the tracker stages' second set, steady
        np.testing.assert_array_equal(load.synthetic_boxes(seed, B, n_det, (H, W)), boxes_for(seed))
    # the crop gather's inputs (root stage_bench.py:256-261): frame-major
    # indices, boxes scaled into the network input, all valid
    gain, pad_x, pad_y = 0.5, 0.0, 12.0
    churn = torch.from_numpy(boxes_for(3).astype(np.float32))
    fidx, bsel, vsel = load.crop_gather_inputs(churn, k, gain, pad_x, pad_y)
    np.testing.assert_array_equal(fidx.numpy(), np.repeat(np.arange(B), k).astype(np.int32))
    want_b = boxes_for(3).astype(np.float32)[:, :k].reshape(B * k, 4) * np.float32(gain) + np.asarray(
        [pad_x, pad_y, pad_x, pad_y], np.float32)
    np.testing.assert_array_equal(bsel.numpy(), want_b)
    assert vsel.dtype == torch.bool and bool(vsel.all()) and vsel.shape == (B * k,)


# ---- bench / stage_bench ------------------------------------------------------

def test_bench_tiny_cpu(monkeypatch):
    for k, v in {"BENCH_BATCH": "2", "BENCH_BATCHES": "2", "BENCH_STREAM_SWEEP": "1,4", "BENCH_WINDOWS": "2",
                 "BENCH_BUDGET_S": "0"}.items():
        monkeypatch.setenv(k, v)
    buf = io.StringIO()
    with redirect_stdout(buf):
        telemetry, line = bench.main(["--device", "cpu"], sizes=("yolov5n", 128, (72, 128), 2))
    lines = buf.getvalue().splitlines()
    assert json.loads(lines[-1]) == line and json.loads(lines[-2]) == {"telemetry": telemetry}
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "e2e_detect_track_fps_per_chip_yolov5s640" and line["value"] > 0
    assert line["unit"] == "frames/sec" and line["vs_baseline"] is None
    assert telemetry["windows"] >= 3 and telemetry["batch"] == 2 and telemetry["card"] == "cpu"
    assert telemetry["device_resident_fps"] > 0 and telemetry["upload_gbps_best"] is None
    assert telemetry["upload_gbps_p50_by_streams"] == {}  # uploads are timed by CUDA events: none on the CPU
    assert telemetry["bytes_per_frame"] == 72 * 128 * 3 // 2
    assert set(telemetry["stream_best_fps"]) == {"1", "4"}


def test_bench_unknown_mode(monkeypatch):
    monkeypatch.setenv("BENCH_MODE", "yolov5x_9000")
    with pytest.raises(SystemExit, match="unknown BENCH_MODE"):
        bench.main(["--device", "cpu"])


def test_stage_bench_tiny_cpu_prints_every_stage():
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = stage_bench.main(["--device", "cpu", "--batch", "2", "--reps", "2", "--chain", "1", "--stages", "all",
                                "--dets", "5"], **SMALL)
    assert list(res) == list(stage_bench.STAGES)
    out = buf.getvalue()
    for name, (best, med) in res.items():
        assert 0 < best <= med
        assert any(ln.split()[:1] == [name] and "min" in ln and "median" in ln for ln in out.splitlines()), name
    assert "backend=cpu batch=2" in out


def test_stage_bench_flags():
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = stage_bench.main(["--device", "cpu", "--class_mode", "scan", "--batch", "1", "--reps", "1", "--chain", "1",
                                "--stages", "tracker_steady", "--dets", "3"], **SMALL)
    assert list(res) == ["tracker_steady"] and 0 < res["tracker_steady"][0]
    with pytest.raises(SystemExit, match="unknown stage"):
        stage_bench.main(["--device", "cpu", "--batch", "1", "--stages", "nope"], **SMALL)
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = stage_bench.main(["--device", "cpu", "--batch", "1", "--reps", "1", "--chain", "1", "--stages", "tracker",
                                "--dets", "3"], **SMALL)
    assert list(res) == ["tracker_churn", "tracker_steady"]


# ---- trace + summary ----------------------------------------------------------

def test_trace_writes_chrome_trace_and_summary_reads_it(tmp_path, capsys):
    with trace(str(tmp_path / "tr")) as t:
        a = torch.randn(64, 64)
        (a @ a).relu().sum()
    assert t["path"] and os.path.getsize(t["path"]) > 0
    with open(t["path"]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" and "mm" in e.get("name", "") for e in events)
    assert profile_summary.find_trace(str(tmp_path / "tr")) == t["path"]
    assert profile_summary.load_device_events(t["path"]) == [] or torch.cuda.is_available()
    assert profile_summary.main([str(tmp_path / "tr")]) == 0
    assert "no device events" in capsys.readouterr().out or torch.cuda.is_available()


def _hand_made_trace(path):
    """Two streams: busy [0,10) [5,20) [50,60) [100,130), so the union is
    60 us of a 130 us window, with idle gaps of 40 us at 60 and 30 us at 20."""
    ev = [
        {"ph": "X", "cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel<4, ...>", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_fprop_implicit_gemm_bf16", "ts": 5, "dur": 15},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": 50, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "(anonymous namespace)::cascade_kernel(float const*, ...)", "ts": 100, "dur": 30},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 500},
        {"ph": "M", "name": "process_name"},
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def test_conv_roofline_on_a_hand_made_trace(tmp_path, capsys):
    """One bf16 convolution x [2, 8, 16, 16] * w [4, 8, 3, 3], stride 2,
    padding 1: out 8 x 8, 2 * 2 * 4 * 64 * 8 * 9 FLOPs. Its two launches
    (in its span, on its thread) ran kernels of 20 and 5 us; a launch after
    it and one on another thread are not its."""
    args = {"Input Dims": [[2, 8, 16, 16], [4, 8, 3, 3], [], [], [], [], [], [], []],
            "Input type": ["c10::BFloat16", "c10::BFloat16", "", "ScalarList", "ScalarList", "ScalarList", "Scalar",
                           "ScalarList", "Scalar"],
            "Concrete Inputs": ["", "", "", "[2, 2]", "[1, 1]", "[1, 1]", "False", "[0, 0]", "1"]}
    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::convolution", "pid": 1, "tid": 1, "ts": 100, "dur": 50, "args": args}]
    for corr, ts, tid, dur in ((7, 110, 1, 20), (8, 140, 1, 5), (9, 160, 1, 100), (10, 120, 2, 100)):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": tid, "ts": ts,
                   "dur": 2, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "pid": 0, "tid": 7, "ts": ts + 50, "dur": dur,
                   "args": {"correlation": corr}})
    path = str(tmp_path / "t.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)
    (cc,) = profile_summary.conv_calls(profile_summary.read_events(path))
    assert cc == ("x=[2, 8, 16, 16] w=[4, 8, 3, 3] s=2 p=1 g=1", "c10::BFloat16", 2 * 2 * 4 * 64 * 8 * 9, 25.0)
    assert profile_summary.main([path, "--convs"]) == 0
    out = capsys.readouterr().out
    tflops = cc.flops / 25e-6 / 1e12
    assert f"{tflops:7.1f} TF/s ({100 * tflops / 989:5.1f} %)" in out and "ALL convs: 25.0 us over 1 calls" in out


def test_trace_records_conv_shapes(tmp_path, capsys):
    """`trace` records the host ops' shapes: a CPU convolution (stride 2,
    groups 2) gets its FLOPs from them, and no device time."""
    x, w = torch.randn(1, 4, 9, 9), torch.randn(6, 2, 3, 3)
    with trace(str(tmp_path / "tr")) as t:
        y = torch.nn.functional.conv2d(x, w, stride=2, padding=1, groups=2)
    calls = profile_summary.conv_calls(profile_summary.read_events(t["path"]))
    assert [c.shape for c in calls] == ["x=[1, 4, 9, 9] w=[6, 2, 3, 3] s=2 p=1 g=2"]
    assert calls[0].flops == 2 * y.numel() * 2 * 3 * 3 and calls[0].dtype == "float"
    assert calls[0].device_us == 0
    profile_summary.print_conv_roofline(calls, 1, "us")
    assert "no device kernels under them (a CPU trace)" in capsys.readouterr().out


def test_own_kernels_are_read_from_the_sources():
    names = profile_summary.own_kernel_names()
    assert {"crop_gather_kernel", "cascade_kernel", "insert_rows_kernel", "reid_block_bf16", "reid_block_f32",
            "conv1_s2_bf16", "conv1_s2_f32", "noop_add1_kernel"} <= set(names)
    csrc = os.path.join(os.path.dirname(profile_summary.__file__), "..", "csrc")
    n_global = sum(open(os.path.join(csrc, f)).read().count("__global__") for f in os.listdir(csrc) if f.endswith(".cu"))
    assert len(names) == n_global  # every __global__ function is recognised
    for traced in ("(anonymous namespace)::tc::conv1_s2_bf16(__nv_bfloat16 const*, ...)", "reid_block_bf16(__nv_bfloat16 const*, ...)",
                   "(anonymous namespace)::crop_gather_kernel(unsigned char const*, ...)"):
        assert profile_summary.category(profile_summary.DeviceEvent(traced, "kernel", 0, 1)) == "vct kernels (csrc/)"
    assert profile_summary.category(profile_summary.DeviceEvent("my_cascade_kernel_v2", "kernel", 0, 1)) != "vct kernels (csrc/)"


def test_profile_summary_on_known_gaps(tmp_path, capsys):
    path = str(tmp_path / "t.json")
    _hand_made_trace(path)
    s = profile_summary.summarize(profile_summary.load_device_events(path), frames=2, top=2, gaps=5)
    assert s["device_events"] == 4 and s["device_kernels"] == 3 and s["kernels_per_frame"] == 1.5
    assert s["self_us"] == 65 and s["busy_us"] == 60 and s["window_us"] == 130
    assert s["busy_share"] == pytest.approx(60 / 130)
    assert s["idle_gaps"] == [(40.0, 60.0), (30.0, 20.0)]
    assert s["by_category"] == {"vct kernels (csrc/)": 30.0, "convolution/GEMM": 15.0,
                                "elementwise/index/other": 10.0, "memcpy/memset": 10.0}
    assert [n for n, _, _ in s["top"]] == ["(anonymous namespace)::cascade_kernel(float const*, ...)",
                                           "sm90_xmma_fprop_implicit_gemm_bf16"]
    assert profile_summary.main([path, "-n", "3", "--frames", "2"]) == 0
    out = capsys.readouterr().out
    assert "device kernels per frame: 1.5" in out and "idle 53.8 %" in out
    with pytest.raises(SystemExit, match="no .json trace"):
        profile_summary.find_trace(str(tmp_path / "empty_dir_that_is_missing"))


# ---- the CLI's --profile and --check_numerics ----------------------------------

def _pipeline(tmp_path, **flags):
    video_path, zone_dir = _synthetic_video(tmp_path)
    cfg = config_from_dict(default_config(), {
        "detect_batch": 8, "max_tracks_per_class": 16, "image_size": [160, 160],
        "model_name": "yolov5n", "compute_dtype": "float32",
    })
    cam = default_cam_config().to_dict()
    cam["zone_path"] = zone_dir
    args = types.SimpleNamespace(weight=None, input_path=video_path, output_path=str(tmp_path / "out"), device="cpu",
                                 mapping_dict={0: 0, 1: 0, 2: 1, 3: 0, 5: 2, 7: 3}, debug=False, **flags)
    return CountingPipeline(args, cfg, Config(_settings=cam)), video_path


def test_profile_flag_writes_a_trace(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(step_mod, "pipeline_batch_step", fake_pipeline_batch_step)
    pipe, video = _pipeline(tmp_path, profile=str(tmp_path / "trace"))
    result = pipe.run_video(video, visualize=False)
    assert result["frames"] == 40
    assert pipe.last_trace and os.path.dirname(pipe.last_trace) == str(tmp_path / "trace")
    assert os.path.getsize(pipe.last_trace) > 0
    assert f"[profile] torch.profiler trace written to {pipe.last_trace}" in capsys.readouterr().out
    assert profile_summary.find_trace(str(tmp_path / "trace")) == pipe.last_trace


@pytest.mark.parametrize("where", ["tracker_state", "detections"])
def test_check_numerics_raises_on_injected_nan(tmp_path, monkeypatch, where):
    def poisoned(*a, **kw):
        states, det, outs = fake_pipeline_batch_step(*a, **kw)
        if where == "detections":
            det["boxes"] = torch.where(det["valid"][..., None], torch.full_like(det["boxes"], float("nan")), det["boxes"])
        else:
            states = states._replace(mean=torch.full_like(states.mean, float("nan")))
        return states, det, outs

    monkeypatch.setattr(step_mod, "pipeline_batch_step", poisoned)
    pipe, video = _pipeline(tmp_path, check_numerics=True)
    with pytest.raises(FloatingPointError, match="non-finite"):
        pipe.run_video(video, visualize=False)
    # without the flag the same run goes through
    pipe.check_numerics = False
    assert pipe.run_video(video, visualize=False)["frames"] == 40


def test_check_numerics_passes_a_clean_run(tmp_path, monkeypatch):
    monkeypatch.setattr(step_mod, "pipeline_batch_step", fake_pipeline_batch_step)
    pipe, video = _pipeline(tmp_path, check_numerics=True)
    assert pipe.run_video(video, visualize=False)["frames"] == 40


def test_cli_flags_reach_the_pipeline():
    from vehicle_counting_tpu_torch import run

    args = run.parser.parse_args(["--input_path", "v.mp4", "--output_path", "o", "--profile", "--check_numerics",
                                  "--weight", "w.pt"])
    assert args.profile == "vct_trace" and args.check_numerics and args.weight == "w.pt"
    assert run.parser.parse_args(["--input_path", "v", "--output_path", "o", "--profile", "d"]).profile == "d"
    # every flag is ported: none is refused or documented as "not yet ported"
    assert not any("not yet ported" in (a.help or "") for a in run.parser._actions)


def test_chip_smoke_cli_ab_mode_refuses_outside_roots_and_no_card():
    """`chip_smoke.py --cli-ab` drives only a checkout inside this one, and
    like the smoke test itself it exits non-zero without a card."""
    import subprocess
    import sys

    script = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    out = subprocess.run([sys.executable, script, "--cli-ab", "--root", os.path.sep], capture_output=True, text=True)
    assert out.returncode == 2 and "--root must lie inside" in out.stderr
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, script, "--cli-ab", "--repeat", "1"], capture_output=True, text=True)
        assert out.returncode == 2 and "no CUDA device" in out.stderr and out.stdout == ""


def test_chip_smoke_multi_card_mode_needs_two_cards():
    """`chip_smoke.py --multi-card` measures only what exists across cards:
    with fewer than two it exits 2 and prints no result."""
    import subprocess
    import sys

    if torch.cuda.device_count() >= 2:
        pytest.skip("two or more cards: the mode would run")
    script = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    out = subprocess.run([sys.executable, script, "--multi-card"], capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "needs two or more" in out.stderr and out.stdout == ""
