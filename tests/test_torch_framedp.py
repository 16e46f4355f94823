"""PyTorch port, the frame-parallel step (`parallel/frames.py`) and its
pipeline and CLI branches, on CPU meshes (`make_mesh(n, ("frame",),
"cpu")`: n entries of the CPU device).

The cases of the JAX package's tests/test_framedp.py: against the port's
serial `pipeline_batch_step` at B/n with the states chained (n = 2, 4),
against JAX's `make_framedp_step` on the 8-device CPU mesh at n = 2 with
the weights carried by `models/convert.py`, and the pipeline's CSVs
against the serial run's. yolov5n, f32, 2 tracked classes, K = 8 slots,
B = 8 host-packed I420 frames (72x128 -> 96x128, content rows); the
second batch ends in 3 invalid frames. Tolerances are the JAX test's:
det floats atol 1e-4, track outputs and state floats atol 1e-3; integer
and boolean leaves equal. Against JAX the detection boxes are held to
1e-3 px, as test_torch_slice.py holds them (XLA and PyTorch sum the
convolutions in different orders).
"""

import os
import types

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_multicam_pipeline import _cams, _configs
from test_torch_slice import make_models
from vehicle_counting_tpu.parallel import make_framedp_step as j_make_framedp_step
from vehicle_counting_tpu.parallel import make_mesh as j_make_mesh
from vehicle_counting_tpu.tracking import DeepSortParams as JDP
from vehicle_counting_tpu.tracking import TrackerParams as JTP
from vehicle_counting_tpu.tracking import init_states as j_init
from vehicle_counting_tpu_torch import run as cli
from vehicle_counting_tpu_torch.models.yolo import YoloConfig, decode_predictions, yolov5_forward_nchw
from vehicle_counting_tpu_torch.ops.letterbox import host_letterbox_yuv420, yuv420_content_to_full, yuv420_to_rgb_u8_planar
from vehicle_counting_tpu_torch.parallel import make_framedp_step, make_mesh
from vehicle_counting_tpu_torch.pipeline import CountingPipeline
from vehicle_counting_tpu_torch.pipeline.step import pipeline_batch_step
from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, init_states
from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams, TrackerState

B, C, K = 8, 2, 8
SRC, NET = (72, 128), (96, 128)
MARGIN = 1e-4
DET_ATOL, TRACK_ATOL = 1e-4, 1e-3
JAX_BOX_ATOL = 1e-3
TRACKER = dict(capacity=K, budget=4, max_age=4, n_init=2)
EMBED = 16  # ReID crops per CNN call: ~4 valid detections per frame


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small ops, which would spin 8 threads
    against the other test workers' for nothing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """Weights, two near-static I420 batches, a threshold in a gap of every
    anchor score (none within MARGIN of it) and a LUT of the 2 dominant
    classes above it."""
    jcfg, jparams, tparams = make_models()
    batches = scene_batches(5, 2, B)
    conf, lut = gap_threshold(tparams[0], batches)
    valid = [np.ones(B, bool), np.arange(B) < B - 3]  # masked tail frames: the last batch of a video
    kw = dict(image_size=NET, src_hw=SRC, conf_thres=conf, iou_thres=0.45, max_det=32,
              frames_format="letterboxed_yuv420")
    return jcfg, jparams, tparams, batches, valid, lut, kw


def scene_batches(seed, n_batches, b):
    """n_batches of b host-packed I420 frames of one near-static scene
    (one base image plus small noise: detections persist, tracks confirm)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, SRC + (3,)).astype(np.int16)
    return [host_letterbox_yuv420(np.clip(base + rng.integers(-3, 4, (b,) + SRC + (3,)), 0, 255).astype(np.uint8),
                                  NET, content_only=True) for _ in range(n_batches)]


def gap_threshold(yolo_params, batches, per_frame=6):
    """(conf, lut): a threshold admitting ~per_frame anchors per frame, in a
    gap of every anchor score of the batches (none within MARGIN of it:
    XLA and PyTorch round the scores differently), and a LUT of the C
    dominant classes above it."""
    with torch.no_grad():
        yuv = torch.from_numpy(np.concatenate(batches))
        rgb = yuv420_to_rgb_u8_planar(yuv420_content_to_full(yuv, SRC, NET)).float() / 255.0
        dec = decode_predictions([h.permute(0, 2, 3, 1) for h in yolov5_forward_nchw(yolo_params, rgb)],
                                 YoloConfig("yolov5n", 80))
    s_all, c_all = dec["scores"].numpy().ravel(), dec["classes"].numpy().ravel()
    s = np.sort(np.unique(s_all))[::-1]
    n = per_frame * yuv.shape[0]
    gaps = s[n // 3 : 3 * n] - s[n // 3 + 1 : 3 * n + 1]
    i = n // 3 + int(np.argmax(gaps))
    conf = float((s[i] + s[i + 1]) / 2)
    assert np.abs(s_all - conf).min() > MARGIN
    lut = np.full(80, -1, np.int32)
    lut[np.bincount(c_all[s_all > conf], minlength=80).argsort()[::-1][:C]] = np.arange(C)
    return conf, lut


def _hp():
    return DeepSortParams(tracker=TrackerParams(**TRACKER), num_classes=C, min_confidence=0.0, max_embed=EMBED)


def _close(name, have, want, atol):
    have, want = np.asarray(have), np.asarray(want)
    assert have.shape == want.shape, name
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(have, want, rtol=0, atol=atol, err_msg=name)
    else:
        np.testing.assert_array_equal(have, want, err_msg=name)


def _port_framedp(world, n):
    """The port's frame-parallel step over the two batches on an n-entry
    CPU mesh: [(det, track outputs, state snapshot)] per batch (the
    gallery is updated in place)."""
    _, _, (tp, trp, trs), batches, valid, lut, kw = world
    hp = _hp()
    step = make_framedp_step(make_mesh(n, ("frame",), "cpu"), ycfg=YoloConfig("yolov5n", 80), hp=hp,
                             dtype=torch.float32, **kw)
    states, got = init_states(hp), []
    with torch.no_grad():
        for yuv, v in zip(batches, valid):
            states, det, touts = step(tp, trp, trs, torch.from_numpy(lut), states, torch.from_numpy(yuv),
                                      torch.from_numpy(v))
            got.append((det, touts, TrackerState(*(x.clone() for x in states))))
    return got


@pytest.mark.parametrize("n_dev", [2, 4])
def test_framedp_matches_chained_small_batches(world, n_dev):
    """framedp (n shards of B/n) == the serial step at batch B/n with the
    states chained, masked tail frames included: discrete outputs equal,
    floats within the JAX test's tolerances (on the CPU they are bitwise
    equal: the same code on the same shards)."""
    _, _, (tp, trp, trs), batches, valid, lut, kw = world
    hp = _hp()
    bl = B // n_dev
    states, tracked = init_states(hp), 0
    for (det, touts, st), yuv, v in zip(_port_framedp(world, n_dev), batches, valid):
        parts = []
        with torch.no_grad():
            for j in range(n_dev):
                states, d, t = pipeline_batch_step(
                    tp, trp, trs, states, torch.from_numpy(yuv[j * bl:(j + 1) * bl]),
                    torch.from_numpy(v[j * bl:(j + 1) * bl]), torch.from_numpy(lut),
                    ycfg=YoloConfig("yolov5n", 80), hp=hp, dtype=torch.float32, **kw)
                parts.append((d, t))
        for k in det:
            want = torch.cat([p[0][k] for p in parts])
            _close(f"det {k}", det[k], want, DET_ATOL)
            assert torch.equal(det[k], want), k
        for i, name in enumerate(touts._fields):
            want = torch.cat([p[1][i] for p in parts])
            _close(name, touts[i], want, TRACK_ATOL)
            assert torch.equal(touts[i], want), name
        for name, have, want in zip(st._fields, st, states):
            _close(f"state {name}", have, want, TRACK_ATOL)
            assert torch.equal(have, want), name
        tracked += int(touts.mask.sum())
    assert tracked > 0  # tracks were confirmed and output


def test_framedp_matches_jax(world):
    """The port at n = 2 against JAX's `make_framedp_step` on 2 of the 8
    CPU devices, two chained batches: integer / bool leaves of det, track
    outputs and state equal, floats within the stated tolerances."""
    jcfg, (yp, rp, rs), _, batches, valid, lut, kw = world
    jhp = JDP(tracker=JTP(**TRACKER), num_classes=C, min_confidence=0.0, max_embed=EMBED)
    jstep = j_make_framedp_step(j_make_mesh(2, axis_names=("frame",)), ycfg=jcfg, hp=jhp, dtype=jnp.float32, **kw)
    jst, tracked = j_init(jhp), 0
    for (det, touts, st), yuv, v in zip(_port_framedp(world, 2), batches, valid):
        jst, jdet, jout = jstep(yp, rp, rs, jnp.asarray(lut), jst, jnp.asarray(yuv), jnp.asarray(v))
        assert int(det["valid"].sum()) > 0
        for k in det:
            _close(f"det {k}", det[k], jdet[k], JAX_BOX_ATOL if k == "boxes" else DET_ATOL)
        for name, have, want in zip(touts._fields, touts, jout):
            _close(name, have, want, TRACK_ATOL)
        for name, have, want in zip(st._fields, st, jst):
            _close(f"state {name}", have, want, TRACK_ATOL)
        tracked += int(np.asarray(jout.mask).sum())
    assert tracked > 0


def test_framedp_close_to_full_batch_single_device(world):
    """Against the full-batch serial step the detections differ by the
    convolutions' batch-extent rounding only."""
    _, _, (tp, trp, trs), batches, valid, lut, kw = world
    hp = _hp()
    (det, _, _), _ = _port_framedp(world, 4)
    with torch.no_grad():
        _, want, _ = pipeline_batch_step(tp, trp, trs, init_states(hp), torch.from_numpy(batches[0]),
                                         torch.from_numpy(valid[0]), torch.from_numpy(lut),
                                         ycfg=YoloConfig("yolov5n", 80), hp=hp, dtype=torch.float32, **kw)
    for k in det:
        _close(f"det {k}", det[k], want[k], DET_ATOL)


def test_framedp_rejects_indivisible_batch(world):
    _, _, (tp, trp, trs), batches, _, lut, kw = world
    step = make_framedp_step(make_mesh(4, ("frame",), "cpu"), ycfg=YoloConfig("yolov5n", 80), hp=_hp(),
                             dtype=torch.float32, **kw)
    with pytest.raises(ValueError, match="multiple of the mesh"):
        step(tp, trp, trs, torch.from_numpy(lut), init_states(_hp()), torch.from_numpy(batches[0][:6]),
             torch.ones(6, dtype=torch.bool))


def test_step_builder_is_memoized_and_exposes_its_mesh():
    kw = dict(ycfg=YoloConfig("yolov5n", 8), hp=_hp(), image_size=(96, 96), src_hw=(80, 160))
    mesh = make_mesh(2, ("frame",), "cpu")
    step = make_framedp_step(mesh, **kw)
    assert step is make_framedp_step(make_mesh(2, ("frame",), "cpu"), **kw)
    assert step is not make_framedp_step(make_mesh(4, ("frame",), "cpu"), **kw)
    assert step.mesh == mesh and step.mesh.shape == {"frame": 2}


def _pipeline_csvs(tmp_path, detect_only):
    """Serial and frame-parallel (2-entry CPU mesh) runs of one static
    10-frame video at detect_batch 4 (the last batch half invalid)."""
    vids, zones = _cams(tmp_path, [("cam_fp", 21, 10)])
    cfg, cam = _configs(zones)
    video = os.path.join(vids, "cam_fp.mp4")
    out = {}
    for name, fp in (("serial", False), ("framedp", True)):
        cfg.frame_parallel = fp
        args = types.SimpleNamespace(weight=None, input_path=video, output_path=str(tmp_path / name), device="cpu",
                                     mapping_dict=None, debug=False)
        pipe = CountingPipeline(args, cfg, cam, mesh=make_mesh(2, ("frame",), "cpu"))
        res = pipe.run_video_detect_only(video) if detect_only else pipe.run_video(video, visualize=False)
        assert res["frames"] == 10
        out[name] = pd.read_csv(res["csv"])
    return out["serial"], out["framedp"]


@pytest.mark.parametrize("detect_only", [False, True], ids=["counting", "detect_only"])
def test_frame_parallel_pipeline_csv_matches_serial(tmp_path, detect_only):
    """`CountingPipeline` with `frame_parallel` on a 2-device CPU mesh writes
    the serial run's CSV, field by field (color left out: random per track
    by design), for the counting pass and for the detect-only pass."""
    a, b = _pipeline_csvs(tmp_path, detect_only)
    cols = [c for c in a.columns if c != "color"]
    pd.testing.assert_frame_equal(a[cols], b[cols])
    assert len(a) > 0


def test_frame_parallel_skipped_when_the_batch_does_not_divide(tmp_path, capsys):
    vids, zones = _cams(tmp_path, [("cam_fp3", 22, 4)])
    cfg, cam = _configs(zones, {"frame_parallel": True})
    args = types.SimpleNamespace(weight=None, input_path=vids, output_path=str(tmp_path / "out"), device="cpu",
                                 mapping_dict=None, debug=False)
    pipe = CountingPipeline(args, cfg, cam, mesh=make_mesh(3, ("frame",), "cpu"))
    assert pipe._frame_parallel_mesh() is None
    assert "frame_parallel skipped: detect_batch 4 not divisible by 3 devices" in capsys.readouterr().out
    assert CountingPipeline(args, cfg, cam)._frame_parallel_mesh() is None  # one CPU device: a no-op


@pytest.mark.parametrize("multicam", [False, True], ids=["single", "multicam"])
def test_run_frame_parallel_flag(tmp_path, capsys, multicam):
    """`run --frame_parallel` runs (one CPU device: a no-op) and sets the
    config; under --multicam it only prints the note."""
    vids, zones = _cams(tmp_path, [("cam_r1", 23, 3)])
    cfg, cam = _configs(zones)
    args = cli.parser.parse_args(["--input_path", vids, "--output_path", str(tmp_path / "out"), "--device", "cpu",
                                  "--no_visualize", "--frame_parallel"] + (["--multicam"] if multicam else []))
    (res,) = cli.main(args, cfg, cam)
    assert res["frames"] == 3 and os.path.exists(res["csv"])
    noted = "--frame_parallel is ignored in --multicam mode" in capsys.readouterr().out
    assert noted == multicam
    assert bool(cfg.frame_parallel) == (not multicam)
