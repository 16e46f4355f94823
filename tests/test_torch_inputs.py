"""PyTorch port, the upload encodings besides the thin I420 one: the device
letterbox (`jax.image.resize`'s anti-aliased bilinear), the host letterbox,
the I420 -> RGB converters, the interleaved crop gather, the
`raw_rgb` / `letterboxed_rgb` branches of the step, and the CSV gate of
`CountingPipeline.run_video` with `thin_upload: false`, each against the
JAX package on the same numpy inputs at f32 on the CPU."""

import ast
import collections
import importlib

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_csv import BOX_ATOL, N_FRAMES, world  # noqa: F401  (world: the CSV gate's module fixture)
from test_torch_slice import B, C, K, MARGIN, make_models
import vehicle_counting_tpu.configs as jcfg
import vehicle_counting_tpu_torch.configs as pcfg
from vehicle_counting_tpu.ops.crops import gather_crops as j_gather_crops
from vehicle_counting_tpu.pipeline import CountingPipeline as JaxPipeline
from vehicle_counting_tpu.pipeline.step import pipeline_batch_step as j_step
from vehicle_counting_tpu.tracking import DeepSortParams as JDP
from vehicle_counting_tpu.tracking import TrackerParams as JTP
from vehicle_counting_tpu.tracking import init_states as j_init
from vehicle_counting_tpu_torch.models.yolo import YoloConfig, decode_predictions, yolov5_forward_nchw
from vehicle_counting_tpu_torch.ops import crops as tcrops
from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw
from vehicle_counting_tpu_torch.pipeline import CountingPipeline as PortPipeline
from vehicle_counting_tpu_torch.pipeline.step import pipeline_batch_step as t_step
from vehicle_counting_tpu_torch.testing import crop_boxes, one_torch_thread
from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, init_states
from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

jl = importlib.import_module("vehicle_counting_tpu.ops.letterbox")
tl = importlib.import_module("vehicle_counting_tpu_torch.ops.letterbox")


@pytest.mark.parametrize("src_hw, dst_hw", [
    ((96, 160), (48, 80)),     # 0.5x: the 720p -> 384x640 ratio, anti-aliased
    ((240, 320), (192, 192)),  # 0.6x, padded rows
    ((40, 64), (96, 128)),     # 2x upscale, padded rows
    ((30, 50), (64, 96)),      # 1.92x upscale, padded columns
])
def test_letterbox_matches_jax(src_hw, dst_hw):
    """atol 1e-5 on [0, 1] values: the same separable weights, summed in
    another order (an einsum in XLA, two matmuls here)."""
    x = np.random.default_rng(sum(src_hw)).integers(0, 256, (2,) + src_hw + (3,), dtype=np.uint8)
    want = np.asarray(jl.letterbox(jnp.asarray(x), dst_hw))
    got = tl.letterbox(torch.from_numpy(x), dst_hw).numpy()
    assert got.shape == want.shape == (2,) + dst_hw + (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_letterbox_is_not_plain_bilinear_when_downsampling():
    """The trap: at 0.5x `jax.image.resize` low-pass filters (a triangle
    two source pixels wide); plain bilinear without anti-aliasing samples
    between two pixels only, and differs from it by far more than 1e-5."""
    x = np.random.default_rng(3).integers(0, 256, (1, 96, 160, 3), dtype=np.uint8)
    want = np.asarray(jl.letterbox(jnp.asarray(x), (48, 80)))
    plain = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2).float(), size=(48, 80),
                                            mode="bilinear", align_corners=False).permute(0, 2, 3, 1) / 255.0
    assert np.abs(plain.numpy() - want).max() > 1e-2
    w = tl._resize_weights(96, 48)
    taps = np.count_nonzero(w, axis=0)
    assert (taps[1:-1] == 4).all() and taps[0] == taps[-1] == 3  # the edge rows' outer taps fall outside


def test_host_letterbox_array_equal():
    x = np.random.default_rng(4).integers(0, 256, (3, 72, 128, 3), dtype=np.uint8)
    for dst in ((96, 128), (64, 64)):
        np.testing.assert_array_equal(tl.host_letterbox(x, dst), jl.host_letterbox(x, dst))


def test_yuv420_to_rgb_matches_jax():
    """u8 interleaved and planar: array-equal; f32: atol 1e-4 on 0..255."""
    yuv = np.random.default_rng(5).integers(0, 256, (2, 96, 64), dtype=np.uint8)
    want_u8 = np.asarray(jl.yuv420_to_rgb_u8(jnp.asarray(yuv)))
    np.testing.assert_array_equal(tl.yuv420_to_rgb_u8(torch.from_numpy(yuv)).numpy(), want_u8)
    np.testing.assert_array_equal(tl.yuv420_to_rgb_u8_planar(torch.from_numpy(yuv)).numpy(),
                                  want_u8.transpose(0, 3, 1, 2))
    np.testing.assert_allclose(tl.yuv420_to_rgb(torch.from_numpy(yuv)).numpy(),
                               np.asarray(jl.yuv420_to_rgb(jnp.asarray(yuv))), rtol=0, atol=1e-4)


def test_gather_crops_interleaved_matches_jax_op_by_op():
    """One interleaved frame through the port's `gather_crops` (K1's plain
    version on its planar copy here) against JAX's `gather_crops`, op by
    op (`jax.disable_jit`: XLA's fused einsum rounds differently), atol
    1e-6; equal to the batch gather on the planar frame, bitwise."""
    rng = np.random.default_rng(6)
    frame = rng.integers(0, 256, (72, 120, 3), dtype=np.uint8)
    boxes = crop_boxes(rng, 40, 72, 120)
    boxes[-3:] = [[0, 0, 120, 72], [5, 5, 5, 5], [-1, -1, 121, 73]]
    valid = rng.random(40) < 0.85
    with jax.disable_jit():
        want = np.asarray(j_gather_crops(jnp.asarray(frame), jnp.asarray(boxes), jnp.asarray(valid)))
    got = tcrops.gather_crops(torch.from_numpy(frame), torch.from_numpy(boxes), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    planar = torch.from_numpy(np.ascontiguousarray(frame.transpose(2, 0, 1)[None]))
    same = tcrops.gather_crops_batch(planar, torch.zeros(40, dtype=torch.int32), torch.from_numpy(boxes),
                                     torch.from_numpy(valid))
    assert torch.equal(got, same)
    assert tcrops.planar_copy(torch.from_numpy(frame[None])).is_contiguous()


def _raw_batches(src_hw, n_batches, seed):
    """Near-static scenes, as `test_torch_slice.make_batches`, raw RGB."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, src_hw + (3,)).astype(np.int16)
    return [np.clip(base + rng.integers(-3, 4, (B,) + src_hw + (3,)), 0, 255).astype(np.uint8)
            for _ in range(n_batches)]


def _calibrate(tparams, imgs_list):
    """(conf, lut) in a gap of every anchor score (none within MARGIN),
    tracking the 4 dominant classes above it; imgs NCHW in [0, 1]."""
    scores, classes = [], []
    with torch.no_grad():
        for imgs in imgs_list:
            heads = [h.permute(0, 2, 3, 1) for h in yolov5_forward_nchw(tparams, imgs)]
            dec = decode_predictions(heads, YoloConfig("yolov5n", 80))
            scores.append(dec["scores"].numpy().ravel())
            classes.append(dec["classes"].numpy().ravel())
    s_all, c_all = np.concatenate(scores), np.concatenate(classes)
    s = np.sort(np.unique(s_all))[::-1]
    n = 8 * B * len(imgs_list)
    gaps = s[n // 3 : 3 * n] - s[n // 3 + 1 : 3 * n + 1]
    i = n // 3 + int(np.argmax(gaps))
    conf = float((s[i] + s[i + 1]) / 2)
    assert np.abs(s_all - conf).min() > MARGIN
    top4 = [c for c, _ in collections.Counter(c_all[s_all > conf].tolist()).most_common(C)]
    lut = np.full(80, -1, np.int32)
    lut[top4] = np.arange(len(top4))
    return conf, lut


@pytest.mark.parametrize("frames_format", ["raw_rgb", "letterboxed_rgb"])
def test_step_rgb_formats_match_jax(frames_format):
    """`pipeline_batch_step` on the two RGB uploads, two chained batches
    (tracker state carried), yolov5n, 72x128 -> 96x128, f32: detections
    valid / classes and track mask / ids equal to JAX's, boxes atol 1e-3
    px. raw_rgb crops from the raw frames at source resolution;
    letterboxed_rgb from the letterbox through the gain/pad transform."""
    src_hw = (72, 128)
    net = autoshape_hw(src_hw, 128)
    jcfg_y, (yp, rp, rs), (tp, trp, trs) = make_models()
    raw = _raw_batches(src_hw, 2, seed=1)
    if frames_format == "raw_rgb":
        uploads = raw
        imgs = [tl.letterbox(torch.from_numpy(f), net).permute(0, 3, 1, 2) for f in raw]
    else:
        uploads = [tl.host_letterbox(f, net) for f in raw]
        imgs = [torch.from_numpy(u).permute(0, 3, 1, 2).float() / 255.0 for u in uploads]
    conf, lut = _calibrate(tp, imgs)
    jhp = JDP(tracker=JTP(capacity=K), num_classes=C)
    thp = DeepSortParams(tracker=TrackerParams(capacity=K), num_classes=C)
    kw = dict(image_size=net, src_hw=src_hw, conf_thres=conf, iou_thres=0.45, max_det=100, frames_format=frames_format)
    jst, tst = j_init(jhp), init_states(thp)
    tracked = 0
    for up in uploads:
        jst, jdet, jout = j_step(yp, rp, rs, jst, jnp.asarray(up), jnp.ones(B, bool), jnp.asarray(lut),
                                 ycfg=jcfg_y, hp=jhp, dtype=jnp.float32, **kw)
        with torch.no_grad():
            tst, tdet, tout = t_step(tp, trp, trs, tst, torch.from_numpy(up), torch.ones(B, dtype=torch.bool),
                                     torch.from_numpy(lut), ycfg=YoloConfig("yolov5n", 80), hp=thp,
                                     dtype=torch.float32, **kw)
        jvalid = np.asarray(jdet["valid"])
        assert jvalid.sum() > 0
        assert np.abs(np.asarray(jdet["scores"])[jvalid] - thp.min_confidence).min() > MARGIN
        np.testing.assert_array_equal(tdet["valid"].numpy(), jvalid)
        np.testing.assert_array_equal(tdet["classes"].numpy(), np.asarray(jdet["classes"]))
        np.testing.assert_allclose(tdet["boxes"].numpy(), np.asarray(jdet["boxes"]), atol=1e-3)
        np.testing.assert_array_equal(tout.mask.numpy(), np.asarray(jout.mask))
        np.testing.assert_array_equal(tout.ids.numpy(), np.asarray(jout.ids))
        np.testing.assert_allclose(tout.boxes.numpy(), np.asarray(jout.boxes), atol=1e-3)
        tracked += int(np.asarray(jout.mask).sum())
    assert tracked > 0


def test_unknown_frames_format_raises():
    _, _, (tp, trp, trs) = make_models()
    hp = DeepSortParams(tracker=TrackerParams(capacity=K), num_classes=C)
    with pytest.raises(ValueError, match="frames_format"):
        t_step(tp, trp, trs, init_states(hp), torch.zeros((1, 8, 8, 3), dtype=torch.uint8),
               torch.ones(1, dtype=torch.bool), torch.arange(80, dtype=torch.int32), ycfg=YoloConfig("yolov5n", 80),
               hp=hp, image_size=(32, 32), src_hw=(8, 8), frames_format="bgr")


def _run_raw(pipeline_cls, cfg_mod, world, out_dir, device=None):
    """test_torch_csv's run with `thin_upload: false`."""
    import types

    yolo_pt, reid_t7, video, zones = world
    cfg = cfg_mod.config_from_dict(cfg_mod.default_config(), {
        "detect_batch": 8, "max_tracks_per_class": 16, "image_size": [192, 192], "model_name": "yolov5n",
        "min_conf": 1e-4, "max_det": 8, "compute_dtype": "float32", "thin_upload": False,
    })
    cam = cfg_mod.default_cam_config().to_dict()
    cam["zone_path"] = zones
    cam["checkpoint"] = reid_t7
    cam.setdefault("cam", {})["cam_gate"] = {"tracking_config": {"MIN_CONFIDENCE": 0.0, "N_INIT": 2, "MAX_AGE": 5}}
    args = types.SimpleNamespace(weight=yolo_pt, input_path=video, output_path=str(out_dir), debug=False)
    if device:
        args.device = device
    pipe = pipeline_cls(args, cfg, cfg_mod.Config(_settings=cam))
    result = pipe.run_video(video, visualize=False)
    return result, pd.read_csv(result["csv"])


def test_csv_gate_raw_upload(world, tmp_path):  # noqa: F811
    """`thin_upload: false` (full frames uploaded, letterboxed on the
    device, crops from the raw frames) through both pipelines on the CSV
    gate's world: rows equal field by field (`color` aside), boxes and the
    points derived from them at atol 1e-3 px."""
    jres, jdf = _run_raw(JaxPipeline, jcfg, world, tmp_path / "jax")
    pres, pdf = _run_raw(PortPipeline, pcfg, world, tmp_path / "port", "cpu")
    assert pres["frames"] == jres["frames"] == N_FRAMES
    assert len(jdf) > 0 and len(pdf) == len(jdf)
    for col in ("track_id", "frame_id", "label", "direction", "fframe", "lframe"):
        assert pdf[col].tolist() == jdf[col].tolist(), col
    for col in ("box", "fpoint", "lpoint"):
        got = np.asarray([ast.literal_eval(v) for v in pdf[col]], np.float64)
        want = np.asarray([ast.literal_eval(v) for v in jdf[col]], np.float64)
        np.testing.assert_allclose(got, want, rtol=0, atol=BOX_ATOL, err_msg=col)
