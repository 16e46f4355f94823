"""The whole slice: the port's `pipeline_batch_step` against JAX's on the
same weights (carried across), the same host-packed I420 batches and the
same tracker settings, f32 on the CPU, yolov5n, B=4, two chained batches
(tracker state carried) at 72x128 -> 96x128, where the content-only
upload is exact; the full-I420 upload (88x160) is in test_torch_pipeline.py."""

import collections

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vehicle_counting_tpu.models.reid import init_reid
from vehicle_counting_tpu.models.yolo import YoloConfig as JYoloConfig
from vehicle_counting_tpu.models.yolo import init_yolov5
from vehicle_counting_tpu.pipeline.step import pipeline_batch_step as j_step
from vehicle_counting_tpu.tracking import DeepSortParams as JDP
from vehicle_counting_tpu.tracking import TrackerParams as JTP
from vehicle_counting_tpu.tracking import init_states as j_init
from vehicle_counting_tpu_torch.models.convert import reid_params_from_jax, yolo_params_from_jax
from vehicle_counting_tpu_torch.models.yolo import YoloConfig, decode_predictions, yolov5_forward_nchw
from vehicle_counting_tpu_torch.ops.letterbox import (
    autoshape_hw,
    content_upload_exact,
    host_letterbox_yuv420,
    yuv420_content_to_full,
    yuv420_to_rgb_u8_planar,
)
from vehicle_counting_tpu_torch.pipeline.step import pipeline_batch_step as t_step
from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, init_states
from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams
from vehicle_counting_tpu_torch.testing import one_torch_thread

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

K, C, B = 16, 4, 4
MARGIN = 1e-4


def make_models():
    jcfg = JYoloConfig(variant="yolov5n", num_classes=80)
    yp = jax.jit(init_yolov5, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    rp, rs = jax.jit(init_reid)(jax.random.PRNGKey(1))
    tp = yolo_params_from_jax(jax.tree.map(np.asarray, yp))
    trp, trs = reid_params_from_jax(jax.tree.map(np.asarray, rp), jax.tree.map(np.asarray, rs))
    return jcfg, (yp, rp, rs), (tp, trp, trs)


def make_batches(src_hw, n_batches, seed):
    """Near-static scenes (one base image plus small noise), so detections
    persist across frames and tracks get confirmed."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, src_hw + (3,)).astype(np.int16)
    frames = [np.clip(base + rng.integers(-3, 4, (B,) + src_hw + (3,)), 0, 255).astype(np.uint8)
              for _ in range(n_batches)]
    net = autoshape_hw(src_hw, 128)
    exact = content_upload_exact(src_hw, net)
    return net, exact, [host_letterbox_yuv420(f, net, content_only=exact) for f in frames]


def calibrate(tparams, batches, src_hw, net, n_per_frame=8):
    """(conf, lut): a threshold admitting ~n_per_frame anchors per frame,
    in a gap of every anchor score of every batch so none is within
    MARGIN of it, and a LUT tracking the 4 dominant classes above it."""
    scores, classes = [], []
    with torch.no_grad():
        for yuv in batches:
            y = torch.from_numpy(yuv)
            if y.shape[1] != net[0] * 3 // 2:
                y = yuv420_content_to_full(y, src_hw, net)
            rgb = yuv420_to_rgb_u8_planar(y).float() / 255.0
            heads = [h.permute(0, 2, 3, 1) for h in yolov5_forward_nchw(tparams, rgb)]
            dec = decode_predictions(heads, YoloConfig("yolov5n", 80))
            scores.append(dec["scores"].numpy().ravel())
            classes.append(dec["classes"].numpy().ravel())
    s_all, c_all = np.concatenate(scores), np.concatenate(classes)
    s = np.sort(np.unique(s_all))[::-1]
    n = n_per_frame * B * len(batches)
    gaps = s[n // 3 : 3 * n] - s[n // 3 + 1 : 3 * n + 1]
    i = n // 3 + int(np.argmax(gaps))
    assert s[i] - s[i + 1] > 2 * MARGIN
    conf = float((s[i] + s[i + 1]) / 2)
    top4 = [c for c, _ in collections.Counter(c_all[s_all > conf].tolist()).most_common(C)]
    lut = np.full(80, -1, np.int32)
    lut[top4] = np.arange(len(top4))
    assert np.abs(s_all - conf).min() > MARGIN
    return conf, lut


def run_both(src_hw, n_batches, seed):
    jcfg, (yp, rp, rs), (tp, trp, trs) = make_models()
    net, exact, batches = make_batches(src_hw, n_batches, seed)
    conf, lut = calibrate(tp, batches, src_hw, net)
    jhp = JDP(tracker=JTP(capacity=K), num_classes=C)
    thp = DeepSortParams(tracker=TrackerParams(capacity=K), num_classes=C)
    kw = dict(image_size=net, src_hw=src_hw, conf_thres=conf, iou_thres=0.45, max_det=100,
              frames_format="letterboxed_yuv420")
    jst, tst = j_init(jhp), init_states(thp)
    tracked = 0
    for yuv in batches:
        jst, jdet, jout = j_step(yp, rp, rs, jst, jnp.asarray(yuv), jnp.ones(B, bool), jnp.asarray(lut),
                                 ycfg=jcfg, hp=jhp, dtype=jnp.float32, **kw)
        with torch.no_grad():
            tst, tdet, tout = t_step(tp, trp, trs, tst, torch.from_numpy(yuv), torch.ones(B, dtype=torch.bool),
                                     torch.from_numpy(lut), ycfg=YoloConfig("yolov5n", 80), hp=thp,
                                     dtype=torch.float32, **kw)
        jvalid = np.asarray(jdet["valid"])
        assert jvalid.sum() > 0
        # the tracker's MIN_CONFIDENCE is a threshold too
        assert np.abs(np.asarray(jdet["scores"])[jvalid] - thp.min_confidence).min() > MARGIN
        np.testing.assert_array_equal(tdet["valid"].numpy(), jvalid)
        np.testing.assert_array_equal(tdet["classes"].numpy(), np.asarray(jdet["classes"]))
        np.testing.assert_allclose(tdet["boxes"].numpy(), np.asarray(jdet["boxes"]), atol=1e-3)
        np.testing.assert_array_equal(tout.mask.numpy(), np.asarray(jout.mask))
        np.testing.assert_array_equal(tout.ids.numpy(), np.asarray(jout.ids))
        np.testing.assert_allclose(tout.boxes.numpy(), np.asarray(jout.boxes), atol=1e-3)
        tracked += int(np.asarray(jout.mask).sum())
    return exact, tracked


def test_slice_matches_jax_content_upload():
    exact, tracked = run_both((72, 128), 2, seed=0)
    assert exact
    assert tracked > 0  # tracks were confirmed and output
