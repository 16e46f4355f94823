"""PyTorch port: the JAX package's calls of its public functions, made on the
port. Each case calls a port function exactly as JAX's own callers and
tests call the JAX function (the same positional and keyword arguments,
the defaults left to the function) on the same numpy inputs, and holds
the results to JAX's. Weights: yolov5n from `init_yolov5(PRNGKey(0))` and
the ReID CNN from `init_reid(PRNGKey(1))`, converted by `models/convert.py`
(`test_torch_slice.make_models`); f32 unless a case says otherwise.
Discrete outputs must be equal; float ones agree within the tolerance each
case states (XLA and PyTorch sum convolutions in different orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_slice import make_models
from vehicle_counting_tpu.models import layers as jlayers
from vehicle_counting_tpu.models import reid as jreid
from vehicle_counting_tpu.models import yolo as jyolo
from vehicle_counting_tpu.ops import crops as jcrops
from vehicle_counting_tpu.pipeline import step as jstep
from vehicle_counting_tpu.tracking import DeepSortParams as JDP
from vehicle_counting_tpu.tracking import TrackerParams as JTP
from vehicle_counting_tpu.tracking import assignment as jassign
from vehicle_counting_tpu.tracking import deepsort as jdeepsort
from vehicle_counting_tpu.tracking import init_states as j_init
from vehicle_counting_tpu_torch.models import layers as tlayers
from vehicle_counting_tpu_torch.models import reid as treid
from vehicle_counting_tpu_torch.models import yolo as tyolo
from vehicle_counting_tpu_torch.models.convert import reid_params_from_jax, yolo_params_from_jax
from vehicle_counting_tpu_torch.ops import crops as tcrops
from vehicle_counting_tpu_torch.ops.letterbox import content_rows, host_letterbox_yuv420
from vehicle_counting_tpu_torch.pipeline import step as tstep
from vehicle_counting_tpu_torch.tracking import assignment as tassign
from vehicle_counting_tpu_torch.tracking import deepsort as tdeepsort
from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, init_states
from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams

# f32 against JAX: boxes in pixels, features and heads in their own units
# (the tolerance test_torch_slice.py and test_torch_models.py hold them to)
ATOL = 1e-3
# the detector at JAX's default bf16 compute dtype: a head value is a
# bf16 rounding of a sum, so both packages may differ by a few of its ulps
BF16_ATOL = 0.25
SRC = (64, 64)
TRACKER = dict(capacity=8, budget=4, max_age=5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six test workers at once, and
    more threads per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return make_models()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree(have, want, what):
    """A port tensor (or tuple of them) against JAX's: shapes equal, integer
    and bool leaves equal, floats within ATOL."""
    if isinstance(want, dict):
        assert sorted(have) == sorted(want), what
        for k in want:
            _assert_tree(have[k], want[k], f"{what}[{k}]")
        return
    if isinstance(want, (list, tuple)):
        assert len(have) == len(want), what
        for i, (h, w) in enumerate(zip(have, want)):
            _assert_tree(h, w, f"{what}[{i}]")
        return
    h, w = have.detach().float().numpy() if have.dtype == torch.bfloat16 else have.detach().numpy(), np.asarray(want)
    assert h.shape == w.shape, (what, h.shape, w.shape)
    if np.issubdtype(w.dtype, np.floating):
        np.testing.assert_allclose(h, w.astype(np.float32), rtol=0, atol=ATOL, err_msg=what)
    else:
        np.testing.assert_array_equal(h, w, err_msg=what)


def _raw_frames():
    return np.random.default_rng(0).integers(0, 256, (2,) + SRC + (3,), dtype=np.uint8)


def _lut():
    return np.where(np.arange(80) < 2, np.arange(80), -1).astype(np.int32)


@pytest.mark.parametrize("fn", ["pipeline_batch_step", "detect_embed_core"])
def test_step_default_frames_format_is_raw_rgb(models, fn):
    """JAX's call with no `frames_format`: raw [2, 64, 64, 3] u8 frames, the
    default raw_rgb upload. The port defaulted to letterboxed_yuv420 and
    raised in `_i420_pixels`; now both give the same detections (boxes
    [2, 8, 4]), features and track outputs."""
    jcfg, (yp, rp, rs), (tp, trp, trs) = models
    frames, valid, lut = _raw_frames(), np.ones(2, bool), _lut()
    kw = dict(image_size=SRC, src_hw=SRC, max_det=8)
    jhp = JDP(tracker=JTP(**TRACKER), num_classes=2)
    thp = DeepSortParams(tracker=TrackerParams(**TRACKER), num_classes=2)
    jargs = (jnp.asarray(frames), jnp.asarray(valid), jnp.asarray(lut))
    targs = (torch.from_numpy(frames), torch.from_numpy(valid), torch.from_numpy(lut))
    with torch.no_grad():
        if fn == "pipeline_batch_step":
            want = jstep.pipeline_batch_step(yp, rp, rs, j_init(jhp), *jargs, ycfg=jcfg, hp=jhp, dtype=jnp.float32,
                                             **kw)
            have = tstep.pipeline_batch_step(tp, trp, trs, init_states(thp), *targs, ycfg=tyolo.YoloConfig("yolov5n", 80),
                                             hp=thp, dtype=torch.float32, **kw)
            det_h, det_w = have[1], want[1]
            _assert_tree(tuple(have[2]), tuple(want[2]), "track_outs")
            _assert_tree(tuple(have[0]), tuple(want[0]), "states")
        else:
            want = jstep.detect_embed_core(yp, rp, rs, *jargs, ycfg=jcfg, hp=jhp, dtype=jnp.float32, **kw)
            have = tstep.detect_embed_core(tp, trp, trs, *targs, ycfg=tyolo.YoloConfig("yolov5n", 80), hp=thp,
                                           dtype=torch.float32, **kw)
            det_h, det_w = have[0], want[0]
            _assert_tree(have[1], want[1], "feats")
    assert tuple(det_h["boxes"].shape) == (2, 8, 4)
    _assert_tree(det_h, det_w, "det")


def test_detect_only_step_takes_content_only(models):
    """JAX's call with `content_only=True` on a content-row I420 upload (the
    port had no such keyword: TypeError), and the full letterbox with the
    default; a `content_only` the upload's row count contradicts raises."""
    jcfg, (yp, _, _), (tp, _, _) = models
    src, net = (48, 64), (64, 64)
    frames = np.random.default_rng(3).integers(0, 256, (2,) + src + (3,), dtype=np.uint8)
    kw = dict(image_size=net, src_hw=src, conf_thres=0.0, max_det=8)
    tcfg = tyolo.YoloConfig("yolov5n", 80)
    for content in (True, False):
        yuv = host_letterbox_yuv420(frames, net, content_only=content)
        jkw = dict(kw, content_only=True) if content else kw
        want = jstep.detect_only_step(yp, jnp.asarray(yuv), ycfg=jcfg, dtype=jnp.float32, **jkw)
        with torch.no_grad():
            have = tstep.detect_only_step(tp, torch.from_numpy(yuv), ycfg=tcfg, dtype=torch.float32, **jkw)
        assert int(have["valid"].sum()) > 0
        _assert_tree(have, want, f"content_only={content}")
        with pytest.raises(ValueError, match="rows"):
            tstep.detect_only_step(tp, torch.from_numpy(yuv), ycfg=tcfg, dtype=torch.float32,
                                   **dict(kw, content_only=not content))
    assert content_rows(src, net)[1] < net[0]  # the two uploads differ


def test_matching_cost_matrix_clamps_at_max_distance_plus_eps():
    """JAX's `tests/test_assignment.py::test_matching_cost_matrix_clamps`
    call with max_distance 0.6: every entry above it becomes 0.6 + 1e-5
    (the port clamped at 0.6 itself), bitwise JAX's."""
    rng = np.random.default_rng(4)
    cost = rng.uniform(0, 1.2, (6, 5)).astype(np.float32)
    cost[0, :2] = [0.1, 5.0]
    row, col = rng.random(6) < 0.7, rng.random(5) < 0.8
    row[0] = col[:2] = True
    for max_distance in (0.6, 0.2, 0.7):
        want = np.asarray(jassign.matching_cost_matrix(jnp.asarray(cost), jnp.asarray(row), jnp.asarray(col),
                                                       max_distance))
        have = tassign.matching_cost_matrix(torch.from_numpy(cost), torch.from_numpy(row), torch.from_numpy(col),
                                            max_distance).numpy()
        np.testing.assert_array_equal(have, want)
    assert have[0, 1] == np.float32(0.7 + 1e-5)


def test_yolov5_forward_takes_jax_call(models):
    """`yolov5_forward(params, images, cfg)` at JAX's default compute dtype
    (bf16) and with `dtype=float32`; a cfg the params are not raises."""
    jcfg, (yp, _, _), (tp, _, _) = models
    imgs = np.random.default_rng(5).random((2, 64, 96, 3)).astype(np.float32)
    tcfg = tyolo.YoloConfig("yolov5n", 80)
    want = jyolo.yolov5_forward(yp, jnp.asarray(imgs), jcfg)
    with torch.no_grad():
        have = tyolo.yolov5_forward(tp, torch.from_numpy(imgs), tcfg)
        have32 = tyolo.yolov5_forward(tp, torch.from_numpy(imgs), tcfg, dtype=torch.float32)
    want32 = jyolo.yolov5_forward(yp, jnp.asarray(imgs), jcfg, dtype=jnp.float32)
    assert [h.dtype for h in have] == [torch.bfloat16] * 3 and [w.dtype for w in want] == [jnp.bfloat16] * 3
    for h, w in zip(have, want):
        np.testing.assert_allclose(h.float().numpy(), np.asarray(w, np.float32), rtol=0, atol=BF16_ATOL)
    _assert_tree(have32, want32, "heads f32")
    with pytest.raises(ValueError, match="yolov5s"):
        tyolo.yolov5_forward(tp, torch.from_numpy(imgs), tyolo.YoloConfig("yolov5s", 80))
    with pytest.raises(ValueError, match="classes"):
        tyolo.yolov5_forward(tp, torch.from_numpy(imgs), tyolo.YoloConfig("yolov5n", 4))


@pytest.mark.parametrize("b", [2, 3])
def test_reid_forward_returns_out_and_stats(models, b):
    """JAX's idiom `emb, _ = reid_forward(params, stats, x)` at B = 2 (the
    port silently unpacked the batch axis) and B = 3 (it raised), then the
    logits head (`reid=False`) and a bf16 compute dtype; the stats come
    back as JAX's."""
    _, (_, rp, rs), (_, trp, trs) = models
    x = np.random.default_rng(6).standard_normal((b, 50, 50, 3)).astype(np.float32)
    emb_w, stats_w = jreid.reid_forward(rp, rs, jnp.asarray(x))
    with torch.no_grad():
        emb_h, stats_h = treid.reid_forward(trp, trs, torch.from_numpy(x))
        logits_h, _ = treid.reid_forward(trp, trs, torch.from_numpy(x), reid=False)
        bf_h, _ = treid.reid_forward(trp, trs, torch.from_numpy(x), dtype=torch.bfloat16)
    assert tuple(emb_h.shape) == (b, 512)
    _assert_tree(emb_h, emb_w, "embeddings")
    _assert_tree(stats_h, _np(stats_w), "stats")
    logits_w, _ = jreid.reid_forward(rp, rs, jnp.asarray(x), reid=False)
    _assert_tree(logits_h, logits_w, "logits")
    bf_w, _ = jreid.reid_forward(rp, rs, jnp.asarray(x), dtype=jnp.bfloat16)
    np.testing.assert_allclose(bf_h.numpy(), np.asarray(bf_w), rtol=0, atol=2e-2)
    with pytest.raises(ValueError, match="f32"):
        treid.reid_forward(trp, trs, torch.from_numpy(x), train=True, dtype=torch.bfloat16)


def test_reid_forward_trains_as_jax():
    """`reid_forward(..., train=True, reid=False)` without dropout: JAX's
    logits and updated running stats."""
    rp, rs = jax.jit(jreid.init_reid)(jax.random.PRNGKey(1))
    trp, trs = reid_params_from_jax(_np(rp), _np(rs))
    x = np.random.default_rng(7).standard_normal((4, 50, 50, 3)).astype(np.float32)
    want, new_w = jreid.reid_forward(rp, rs, jnp.asarray(x), train=True, reid=False)
    with torch.no_grad():
        have, new_h = treid.reid_forward(trp, trs, torch.from_numpy(x), train=True, reid=False)
    _assert_tree(have, want, "train logits")
    _assert_tree(new_h, _np(new_w), "new stats")


@pytest.mark.parametrize("out_size,dtype", [(None, None), ((32, 24), None), ((32, 24), "bfloat16")])
def test_gather_crops_takes_out_size_and_dtype(out_size, dtype):
    """`gather_crops(frame, boxes, valid, out_size, dtype)`: the ReID size by
    default (K1's plain version here), any other size, and JAX's column
    dtype (which only its TPU lowering uses) against JAX on the CPU, within
    1e-4: JAX's jitted gather rounds its column einsum its own way (up to
    ~2e-5, test_torch_crops.py)."""
    rng = np.random.default_rng(8)
    frame = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    boxes = np.stack([rng.uniform(-5, 30, 6), rng.uniform(-5, 20, 6), rng.uniform(20, 60, 6),
                      rng.uniform(15, 45, 6)], 1).astype(np.float32)
    valid = np.array([True, True, False, True, True, True])
    jargs = (jnp.asarray(frame), jnp.asarray(boxes), jnp.asarray(valid))
    targs = (torch.from_numpy(frame), torch.from_numpy(boxes), torch.from_numpy(valid))
    if out_size is None:
        want, have = jcrops.gather_crops(*jargs), tcrops.gather_crops(*targs)
    else:
        want = jcrops.gather_crops(*jargs, out_size, getattr(jnp, dtype) if dtype else None)
        have = tcrops.gather_crops(*targs, out_size, getattr(torch, dtype) if dtype else None)
    assert tuple(have.shape) == (6,) + (out_size or (50, 50)) + (3,)
    np.testing.assert_allclose(have.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_conv_block_takes_dtype():
    """`conv_block(params, x, ..., dtype=...)`, JAX's compute dtype keyword."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 9, 11, 8)).astype(np.float32)
    p = jlayers.init_conv(jax.random.PRNGKey(2), 3, 8, 16)
    tp = yolo_params_from_jax({"c": _np(p)})["c"]
    for dtype in ("float32", "bfloat16"):
        want = jlayers.conv_block(p, jnp.asarray(x), stride=2, dtype=getattr(jnp, dtype))
        have = tlayers.conv_block(tp, torch.from_numpy(x), stride=2, dtype=getattr(torch, dtype))
        assert str(have.dtype) == f"torch.{dtype}"
        np.testing.assert_allclose(have.float().numpy(), np.asarray(want, np.float32), rtol=0,
                                   atol=ATOL if dtype == "float32" else 5e-2)


def test_embed_detections_batch_defaults_read_the_layout(models):
    """`embed_detections_batch(frames, boxes, valid, params, stats, hp)` on
    interleaved [B, H, W, 3] frames with no `planar` and no `dtype`: JAX
    reads the layout from the shape and embeds in f32; the port defaulted
    to planar and read the frames wrongly."""
    _, (_, rp, rs), (_, trp, trs) = models
    rng = np.random.default_rng(10)
    frames = rng.integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    boxes = np.stack([rng.uniform(0, 30, (2, 4)), rng.uniform(0, 20, (2, 4)), rng.uniform(34, 64, (2, 4)),
                      rng.uniform(24, 48, (2, 4))], -1).astype(np.float32)
    valid = np.array([[True, True, False, True], [False, True, True, True]])
    jhp = JDP(tracker=JTP(**TRACKER), num_classes=2)
    thp = DeepSortParams(tracker=TrackerParams(**TRACKER), num_classes=2)
    want = jdeepsort.embed_detections_batch(jnp.asarray(frames), jnp.asarray(boxes), jnp.asarray(valid), rp, rs, jhp)
    with torch.no_grad():
        have = tdeepsort.embed_detections_batch(torch.from_numpy(frames), torch.from_numpy(boxes),
                                                torch.from_numpy(valid), trp, trs, thp)
        planar = tdeepsort.embed_detections_batch(torch.from_numpy(frames).permute(0, 3, 1, 2).contiguous(),
                                                  torch.from_numpy(boxes), torch.from_numpy(valid), trp, trs, thp)
    _assert_tree(have, want, "features")
    assert torch.equal(have, planar)
