"""PyTorch port, models: YOLOv5 heads, the detect tail and the ReID CNN
against the JAX package on the same weights (carried across by
models/convert.py) and the same numpy inputs, in f32 on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vehicle_counting_tpu.models import detector as jdet
from vehicle_counting_tpu.models import layers as jlayers
from vehicle_counting_tpu.models import reid as jreid
from vehicle_counting_tpu.models import yolo as jyolo
from vehicle_counting_tpu.ops.nms import batched_nms as j_batched_nms
from vehicle_counting_tpu_torch.models import detector as tdet
from vehicle_counting_tpu_torch.models import layers as tlayers
from vehicle_counting_tpu_torch.models import reid as treid
from vehicle_counting_tpu_torch.models import yolo as tyolo
from vehicle_counting_tpu_torch.models.convert import reid_params_from_jax, yolo_params_from_jax
from vehicle_counting_tpu_torch.ops.nms import batched_nms as t_batched_nms
from vehicle_counting_tpu_torch.ops.nms import stable_topk
from vehicle_counting_tpu_torch.testing import one_torch_thread

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

# conv summation order differs between XLA:CPU and oneDNN
CONV_TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def calibrated_conf(scores: np.ndarray, n: int) -> float:
    """A threshold admitting about n detections, placed mid-way in a gap of
    the score distribution so no score lies within 1e-4 of it (random-init
    weights score everything low; equality near a threshold would be luck)."""
    s = np.sort(np.unique(scores.ravel()))[::-1]
    lo, hi = n // 3, min(3 * n, s.size - 1)
    gaps = s[lo:hi] - s[lo + 1 : hi + 1]
    i = lo + int(np.argmax(gaps))
    assert s[i] - s[i + 1] > 2e-4
    return float((s[i] + s[i + 1]) / 2)


@pytest.fixture(scope="module")
def yolo_n():
    cfg = jyolo.YoloConfig(variant="yolov5n", num_classes=80)
    params = jax.jit(jyolo.init_yolov5, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    return cfg, params, yolo_params_from_jax(_np(params))


@pytest.fixture(scope="module")
def images_and_heads(yolo_n):
    """Three 96x128 images and JAX's f32 heads for them (one compile)."""
    cfg, jp, _ = yolo_n
    imgs = np.random.default_rng(1).random((3, 96, 128, 3)).astype(np.float32)
    fwd = jax.jit(lambda p, x: jyolo.yolov5_forward(p, x, cfg, dtype=jnp.float32))
    return imgs, fwd(jp, jnp.asarray(imgs))


def test_layers_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 11, 8)).astype(np.float32)
    p = jlayers.init_conv(jax.random.PRNGKey(2), 3, 8, 16)
    tp = yolo_params_from_jax({"c": _np(p)})["c"]
    for stride in (1, 2):
        np.testing.assert_allclose(
            tlayers.conv_block(tp, torch.from_numpy(x), stride=stride).numpy(),
            np.asarray(jlayers.conv_block(p, jnp.asarray(x), stride=stride)), rtol=CONV_TOL, atol=CONV_TOL,
        )
    np.testing.assert_array_equal(
        tlayers.max_pool(torch.from_numpy(x), 5, 1, 2).numpy(), np.asarray(jlayers.max_pool(jnp.asarray(x), 5, 1, 2))
    )
    np.testing.assert_array_equal(
        tlayers.upsample2x_nearest(torch.from_numpy(x)).numpy(), np.asarray(jlayers.upsample2x_nearest(jnp.asarray(x)))
    )


def test_yolo_heads_and_decode_match(yolo_n, images_and_heads):
    cfg, jp, tp = yolo_n
    imgs, jh = images_and_heads
    th = tyolo.yolov5_forward(tp, torch.from_numpy(imgs), tyolo.YoloConfig("yolov5n", 80), dtype=torch.float32)
    assert [tuple(h.shape) for h in th] == [h.shape for h in jh]
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=CONV_TOL, atol=CONV_TOL)
    # decode on identical heads
    jdec = jyolo.decode_predictions(jh, cfg)
    tdec = tyolo.decode_predictions([torch.from_numpy(np.asarray(h)) for h in jh], tyolo.YoloConfig("yolov5n", 80))
    np.testing.assert_array_equal(tdec["classes"].numpy(), np.asarray(jdec["classes"]))
    np.testing.assert_allclose(tdec["boxes"].numpy(), np.asarray(jdec["boxes"]), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(tdec["scores"].numpy(), np.asarray(jdec["scores"]), rtol=1e-6, atol=1e-7)


def test_init_shapes_match_jax(yolo_n):
    cfg, jp, _ = yolo_n
    tp = tyolo.init_yolov5(torch.Generator().manual_seed(0), tyolo.YoloConfig("yolov5n", 80))
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = jax.tree_util.tree_leaves_with_path(tp)
    assert [str(p) for p, _ in jl] == [str(p) for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        s = a.shape
        assert tuple(b.shape) == ((s[3], s[2], s[0], s[1]) if len(s) == 4 else s)


@pytest.mark.parametrize("n_det", [5, 15])
def test_detect_tail_keeps_classes_order_equal(yolo_n, images_and_heads, n_det):
    """The port's tail, fed JAX's heads, keeps the same detections in the
    same order with the same classes as JAX's fused tail."""
    cfg, _, _ = yolo_n
    _, jh = images_and_heads
    conf = calibrated_conf(np.asarray(jyolo.decode_predictions(jh, cfg)["scores"]), 3 * n_det)
    jout = jdet.fused_detect_tail(jh, cfg, conf_thres=conf, iou_thres=0.45, max_det=50)
    tout = tdet.fused_detect_tail([torch.from_numpy(np.asarray(h)) for h in jh], tyolo.YoloConfig("yolov5n", 80),
                                  conf_thres=conf, iou_thres=0.45, max_det=50)
    assert np.asarray(jout["valid"]).sum() > 0
    np.testing.assert_array_equal(tout["valid"].numpy(), np.asarray(jout["valid"]))
    np.testing.assert_array_equal(tout["classes"].numpy(), np.asarray(jout["classes"]))
    np.testing.assert_allclose(tout["boxes"].numpy(), np.asarray(jout["boxes"]), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(tout["scores"].numpy(), np.asarray(jout["scores"]), rtol=1e-6, atol=1e-7)


def test_batched_nms_matches(yolo_n):
    rng = np.random.default_rng(6)
    b, n = 2, 200
    xy = rng.uniform(0, 100, (b, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (b, n, 2))], -1).astype(np.float32)
    scores = rng.random((b, n)).astype(np.float32)
    classes = rng.integers(0, 3, (b, n)).astype(np.int32)
    j = j_batched_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), max_det=40, pre_nms_topk=128)
    t = t_batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(classes),
                      max_det=40, pre_nms_topk=128)
    for key in ("valid", "classes", "boxes", "scores"):
        np.testing.assert_array_equal(t[key].numpy(), np.asarray(j[key]))


def test_exact_topk_tie_rule():
    x = np.asarray([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5]], np.float32)
    jv, ji = jdet.exact_topk(jnp.asarray(x), 4, groups=2)
    tv, ti = stable_topk(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_reid_embeddings_match():
    jp, js = jax.jit(jreid.init_reid)(jax.random.PRNGKey(1))
    # non-trivial running stats so BN is exercised
    rng = np.random.default_rng(7)
    js = jax.tree.map(lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape).astype(np.float32)), js)
    tp, ts = reid_params_from_jax(_np(jp), _np(js))
    crops = rng.standard_normal((5, 50, 50, 3)).astype(np.float32)
    j = jreid.reid_embed(jp, js, jnp.asarray(crops))
    t = treid.reid_embed(tp, ts, torch.from_numpy(crops))
    assert t.shape == (5, 512)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4)
