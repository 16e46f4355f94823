"""The port's P6 detector (YOLOv5 v6.0 `hub/yolov5s6.yaml`: four Detect
scales at strides 8/16/32/64) against the benchmark's plain reference,
`cellbench/reference/yolo.py`, which builds the network from the yaml's
layer table. On the CPU at f32 with TF32 off, on seeded random weights:
the table at a sixteenth of yolov5s6's widths (`p6-tiny.json`), 4 frames of
128x128. Then the normal path with `model_name: yolov5s6` and no weights,
a P6 checkpoint through the converter, and the P5 graph of the shared
init and forward against the fixed P5 graph they replaced, bitwise.

No test here reaches the network: the pipeline's weight fetch is refused."""

import json
import math
import os
import types
import urllib.request

import cv2
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cellbench import run as cell_run
from cellbench import weights as cell_weights
from cellbench.reference import yolo as yolo_ref
from vehicle_counting_tpu_torch.configs import Config, config_from_dict, default_cam_config, default_config
from vehicle_counting_tpu_torch.models import yolo
from vehicle_counting_tpu_torch.models.convert import checkpoint_anchors, load_yolov5_weights
from vehicle_counting_tpu_torch.models.detector import Detector, fused_detect_tail
from vehicle_counting_tpu_torch.models.layers import conv_block_nchw, upsample2x_nearest_nchw
from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw
from vehicle_counting_tpu_torch.testing import fake_yolov5_state_dict, one_torch_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "cellbench", "tests", "data", "p6-tiny.json")) as _f:
    P6 = json.load(_f)  # the v6.0 yolov5s6 table at width 0.0625
TINY = "yolov5s6-sixteenth"  # the port's name for that width, registered per test
B, HW = 4, (128, 128)
# f32 on both sides, the same convolutions in the same order: only oneDNN's
# choice of algorithm per call may round apart. A bf16 network misses these
# by 27x or more at every head (checked in the test); here they agree bit for bit.
HEAD_RTOL, HEAD_ATOL = 1e-5, 1e-6
BOX_ATOL_PX = 1e-3  # the port's x1 + w against the reference's x + w / 2: an ulp at ~1000 px

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


@pytest.fixture(autouse=True)
def _f32():
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


@pytest.fixture
def tiny(monkeypatch):
    """The port's config of the sixteenth-width table: yolov5s6's depth,
    the table's width, the P6 anchors and strides."""
    monkeypatch.setitem(yolo.VARIANTS, TINY, (P6["depth_multiple"], P6["width_multiple"]))
    return yolo.YoloConfig(TINY, P6["nc"], yolo.P6_ANCHORS, yolo.P6_STRIDES)


def _ref_weights(seed=3):
    return cell_weights.draw(P6, cell_weights.generator(seed, "cpu"), "cpu")[0]


def _images(seed=11):
    return torch.rand((B, 3) + HW, generator=torch.Generator().manual_seed(seed))


def test_default_config_gives_a_variant_its_own_anchors_and_strides():
    s6 = yolo.default_config("yolov5s6", 4)
    assert (s6.strides, s6.num_classes, s6.na) == ((8, 16, 32, 64), 4, 3)
    assert [list(sum(a, ())) for a in s6.anchors] == P6["anchors"]
    assert yolo.default_config("yolov5s") == yolo.YoloConfig("yolov5s", 80)
    for n in "nsmlx":
        assert yolo.VARIANTS[f"yolov5{n}6"] == yolo.VARIANTS[f"yolov5{n}"]
    with pytest.raises(KeyError):
        yolo.default_config("yolov5q6")


@pytest.mark.parametrize("width", ["sixteenth", "yolov5s6"])
def test_the_p6_tree_is_the_tables_leaf_by_leaf(width, tiny):
    """The port's tree against `conv_shapes` of the table (the harness's
    own check), at the sixteenth width and at yolov5s6's published one."""
    if width == "sixteenth":
        cfg, table = tiny, P6
    else:
        cfg, table = yolo.default_config("yolov5s6"), dict(P6, width_multiple=0.5)
    tree = yolo.init_yolov5(torch.Generator().manual_seed(0), cfg)
    assert cell_run._tree_difference(yolo_ref.conv_shapes(table), tree, "layer") is None
    assert list(tree)[-1] == yolo.detect_key(tree) == "33" and len(tree["33"]["m"]) == 4
    if width == "yolov5s6":
        assert sum(leaf.numel() for leaf in _leaves(tree)) == 12_612_508  # 12.61 M, as published


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_the_p6_heads_are_the_references(tiny):
    w = _ref_weights()
    x = _images()
    with torch.no_grad():
        ref = yolo_ref.forward(P6, w, x)
        port = yolo.yolov5_forward_nchw(w, x)
        bf16 = yolo.yolov5_forward_nchw(yolo.cast_params(w, torch.bfloat16), x.to(torch.bfloat16))
    assert [tuple(h.shape) for h in port] == [(B, 255, 16, 16), (B, 255, 8, 8), (B, 255, 4, 4), (B, 255, 2, 2)]
    for p, r, lo in zip(port, ref, bf16):
        torch.testing.assert_close(p, r, rtol=HEAD_RTOL, atol=HEAD_ATOL)
        with pytest.raises(AssertionError):  # the tolerance tells f32 from bf16
            torch.testing.assert_close(lo.float(), r, rtol=HEAD_RTOL, atol=HEAD_ATOL)


def _port_tail(heads, cfg, conf):
    nhwc = [h.permute(0, 2, 3, 1) for h in heads]
    return fused_detect_tail(nhwc, cfg, conf_thres=conf, iou_thres=P6["iou_thres"], max_det=P6["max_det"],
                             pre_nms_topk=P6["pre_nms_topk"])


def _assert_same_detections(out, ref):
    for i, (bx, sc, cl) in enumerate(ref):
        n = int(out["valid"][i].sum())
        assert n == len(sc) and not out["valid"][i, n:].any()
        assert torch.equal(out["classes"][i, :n].long(), cl.long())
        torch.testing.assert_close(out["scores"][i, :n], sc, rtol=0, atol=1e-6)
        torch.testing.assert_close(out["boxes"][i, :n], bx, rtol=0, atol=BOX_ATOL_PX)


def test_the_p6_tail_is_the_references_decode_and_nms(tiny):
    """The port's fused tail on the four heads against the reference's
    decode + NMS. Random weights score the deep scales alike, so each
    scale's objectness bias is raised by its index: the ~300 candidates a
    frame above the threshold come from all four scales, and the NMS keeps
    about half of them."""
    w = _ref_weights()
    for j, m in enumerate(w["33"]["m"]):
        m["b"][4::P6["nc"] + 5] = float(j)
    with torch.no_grad():
        heads = yolo.yolov5_forward_nchw(w, _images())
    dec = yolo_ref.decode(P6, heads)
    conf = float(torch.sort(dec["scores"], dim=1, descending=True).values[:, 300].min())
    ref = yolo_ref.nms(dec, conf, P6["iou_thres"], P6["max_det"], P6["pre_nms_topk"])
    kept = torch.cat([torch.nonzero(dec["scores"][i][:, None] == s[None, :])[:, 0] for i, (_, s, _) in enumerate(ref)])
    assert set(np.digitize(kept.numpy(), [768, 960, 1008]).tolist()) == {0, 1, 2, 3}  # anchors of every scale
    _assert_same_detections(_port_tail(heads, tiny, conf), ref)


def test_one_box_at_the_stride_64_scale(tiny):
    """Zero logits everywhere but one anchor of the P6 head: cell (row 1,
    column 0), anchor 2 (925 x 792), offsets at sigmoid 0.75, sizes at
    sigmoid 0.5, objectness 2, class 3 at 1. Every other anchor scores
    0.25, under the threshold."""
    no = P6["nc"] + 5
    heads = [torch.zeros(1, 3 * no, n, n) for n in (16, 8, 4, 2)]
    p = heads[3].view(1, 3, no, 2, 2)
    p[0, 2, 0:2, 1, 0] = math.log(3.0)
    p[0, 2, 4, 1, 0] = 2.0
    p[0, 2, 5 + 3, 1, 0] = 1.0
    out = _port_tail(heads, tiny, 0.3)
    cx, cy = (2 * 0.75 - 0.5 + 0) * 64, (2 * 0.75 - 0.5 + 1) * 64
    assert int(out["valid"].sum()) == 1 and int(out["classes"][0, 0]) == 3
    torch.testing.assert_close(out["boxes"][0, 0], torch.tensor([cx - 462.5, cy - 396.0, cx + 462.5, cy + 396.0]))
    torch.testing.assert_close(out["scores"][0, 0], torch.sigmoid(torch.tensor(2.0)) * torch.sigmoid(torch.tensor(1.0)))
    _assert_same_detections(out, yolo_ref.nms(yolo_ref.decode(P6, heads), 0.3, P6["iou_thres"], P6["max_det"],
                                              P6["pre_nms_topk"]))


def test_autoshape_pads_to_the_largest_stride():
    assert autoshape_hw((720, 1280), 1280, stride=64) == (768, 1280)
    assert autoshape_hw((720, 1280), 1280) == (736, 1280)  # 736 / 64 is not whole: stride 32 cannot feed P6
    assert autoshape_hw((720, 1280), 640) == (384, 640)


@pytest.fixture
def offline(tmp_path, monkeypatch):
    """A fresh working directory (./.cache is relative to it) and the
    weight fetch refused."""
    monkeypatch.chdir(tmp_path)

    def refuse(url, *args, **kwargs):
        raise OSError(f"no network in the tests: {url}")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)


def _counting(monkeypatch, module):
    """Heads per forward of `module`'s `yolov5_forward_nchw`, and the
    candidates the tail counted since."""
    seen = []
    real = module.yolov5_forward_nchw

    def counted(params, images):
        heads = real(params, images)
        seen.append([tuple(h.shape[-2:]) for h in heads])
        return heads

    monkeypatch.setattr(module, "yolov5_forward_nchw", counted)
    return seen, fused_detect_tail.candidates


P6_HEADS_128 = [(16, 16), (8, 8), (4, 4), (2, 2)]
P6_ANCHORS_128 = 3 * (16 * 16 + 8 * 8 + 4 * 4 + 2 * 2)  # 1020; 61,200 at 768x1280


def test_detector_runs_yolov5s6_without_weights(offline, monkeypatch):
    from vehicle_counting_tpu_torch.models import detector as det_mod

    cfg = config_from_dict(default_config(), {"model_name": "yolov5s6", "image_size": [128, 128],
                                               "compute_dtype": "float32", "max_det": 8})
    det = Detector(cfg, device="cpu")
    assert det.cfg == yolo.default_config("yolov5s6") and det.net_hw((72, 128)) == (128, 128)
    assert Detector(config_from_dict(cfg, {"image_size": [1280, 1280]}), device="cpu").net_hw((720, 1280)) == (768, 1280)
    seen, before = _counting(monkeypatch, det_mod)
    frames = np.random.default_rng(0).integers(0, 256, (2, 72, 128, 3)).astype(np.uint8)
    out = det.run(frames)
    assert len(out) == 2 and seen == [P6_HEADS_128]
    assert fused_detect_tail.candidates - before == 2 * P6_ANCHORS_128
    assert 3 * (96 * 160 + 48 * 80 + 24 * 40 + 12 * 20) == 61_200


def test_counting_pipeline_runs_yolov5s6_without_weights(offline, tmp_path, monkeypatch):
    """`CountingPipeline` with `model_name: yolov5s6`, no weight and the
    fetch refused: the random-init P6 detector on the normal step (I420
    upload, the frame graph's eager loop on the CPU), 8 frames of 72x128 in
    two batches of 4 at 128x128 (stride 64; stride 32 gives 96x128)."""
    from vehicle_counting_tpu_torch.pipeline import CountingPipeline
    from vehicle_counting_tpu_torch.pipeline import step as step_mod

    path = str(tmp_path / "cam_p6.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 20.0, (128, 72))
    for t in range(8):
        img = np.full((72, 128, 3), 40, np.uint8)
        cv2.rectangle(img, (10 + 5 * t, 20), (40 + 5 * t, 45), (255, 255, 255), -1)
        writer.write(img)
    writer.release()
    (tmp_path / "zones").mkdir()
    zone = {"shapes": [{"label": "zone", "points": [[0, 0], [127, 0], [127, 71], [0, 71]]},
                       {"label": "direction01", "points": [[0, 36], [127, 36]]}]}
    (tmp_path / "zones" / "cam_p6.json").write_text(json.dumps(zone))
    cam = default_cam_config().to_dict()
    cam["zone_path"] = str(tmp_path / "zones")
    cfg = config_from_dict(default_config(), {"model_name": "yolov5s6", "image_size": [128, 128],
                                               "compute_dtype": "float32", "detect_batch": 4, "max_det": 8,
                                               "max_tracks_per_class": 8})
    args = types.SimpleNamespace(weight=None, input_path=path, output_path=str(tmp_path / "out"), device="cpu")
    pipe = CountingPipeline(args, cfg, Config(_settings=cam))
    assert pipe.ycfg == yolo.default_config("yolov5s6") and pipe.net_hw((72, 128)) == (128, 128)
    assert len(pipe.yolo_params["33"]["m"]) == 4
    seen, before = _counting(monkeypatch, step_mod)
    result = pipe.run_video(path, visualize=False)
    assert result["frames"] == 8 and seen == [P6_HEADS_128] * 2
    assert fused_detect_tail.candidates - before == 8 * P6_ANCHORS_128


def test_counting_pipeline_builds_without_a_config(offline, tmp_path):
    """`CountingPipeline(args)` takes the package's default `Config` and
    gives the detector the default variant's own `YoloConfig`."""
    from vehicle_counting_tpu_torch.pipeline import CountingPipeline

    args = types.SimpleNamespace(weight=None, input_path=str(tmp_path), output_path=str(tmp_path / "out"),
                                 device="cpu")
    pipe = CountingPipeline(args)
    assert isinstance(pipe.config, Config) and pipe.config.model_name == default_config().model_name
    assert pipe.ycfg == yolo.default_config(default_config().model_name or "yolov5s")
    assert len(pipe.yolo_params[yolo.detect_key(pipe.yolo_params)]["m"]) == len(pipe.ycfg.strides)


@pytest.mark.parametrize("saved,named", [("yolov5n6", "yolov5n"), ("yolov5n", "yolov5n6")])
@pytest.mark.parametrize("built", ["detector", "pipeline"])
def test_weights_of_the_other_graph_are_refused_by_name(saved, named, built, offline, tmp_path):
    """Weights with four Detect scales under a P5 name (or three under a P6
    name) stop with a ValueError that names both counts, before the tail
    could index past its strides and anchors."""
    from vehicle_counting_tpu_torch.pipeline import CountingPipeline

    path = str(tmp_path / f"{saved}.npz")
    np.savez(path, **fake_yolov5_state_dict(np.random.default_rng(2), saved, 80))
    cfg = config_from_dict(default_config(), {"model_name": named, "image_size": [128, 128],
                                               "compute_dtype": "float32"})
    have, want = (4, 3) if saved.endswith("6") else (3, 4)
    with pytest.raises(ValueError, match=f"{have} Detect scales, but {named} has {want}"):
        if built == "detector":
            Detector(cfg, weights=path, device="cpu")
        else:
            args = types.SimpleNamespace(weight=path, input_path=str(tmp_path), output_path=str(tmp_path / "out"),
                                         device="cpu")
            CountingPipeline(args, cfg)


def test_a_p6_checkpoint_converts(tmp_path):
    """A state dict named and shaped like ultralytics' yolov5n6.pt
    (`model.33.*`, anchors in units of four strides) through the
    converter: the table's tree, the P6 anchors, and a `Detector` on it."""
    sd = fake_yolov5_state_dict(np.random.default_rng(2), "yolov5n6", 80)
    assert "model.33.anchors" in sd and "model.24.cv1.conv.weight" not in sd
    path = str(tmp_path / "yolov5n6.npz")
    np.savez(path, **sd)
    tree = load_yolov5_weights(path)
    table = dict(P6, depth_multiple=0.33, width_multiple=0.25)
    assert cell_run._tree_difference(yolo_ref.conv_shapes(table), tree, "layer") is None
    assert checkpoint_anchors(sd) == yolo.P6_ANCHORS
    cfg = config_from_dict(default_config(), {"model_name": "yolov5n6", "image_size": [128, 128],
                                               "compute_dtype": "float32"})
    det = Detector(cfg, weights=path, device="cpu")
    assert det.cfg == yolo.default_config("yolov5n6", 80)
    frames = np.random.default_rng(1).integers(0, 256, (1, 72, 128, 3)).astype(np.uint8)
    assert len(det.run(frames)) == 1


# ---------------------------------------------------------------------------
# the P5 graph of the shared init and forward is the fixed P5 graph they replaced
# ---------------------------------------------------------------------------

def _c3_fixed(p, x, shortcut):
    y1 = conv_block_nchw(p["cv1"], x)
    for m in p["m"]:
        h = conv_block_nchw(m["cv2"], conv_block_nchw(m["cv1"], y1))
        y1 = y1 + h if shortcut else h
    return conv_block_nchw(p["cv3"], torch.cat([y1, conv_block_nchw(p["cv2"], x)], dim=1))


def _p5_fixed(L, images):
    """The P5 forward as the port wrote it before P6: layer by layer."""
    x = conv_block_nchw(L["0"], images, stride=2, padding=2)
    x = conv_block_nchw(L["1"], x, stride=2)
    x = _c3_fixed(L["2"], x, True)
    x = conv_block_nchw(L["3"], x, stride=2)
    p3 = _c3_fixed(L["4"], x, True)
    x = conv_block_nchw(L["5"], p3, stride=2)
    p4 = _c3_fixed(L["6"], x, True)
    x = conv_block_nchw(L["7"], p4, stride=2)
    x = _c3_fixed(L["8"], x, True)
    y = conv_block_nchw(L["9"]["cv1"], x)
    m1 = F.max_pool2d(y, 5, 1, 2)
    m2 = F.max_pool2d(m1, 5, 1, 2)
    m3 = F.max_pool2d(m2, 5, 1, 2)
    p5 = conv_block_nchw(L["9"]["cv2"], torch.cat([y, m1, m2, m3], dim=1))
    t10 = conv_block_nchw(L["10"], p5)
    x = _c3_fixed(L["13"], torch.cat([upsample2x_nearest_nchw(t10), p4], dim=1), False)
    t14 = conv_block_nchw(L["14"], x)
    o3 = _c3_fixed(L["17"], torch.cat([upsample2x_nearest_nchw(t14), p3], dim=1), False)
    x = conv_block_nchw(L["18"], o3, stride=2)
    o4 = _c3_fixed(L["20"], torch.cat([x, t14], dim=1), False)
    x = conv_block_nchw(L["21"], o4, stride=2)
    o5 = _c3_fixed(L["23"], torch.cat([x, t10], dim=1), False)
    return [conv_block_nchw(m, o, act=False) for m, o in zip(L["24"]["m"], (o3, o4, o5))]


def _p5_init_fixed(gen, cfg):
    """The P5 tree as the port drew it before P6: layer by layer."""
    w, d = cfg.width, cfg.depth
    c64, c128, c256, c512, c1024 = w(64), w(128), w(256), w(512), w(1024)
    c3 = lambda cin, cout, n: yolo._init_c3(gen, cin, cout, n, None)  # noqa: E731
    conv = lambda k, cin, cout: yolo.init_conv(gen, k, cin, cout)  # noqa: E731
    L = {"0": conv(6, 3, c64), "1": conv(3, c64, c128), "2": c3(c128, c128, d(3)), "3": conv(3, c128, c256),
         "4": c3(c256, c256, d(6)), "5": conv(3, c256, c512), "6": c3(c512, c512, d(9)),
         "7": conv(3, c512, c1024), "8": c3(c1024, c1024, d(3))}
    L["9"] = {"cv1": conv(1, c1024, c1024 // 2), "cv2": conv(1, c1024 // 2 * 4, c1024)}
    L["10"] = conv(1, c1024, c512)
    L["13"] = c3(c1024, c512, d(3))
    L["14"] = conv(1, c512, c256)
    L["17"] = c3(c512, c256, d(3))
    L["18"] = conv(3, c256, c256)
    L["20"] = c3(c512, c512, d(3))
    L["21"] = conv(3, c512, c512)
    L["23"] = c3(c1024, c1024, d(3))
    L["24"] = {"m": [conv(1, c, cfg.na * cfg.no) for c in (c256, c512, c1024)]}
    return L


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    """The aten operations a region runs, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_the_p5_forward_is_bitwise_the_fixed_graphs():
    """Seeded yolov5n: `init_yolov5` draws the same tree in the same order
    (keys "0".."24"), and the forward runs the same operations in the same
    order to the same bits as the fixed P5 graph."""
    cfg = yolo.YoloConfig("yolov5n", 80)
    tree = yolo.init_yolov5(torch.Generator().manual_seed(0), cfg)
    fixed = _p5_init_fixed(torch.Generator().manual_seed(0), cfg)
    assert list(tree) == list(fixed) and all(torch.equal(a, b) for a, b in zip(_leaves(tree), _leaves(fixed)))
    x = torch.rand((2, 3, 96, 128), generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), _Ops() as new_ops:
        new = yolo.yolov5_forward_nchw(tree, x)
    with torch.no_grad(), _Ops() as old_ops:
        old = _p5_fixed(tree, x)
    assert new_ops.ops == old_ops.ops
    assert all(torch.equal(a, b) for a, b in zip(new, old)) and len(new) == 3


def test_a_p6_config_and_tree_survive_the_serving_artifact(tiny, tmp_path):
    """The artifact's record of the detector (`serving/artifact.py`: its
    config as JSON, its tree in the weights bundle) gives back the same
    four-scale config and a tree whose heads are the same bits."""
    from vehicle_counting_tpu_torch.serving import artifact

    cfg = yolo.default_config("yolov5s6", 7)
    assert artifact._ycfg_from_json(json.loads(json.dumps(artifact._ycfg_to_json(cfg)))) == cfg
    tree = yolo.init_yolov5(torch.Generator().manual_seed(4), tiny)
    path = str(tmp_path / "w.npz")
    artifact.save_weights_bundle(path, {"yolo": tree})
    back = artifact.load_weights_bundle(path)["yolo"]
    x = _images()[:1]
    with torch.no_grad():
        assert all(torch.equal(a, b) for a, b in zip(yolo.yolov5_forward_nchw(back, x),
                                                     yolo.yolov5_forward_nchw(tree, x)))
