"""The plain reference agrees with the port at small sizes on the CPU, in
float32 where the port has the option, stage by stage and for the tracker
over frames that carry state."""

import json
import os

import numpy as np
import pytest
import torch

from cellbench import judge, weights
from cellbench.reference import pixels as px_ref
from cellbench.reference import reid as reid_ref
from cellbench.reference import yolo as yolo_ref

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def setup():
    with open(os.path.join(HERE, "data", "tiny.json")) as f:
        cfg = json.load(f)
    g = weights.generator(7, "cpu")
    w = weights.draw(cfg, g, "cpu")
    return cfg, w, weights.frame_pool(cfg, {"frames": {"kind": "still_scene", "jitter": 12}}, g, "cpu")


def test_detector_network_and_tail(setup):
    from vehicle_counting_tpu_torch.models.detector import fused_detect_tail
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, yolov5_forward_nchw
    from vehicle_counting_tpu_torch.ops.letterbox import restore_boxes

    cfg, (yolo_w, _, _), pool = setup
    img = px_ref.network_pixels(pool[:2], cfg["net_hw"]).float() / 255.0
    ref = yolo_ref.forward(cfg, yolo_w, img)
    port = yolov5_forward_nchw(yolo_w, img)
    for a, b in zip(ref, port):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    dets = yolo_ref.detect(cfg, yolo_w, img, 0.2)
    tail = fused_detect_tail([h.permute(0, 2, 3, 1) for h in port], YoloConfig("yolov5n"), conf_thres=0.2,
                             iou_thres=cfg["iou_thres"], max_det=cfg["max_det"])
    boxes = restore_boxes(tail["boxes"], tuple(cfg["source_hw"]), tuple(cfg["net_hw"]))
    for i, (b, s, c) in enumerate(dets):
        v = tail["valid"][i]
        assert int(v.sum()) == len(s) > 0
        torch.testing.assert_close(boxes[i][v], b, rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(tail["scores"][i][v], s, rtol=1e-5, atol=1e-5)
        assert torch.equal(tail["classes"][i][v].long(), c.long())


def test_pixels_against_the_host_letterbox_and_i420(setup):
    from vehicle_counting_tpu_torch.ops.letterbox import (host_letterbox_yuv420, yuv420_content_to_full,
                                                           yuv420_to_rgb_u8_planar)

    cfg, _, pool = setup
    hw, src = tuple(cfg["net_hw"]), tuple(cfg["source_hw"])
    port = yuv420_to_rgb_u8_planar(yuv420_content_to_full(
        torch.from_numpy(host_letterbox_yuv420(pool[:2].numpy(), hw, content_only=True)), src, hw))
    ref = px_ref.network_pixels(pool[:2], hw)
    d = (port.int() - ref.int()).abs()
    assert int(d.max()) <= 3 and float((d > 1).float().mean()) < 0.02


def test_crops_and_reid(setup):
    from vehicle_counting_tpu_torch.models.reid import reid_embed
    from vehicle_counting_tpu_torch.ops.crops import gather_crops_batch_plain

    cfg, (_, reid_p, reid_s), pool = setup
    rc = cfg["reid"]
    pix = px_ref.network_pixels(pool[:2], cfg["net_hw"])
    boxes = torch.tensor([[3.7, 5.2, 60.9, 80.1], [40.0, 20.5, 41.0, 22.0], [-3.0, 10.0, 127.9, 95.5]])
    fidx = torch.tensor([0, 1, 1])
    ref = px_ref.crops(pix, fidx, boxes, rc["crop_hw"], rc["mean"], rc["std"])
    port = gather_crops_batch_plain(pix, fidx, boxes, torch.ones(3, dtype=torch.bool))
    torch.testing.assert_close(ref, port.permute(0, 3, 1, 2), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(reid_ref.embed(rc, reid_p, reid_s, ref), reid_embed(reid_p, reid_s, port),
                               rtol=1e-4, atol=1e-5)


def _stream(rng, frames, n_obj, hw):
    """Objects moving on straight lines, a few missing in some frames:
    boxes xyxy, scores, classes, features [n, 512] per frame."""
    h, w = hw
    start = rng.uniform([50, 50], [w - 150, h - 150], size=(n_obj, 2))
    vel = rng.uniform(-4, 4, size=(n_obj, 2))
    size = rng.uniform(30, 90, size=(n_obj, 2))
    cls = rng.integers(0, 4, size=n_obj)
    feat = rng.normal(size=(n_obj, 512))
    out = []
    for t in range(frames):
        keep = rng.random(n_obj) > 0.15
        xy = start + vel * t + rng.normal(scale=1.0, size=(n_obj, 2))
        boxes = np.concatenate([xy, xy + size], 1)[keep].astype(np.float32)
        f = (feat + rng.normal(scale=0.1, size=feat.shape))[keep].astype(np.float32)
        out.append(judge.Frame(boxes, rng.uniform(0.3, 0.9, keep.sum()).astype(np.float32), cls[keep], f))
    return out


def test_tracker_over_carried_state():
    """Two batches: the port's tracker from a fresh state, then from its own
    state; the reference from fresh and then from the port's state."""
    from vehicle_counting_tpu_torch.pipeline.step import tracker_scan
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, init_states
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams

    with open(os.path.join(HERE, "data", "tiny.json")) as f:
        cfg = json.load(f)
    cfg["source_hw"] = [480, 640]
    tc = cfg["tracker"]
    hp = DeepSortParams(TrackerParams(capacity=tc["capacity"], budget=tc["budget"], max_dist=tc["max_dist"],
                                      max_age=tc["max_age"], n_init=tc["n_init"], feat_dtype=tc["feat_dtype"]),
                        num_classes=tc["num_classes"])
    frames = _stream(np.random.default_rng(3), 24, 10, cfg["source_hw"])
    n = max(len(f.scores) for f in frames)

    def det_of(batch):
        pad = lambda a, shape, v=0: np.stack([np.pad(x, [(0, n - len(x))] + [(0, 0)] * (x.ndim - 1),  # noqa: E731
                                                     constant_values=v) for x in a])
        return ({"boxes": torch.from_numpy(pad([f.boxes for f in batch], None)),
                 "scores": torch.from_numpy(pad([f.scores for f in batch], None)),
                 "classes": torch.from_numpy(pad([f.classes for f in batch], None, -1)).int(),
                 "valid": torch.from_numpy(pad([np.ones(len(f.scores), bool) for f in batch], None))},
                torch.from_numpy(pad([f.feats for f in batch], None)))

    states = init_states(hp, "cpu")
    state0 = None
    rows = 0
    for batch in (frames[:12], frames[12:]):
        det, feats = det_of(batch)
        start = None if state0 is None else {k: v.copy() for k, v in state0.items()}
        states, outs = tracker_scan(states, det, feats, hp=hp, src_hw=tuple(cfg["source_hw"]))
        state1 = {f: getattr(states, f).float().numpy() if getattr(states, f).dtype == torch.bfloat16
                  else getattr(states, f).numpy().copy() for f in judge.STATE_FIELDS}
        prog = judge.program_tracks(outs.mask.numpy(), outs.ids.numpy(), outs.boxes.numpy(), state1)
        ref = judge.run_tracker(cfg, start, judge.program_frames(det, feats))
        assert judge.track_numbers(prog, ref)[0] == 0
        rows += judge.track_numbers(prog, ref)[1]
        state0 = state1
    assert rows > 50


def test_a_near_tie_cuts_its_class_from_the_comparison():
    """Two detections at the same cost from one confirmed track: the
    reference notes a near-tie, and the rows of that class from that frame
    on, and its end state, are left out of the comparison."""
    from cellbench.reference import deepsort as ds_ref

    with open(os.path.join(HERE, "data", "tiny.json")) as f:
        tc = json.load(f)["tracker"]
    tr = ds_ref.DeepSort(tc, tie_eps=judge.TIE_EPS)
    box = np.array([[100.0, 100.0, 140.0, 260.0]])
    feat = np.eye(1, 8, dtype=np.float32)
    for _ in range(tc["n_init"]):
        tr.update(box, np.array([0.9]), feat, (480, 640))
        assert not tr.near_tie
    # one detection 12 pixels to the left, one as far to the right (apart enough
    # for the NMS, both within the gate), both with the track's feature
    two = np.array([[88.0, 100.0, 128.0, 260.0], [112.0, 100.0, 152.0, 260.0]])
    tr.update(two, np.array([0.9, 0.8]), np.repeat(feat, 2, 0), (480, 640))
    assert tr.near_tie

    ref_rows = [{(0, 1): (1, 1, 1, 1), (1, 2): (5, 5, 5, 5)}, {(0, 1): (1, 1, 1, 1), (1, 2): (5, 5, 5, 5)}]
    prog_rows = [{(0, 1): (1, 1, 1, 1), (1, 2): (5, 5, 5, 5)}, {(0, 1): (1, 1, 1, 1), (1, 3): (5, 5, 5, 5)}]
    end = {(0, 1): (2, 5, 5, 0), (1, 2): (2, 5, 5, 0)}
    boxes = {k: np.zeros(4) for k in end}
    # class 1 cut at frame 1: its frame-1 rows and its end state are not compared
    diff, total, _, every = judge.track_numbers((prog_rows, end, boxes), (ref_rows, dict(end), boxes, [2, 1]))
    assert (diff, total, every) == (0, 4, 7)
    diff, total, _, _ = judge.track_numbers((prog_rows, end, boxes), (ref_rows, dict(end), boxes, [2, 2]))
    assert (diff, total) == (2, 7)
    # past the cut, the age of a track live at the batch's start is still
    # compared: a state the step left unchanged has not aged
    stale = dict(end)
    stale[(1, 2)] = (2, 5, 3, 0)
    diff, total, _, _ = judge.track_numbers((prog_rows, stale, boxes), (ref_rows, dict(end), boxes, [2, 1]),
                                            old={(1, 2)})
    assert (diff, total) == (1, 5)
