"""The port's pipeline: the full-I420 upload branch of the step against JAX,
and `CountingPipeline.run_video` end to end on a synthetic video (a
bright-region detector stands in for the random-init network; tracking,
counting, CSV and the annotated MP4 run for real)."""

import json
import os
import types

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

from test_torch_slice import run_both
from vehicle_counting_tpu.configs import Config, config_from_dict, default_cam_config, default_config
from vehicle_counting_tpu_torch import run as cli
from vehicle_counting_tpu_torch.ops.letterbox import (
    letterbox_params,
    restore_boxes,
    yuv420_content_to_full,
    yuv420_to_rgb_u8_planar,
)
from vehicle_counting_tpu_torch.pipeline import CountingPipeline
from vehicle_counting_tpu_torch.pipeline import step as step_mod
from vehicle_counting_tpu_torch.tracking.deepsort import embed_detections_batch
from vehicle_counting_tpu_torch.testing import one_torch_thread

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

W, H, N_FRAMES = 320, 240, 40


def test_slice_matches_jax_full_upload():
    """88x160 -> 96x128: the content-only upload is not exact there, so the
    host ships the full letterboxed I420 frame."""
    exact, _ = run_both((88, 160), 1, seed=1)
    assert not exact


def fake_pipeline_batch_step(yolo_params, reid_params, reid_stats, states, frames, frame_valid,
                             class_lut, *, ycfg, hp, image_size, src_hw, conf_thres, iou_thres,
                             max_det, dtype, frames_format):
    """Bright-region 'detector' on the uploaded I420 + the port's real
    crop/ReID/tracking stack."""
    if frames.shape[1] != image_size[0] * 3 // 2:
        frames = yuv420_content_to_full(frames, src_hw, image_size)
    rgb = yuv420_to_rgb_u8_planar(frames)
    b = rgb.shape[0]
    boxes = torch.zeros((b, max_det, 4))
    scores = torch.zeros((b, max_det))
    classes = torch.full((b, max_det), -1, dtype=torch.int32)
    valid = torch.zeros((b, max_det), dtype=torch.bool)
    for i in range(b):
        ys, xs = torch.nonzero(rgb[i, 0] > 200, as_tuple=True)
        if frame_valid[i] and xs.numel() > 10:
            lb = torch.tensor([[xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]], dtype=torch.float32)
            boxes[i, 0] = restore_boxes(lb, src_hw, image_size)[0]
            scores[i, 0] = 0.9
            classes[i, 0] = 1  # "car"
            valid[i, 0] = True
    gain, pad_x, pad_y, _, _ = letterbox_params(src_hw, image_size)
    feats = embed_detections_batch(rgb, boxes, valid, reid_params, reid_stats, hp,
                                   crop_gain=gain, crop_pad=(pad_x, pad_y), dtype=dtype)
    det = {"boxes": boxes, "scores": scores, "classes": classes, "valid": valid}
    states, outs = step_mod.tracker_scan(states, det, feats, hp=hp, src_hw=src_hw)
    return states, det, outs


def _synthetic_video(tmp_path):
    path = str(tmp_path / "cam_t1.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 20.0, (W, H))
    for t in range(N_FRAMES):
        img = np.zeros((H, W, 3), np.uint8)
        x = 10 + t * 7
        cv2.rectangle(img, (x, 100), (x + 40, 130), (255, 255, 255), -1)
        writer.write(img)
    writer.release()
    zone = {"shapes": [
        {"label": "zone", "points": [[60, 60], [260, 60], [260, 180], [60, 180]]},
        {"label": "direction01", "points": [[60, 115], [260, 115]]},
        {"label": "direction02", "points": [[260, 115], [60, 115]]},
    ]}
    (tmp_path / "zones").mkdir()
    (tmp_path / "zones" / "cam_t1.json").write_text(json.dumps(zone))
    return path, str(tmp_path / "zones")


def test_run_video_end_to_end(tmp_path, monkeypatch, capsys):
    video_path, zone_dir = _synthetic_video(tmp_path)
    monkeypatch.setattr(step_mod, "pipeline_batch_step", fake_pipeline_batch_step)
    cfg = config_from_dict(default_config(), {
        "detect_batch": 8, "max_tracks_per_class": 16, "image_size": [160, 160],
        "model_name": "yolov5n", "compute_dtype": "float32",
    })
    cam = default_cam_config().to_dict()
    cam["zone_path"] = zone_dir
    out_dir = str(tmp_path / "out")
    args = types.SimpleNamespace(
        weight=None, input_path=video_path, output_path=out_dir, device="cpu",
        mapping_dict={0: 0, 1: 0, 2: 1, 3: 0, 5: 2, 7: 3}, debug=True,
    )
    pipe = CountingPipeline(args, cfg, Config(_settings=cam))
    result = pipe.run_video(video_path, visualize=True)

    df = pd.read_csv(result["csv"])
    assert list(df.columns) == [
        "track_id", "frame_id", "box", "color", "label", "direction",
        "fpoint", "lpoint", "fframe", "lframe",
    ]
    assert len(df) > 10
    assert (df.track_id == 1).all()          # a single continuous track
    assert (df.label == 1).all()             # class 'car'
    assert df.frame_id.is_monotonic_increasing
    counts = result["counts"]
    assert counts["01"][1] == 1              # moved east, counted once
    assert sum(sum(v) for v in counts.values()) == 1
    cap = cv2.VideoCapture(os.path.join(out_dir, "cam_t1.mp4"))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == N_FRAMES
    cap.release()
    for stage in ("decode", "letterbox", "upload", "dispatch", "readback", "count", "visualize"):
        assert pipe.last_timer.counts.get(stage, 0) > 0
    # --debug also lists the spans recorded inside the stages: the tracker's
    # layer (this step is a stand-in) and the host feed's
    out = capsys.readouterr().out
    listed = out.split("spans (total, mean, count, self):\n", 1)[1].splitlines()
    names = {ln.split(":")[0] for ln in listed if " total, " in ln}
    assert {"dispatch", "track", "track.inputs", "track.scan", "feed.letterbox", "feed.upload"} <= names


def test_cli_mapping_parse():
    assert cli._mapping_dict(None) is None
    assert cli._mapping_dict("coco")[2] == 1
    assert cli._mapping_dict('{"7": 0, "2": 3}') == {7: 0, 2: 3}
