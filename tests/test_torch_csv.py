"""The CSV gate: the JAX `CountingPipeline.run_video` and the port's on the
same seeded checkpoints (a pickled ultralytics-style .pt and a ReID .t7),
the same synthetic video and zone, in f32 on the CPU.

The rows must be equal field by field. `color` is left out (a display
artifact). Box coordinates and the first/last points derived from them
are compared at atol 1e-3 px: both packages run the same f32 arithmetic,
but XLA and PyTorch sum the convolutions in different orders, which moves
a box by ~1e-5 px; every discrete field (track id, frame id, label,
direction, first/last frame) must be exactly equal."""

import ast
import json
import os
import sys
import types

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

import jax  # noqa: F401  (JAX and PyTorch in one process: both at the top)

sys.path.insert(0, os.path.dirname(__file__))
from test_convert_ultralytics import _build_fake_checkpoint
from test_reid import TorchReidNet

import vehicle_counting_tpu.configs as jcfg
import vehicle_counting_tpu_torch.configs as pcfg
from vehicle_counting_tpu.pipeline import CountingPipeline as JaxPipeline
from vehicle_counting_tpu_torch.pipeline import CountingPipeline as PortPipeline
from vehicle_counting_tpu_torch.testing import one_torch_thread

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

H, W, N_FRAMES = 240, 320, 16
BOX_ATOL = 1e-3


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(yolo .pt, reid .t7, video, zone dir): a textured static video, so
    the seeded weights' detections repeat and tracks confirm."""
    tmp = tmp_path_factory.mktemp("csv_gate")
    yolo_pt, _ = _build_fake_checkpoint(tmp, np.random.default_rng(1702))
    torch.manual_seed(7)
    net = TorchReidNet()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm1d)):
                m.running_mean.normal_(0, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    reid_t7 = str(tmp / "ckpt.t7")
    torch.save({"net_dict": net.state_dict(), "acc": 0.5, "epoch": 3}, reid_t7)

    path = str(tmp / "cam_gate.mp4")
    img = cv2.GaussianBlur(np.random.default_rng(3).integers(0, 255, size=(H, W, 3), dtype=np.uint8), (7, 7), 3)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (W, H))
    for _ in range(N_FRAMES):
        writer.write(img)
    writer.release()
    zone = {"shapes": [
        {"label": "zone", "points": [[-5, -5], [W + 5, -5], [W + 5, H + 5], [-5, H + 5]]},
        {"label": "direction01", "points": [[0, H // 2], [W, H // 2]]},
        {"label": "direction02", "points": [[W, H // 2], [0, H // 2]]},
    ]}
    (tmp / "zones").mkdir()
    (tmp / "zones" / "cam_gate.json").write_text(json.dumps(zone))
    return yolo_pt, reid_t7, path, str(tmp / "zones")


def _run(pipeline_cls, cfg_mod, world, out_dir, device=None):
    yolo_pt, reid_t7, video, zones = world
    cfg = cfg_mod.config_from_dict(cfg_mod.default_config(), {
        "detect_batch": 8, "max_tracks_per_class": 16, "image_size": [192, 192],
        "model_name": "yolov5n", "min_conf": 1e-4, "max_det": 8, "compute_dtype": "float32",
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
    return pipe, result, pd.read_csv(result["csv"])


@pytest.fixture(scope="module")
def both(world, tmp_path_factory):
    out = tmp_path_factory.mktemp("out")
    return _run(JaxPipeline, jcfg, world, out / "jax"), _run(PortPipeline, pcfg, world, out / "port", "cpu")


def test_loaded_weights_are_what_runs(both):
    (jp, _, _), (pp, _, _) = both
    assert pp.num_classes == jp.num_classes == 4  # nc from the head's bias; nc <= 8 -> identity class map
    np.testing.assert_array_equal(pp.yolo_params["0"]["w"].numpy(),
                                  np.transpose(np.asarray(jp.yolo_params["0"]["w"]), (3, 2, 0, 1)))
    np.testing.assert_array_equal(pp.reid_stats["layer4_1"]["bn2"]["var"].numpy(),
                                  np.asarray(jp.reid_stats["layer4_1"]["bn2"]["var"]))


def test_csv_rows_equal_field_by_field(both):
    (_, jres, jdf), (_, pres, pdf) = both
    assert list(pdf.columns) == list(jdf.columns) == [
        "track_id", "frame_id", "box", "color", "label", "direction", "fpoint", "lpoint", "fframe", "lframe"]
    assert len(jdf) > 0, "the gate needs rows: static frames must give confirmed tracks"
    assert len(pdf) == len(jdf)
    assert jdf.track_id.nunique() >= 2
    assert pres["frames"] == jres["frames"] == N_FRAMES
    for col in ("track_id", "frame_id", "label", "direction", "fframe", "lframe"):
        assert pdf[col].tolist() == jdf[col].tolist(), col
    for col in ("box", "fpoint", "lpoint"):  # float fields, atol 1e-3 px
        got = np.asarray([ast.literal_eval(v) for v in pdf[col]], np.float64)
        want = np.asarray([ast.literal_eval(v) for v in jdf[col]], np.float64)
        np.testing.assert_allclose(got, want, rtol=0, atol=BOX_ATOL, err_msg=col)


def test_counts_equal(both):
    (_, jres, _), (_, pres, _) = both
    assert sorted(pres["counts"]) == sorted(jres["counts"])
    for k, v in jres["counts"].items():
        assert list(pres["counts"][k]) == list(v)
