"""PyTorch port, the detect-only path: `detect_only_step` (thin I420 upload),
`detect_step` and the `Detector` facade (raw frames, device letterbox), the
detections CSV of `CountingPipeline.run_video_detect_only` and the CLI's
`--detect_only`, each against the JAX package at f32 on the CPU: `valid`,
classes, labels and rows equal; boxes atol 1e-3 px (XLA and PyTorch sum
the convolutions in different orders), scores atol 1e-5."""

import types

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_csv import N_FRAMES, world  # noqa: F401  (world: the CSV gate's module fixture)
from test_torch_inputs import _calibrate, _raw_batches
from test_torch_slice import B, calibrate, make_batches, make_models
import vehicle_counting_tpu.configs as jcfg
import vehicle_counting_tpu_torch.configs as pcfg
from vehicle_counting_tpu.models.detector import Detector as JDetector
from vehicle_counting_tpu.models.detector import detect_step as j_detect_step
from vehicle_counting_tpu.pipeline import CountingPipeline as JaxPipeline
from vehicle_counting_tpu.pipeline.step import detect_only_step as j_detect_only
from vehicle_counting_tpu_torch import run as cli
from vehicle_counting_tpu_torch.models.detector import Detector, detect_step
from vehicle_counting_tpu_torch.models.yolo import YoloConfig
from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw, letterbox
from vehicle_counting_tpu_torch.pipeline import CountingPipeline as PortPipeline
from vehicle_counting_tpu_torch.pipeline.step import detect_only_step
from vehicle_counting_tpu_torch.testing import one_torch_thread

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

BOX_ATOL, SCORE_ATOL = 1e-3, 1e-5
COLUMNS = ["frame_id", "x1", "y1", "x2", "y2", "score", "label"]


def _assert_detections_equal(got, want):
    """Port (torch) against JAX (arrays): valid and classes equal, boxes
    and scores to tolerance, zero boxes where invalid."""
    valid = np.asarray(want["valid"])
    assert valid.sum() > 0
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0, atol=SCORE_ATOL)
    assert not got["boxes"].numpy()[~valid].any()


@pytest.mark.parametrize("src_hw", [(72, 128), (88, 160)], ids=["content_rows", "full_i420"])
def test_detect_only_step_matches_jax(src_hw):
    """The I420 upload with the content rows only (72x128 -> 96x128, exact
    there) and the full letterbox (88x160, where it is not)."""
    jcfg_y, (yp, _, _), (tp, _, _) = make_models()
    net, exact, batches = make_batches(src_hw, 1, seed=0 if src_hw == (72, 128) else 1)
    assert exact == (src_hw == (72, 128))
    conf, _ = calibrate(tp, batches, src_hw, net)
    kw = dict(image_size=net, src_hw=src_hw, conf_thres=conf, iou_thres=0.45, max_det=100)
    want = j_detect_only(yp, jnp.asarray(batches[0]), ycfg=jcfg_y, dtype=jnp.float32, content_only=exact, **kw)
    with torch.no_grad():
        got = detect_only_step(tp, torch.from_numpy(batches[0]), ycfg=YoloConfig("yolov5n", 80), dtype=torch.float32,
                               content_only=exact, **kw)
    _assert_detections_equal(got, want)


def _raw_setup():
    src_hw = (72, 128)
    net = autoshape_hw(src_hw, 128)
    jcfg_y, (yp, _, _), (tp, _, _) = make_models()
    frames = _raw_batches(src_hw, 1, seed=1)[0]
    conf, _ = _calibrate(tp, [letterbox(torch.from_numpy(frames), net).permute(0, 3, 1, 2)])
    return src_hw, net, jcfg_y, yp, tp, frames, conf


def test_detect_step_matches_jax():
    """Raw [B, H, W, 3] frames, letterboxed on the device."""
    src_hw, net, jcfg_y, yp, tp, frames, conf = _raw_setup()
    kw = dict(image_size=net, src_hw=src_hw, conf_thres=conf, iou_thres=0.45, max_det=100)
    want = j_detect_step(yp, jnp.asarray(frames), cfg=jcfg_y, dtype=jnp.float32, **kw)
    with torch.no_grad():
        got = detect_step(tp, torch.from_numpy(frames), cfg=YoloConfig("yolov5n", 80), dtype=torch.float32, **kw)
    _assert_detections_equal(got, want)


@pytest.mark.parametrize("mapped", [False, True], ids=["identity", "mapped"])
def test_detector_run_matches_jax(mapped):
    """`Detector.run`: the reference's per-image output contract (tlwh
    boxes, classes after the mapping, scores), port against JAX on the
    same weights (the JAX detector's seed-0 init, carried across); the
    mapping keeps two of the detected classes (as 1 and 0) and drops the
    rest."""
    src_hw, net, _, _, tp, frames, conf = _raw_setup()
    over = {"model_name": "yolov5n", "image_size": [128, 128], "compute_dtype": "float32", "min_conf": conf,
            "max_det": 100}
    mapping = None
    if mapped:
        seen = JDetector(jcfg.config_from_dict(jcfg.default_config(), over), num_classes=80).detect_batch(frames)
        common = pd.Series(seen["classes"][seen["valid"]]).value_counts().index[:2]
        mapping = {int(common[0]): 1, int(common[1]): 0}
    jdet = JDetector(jcfg.config_from_dict(jcfg.default_config(), over), mapping_dict=mapping, num_classes=80)
    tdet = Detector(pcfg.config_from_dict(pcfg.default_config(), over), mapping_dict=mapping, num_classes=80,
                    device="cpu")
    tdet.params = tp  # the JAX detector's weights (make_models: the same seed-0 init)
    assert tdet.net_hw(src_hw) == jdet.net_hw(src_hw) == net
    got, want = tdet.run(frames), jdet.run(frames)
    assert len(got) == len(want) == B
    n = 0
    if mapped:
        assert set(np.concatenate([w["classes"] for w in want]).tolist()) == {0, 1}
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["classes"], w["classes"])
        np.testing.assert_allclose(g["bboxes"], w["bboxes"], rtol=0, atol=BOX_ATOL)
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=SCORE_ATOL)
        n += len(w["classes"])
    assert n > 0


def _detect_only_pipeline(pipeline_cls, cfg_mod, world, out_dir, device=None):
    yolo_pt, reid_t7, video, zones = world
    cfg = cfg_mod.config_from_dict(cfg_mod.default_config(), {
        "detect_batch": 8, "image_size": [192, 192], "model_name": "yolov5n", "min_conf": 1e-4, "max_det": 8,
        "compute_dtype": "float32",
    })
    cam = cfg_mod.default_cam_config().to_dict()
    cam["zone_path"] = zones
    cam["checkpoint"] = reid_t7
    args = types.SimpleNamespace(weight=yolo_pt, input_path=video, output_path=str(out_dir), debug=False,
                                 detect_only=True, mapping=None, no_visualize=True, multicam=False,
                                 frame_parallel=False)
    if device:
        args.device = device
    return args, cfg, cfg_mod.Config(_settings=cam)


def _assert_csv_equal(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns) == COLUMNS
    assert len(want) > 0 and len(got) == len(want)
    for col in ("frame_id", "label"):
        assert got[col].tolist() == want[col].tolist(), col
    np.testing.assert_allclose(got[["x1", "y1", "x2", "y2"]].to_numpy(), want[["x1", "y1", "x2", "y2"]].to_numpy(),
                               rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose(got["score"].to_numpy(), want["score"].to_numpy(), rtol=0, atol=SCORE_ATOL)


def test_detections_csv_matches_jax(world, tmp_path):  # noqa: F811
    """`run_video_detect_only` on the CSV gate's world (seeded .pt, 16
    frames of 320x240): rows, frame ids and labels equal, in JAX's order."""
    args, cfg, cam = _detect_only_pipeline(JaxPipeline, jcfg, world, tmp_path / "jax")
    jres = JaxPipeline(args, cfg, cam).run_video_detect_only(args.input_path)
    args, cfg, cam = _detect_only_pipeline(PortPipeline, pcfg, world, tmp_path / "port", "cpu")
    pipe = PortPipeline(args, cfg, cam)
    pres = pipe.run_video_detect_only(args.input_path)
    assert pres["frames"] == jres["frames"] == N_FRAMES == pipe.frames_done
    assert pres["csv"].endswith("cam_gate_detections.csv")
    want = pd.read_csv(jres["csv"])
    _assert_csv_equal(pd.read_csv(pres["csv"]), want)
    assert want.frame_id.nunique() == N_FRAMES


def test_cli_detect_only_writes_the_csv(world, tmp_path, capsys):  # noqa: F811
    """`run --detect_only` writes the detections CSV of the pipeline's pass
    and prints the JAX CLI's line; `--multicam --detect_only` is refused
    with the JAX CLI's message."""
    args, cfg, cam = _detect_only_pipeline(PortPipeline, pcfg, world, tmp_path / "cli", "cpu")
    parsed = cli.parser.parse_args(["--input_path", args.input_path, "--output_path", args.output_path,
                                    "--device", "cpu", "--weight", args.weight, "--detect_only"])
    (res,) = cli.main(parsed, cfg, cam)
    assert f"{res['csv']}: {N_FRAMES} frames @ " in capsys.readouterr().out
    args.output_path = str(tmp_path / "direct")
    direct = PortPipeline(args, cfg, cam).run_video_detect_only(args.input_path)
    assert direct["csv"] != res["csv"]
    pd.testing.assert_frame_equal(pd.read_csv(res["csv"]), pd.read_csv(direct["csv"]))
    both = cli.parser.parse_args(["--input_path", "v.mp4", "--output_path", str(tmp_path), "--multicam",
                                  "--detect_only"])
    with pytest.raises(SystemExit, match="--multicam is incompatible with --detect_only"):
        cli.main(both, None, None)
