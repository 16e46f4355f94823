"""Dry run of the port's `tools/egress_day.py` (EGRESS_RUNBOOK.md as one
command) on the byte-faithful FAKE checkpoints of
tests/test_real_weights_path.py, on the CPU, with the exit codes of
tests/test_egress_day.py: all three steps pass (convert with bit-equal
load-back; val scored against the run's own detections; parity against the
same deterministic run's CSV), a corrupted reference CSV fails, and
--strict turns skips into a failure. The JAX tool's `csv_parity` and the
port's agree on the same files."""

import os
import sys

import pandas as pd
import pytest
import torch
import yaml

sys.path.insert(0, os.path.dirname(__file__))
from test_real_weights_path import fake_weights, static_video  # noqa: F401,E402 (fixtures)

from vehicle_counting_tpu.tools import egress_day as j_egress  # noqa: E402
from vehicle_counting_tpu_torch.tools import egress_day  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six test workers at once, and
    more threads per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_configs(tmp_path, zone_dir, reid_t7):
    cfg = {"settings": {"detect_batch": 8, "max_tracks_per_class": 16, "image_size": [192, 192],
                        "model_name": "yolov5n", "min_conf": 1e-4, "max_det": 8, "compute_dtype": "float32"}}
    cam = {"settings": {"zone_path": zone_dir, "checkpoint": reid_t7, "cam": {
        "cam_rw": {"tracking_config": {"MIN_CONFIDENCE": 0.0, "N_INIT": 2, "MAX_AGE": 5}}}}}
    cfg_path, cam_path = str(tmp_path / "configs.yaml"), str(tmp_path / "cam_configs.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    with open(cam_path, "w") as f:
        yaml.safe_dump(cam, f)
    return cfg_path, cam_path


@pytest.fixture(scope="module")
def reference_csvs(fake_weights, static_video, tmp_path_factory):  # noqa: F811
    """The self-GT detections CSV and the "reference" tracking CSV, made by
    the same deterministic port pipeline the tool runs."""
    tmp = tmp_path_factory.mktemp("egress")
    yolo_pt, reid_t7 = fake_weights
    video_path, zone_dir = static_video
    cfg_path, cam_path = _write_configs(tmp, zone_dir, reid_t7)
    args = egress_day.argparse.Namespace(yolo_pt=yolo_pt, reid_t7=reid_t7, config=cfg_path, cam_config=cam_path,
                                         device="cpu")
    pre = egress_day._make_pipeline(args, str(tmp / "pre"))
    gt_csv = pre.run_video_detect_only(video_path)["csv"]
    ref_csv = pre.run_video(video_path, visualize=False)["csv"]
    assert len(pd.read_csv(gt_csv)) > 0 and len(pd.read_csv(ref_csv)) > 0
    return cfg_path, cam_path, gt_csv, ref_csv


def test_egress_day_dry_run_all_steps_pass(fake_weights, static_video, reference_csvs, tmp_path):  # noqa: F811
    yolo_pt, reid_t7 = fake_weights
    video_path, _ = static_video
    cfg_path, cam_path, gt_csv, ref_csv = reference_csvs
    rc = egress_day.main([
        "--yolo_pt", yolo_pt, "--reid_t7", reid_t7, "--workdir", str(tmp_path / "work"),
        "--val_video", video_path, "--gt", gt_csv, "--map50_min", "0.5",
        "--parity_video", video_path, "--ref_csv", ref_csv,
        "--config", cfg_path, "--cam_config", cam_path, "--device", "cpu",
    ])
    assert rc == 0


def test_egress_day_fails_on_csv_mismatch(fake_weights, static_video, reference_csvs, tmp_path):  # noqa: F811
    yolo_pt, reid_t7 = fake_weights
    video_path, _ = static_video
    cfg_path, cam_path, _, ref_csv = reference_csvs
    df = pd.read_csv(ref_csv)
    df.loc[0, "label"] = 99  # one field the parity diff must catch
    bad_csv = str(tmp_path / "bad_ref.csv")
    df.to_csv(bad_csv, index=False)
    assert not egress_day.csv_parity(ref_csv, bad_csv)[0] and not j_egress.csv_parity(ref_csv, bad_csv)[0]
    rc = egress_day.main([
        "--yolo_pt", yolo_pt, "--reid_t7", reid_t7, "--workdir", str(tmp_path / "work"),
        "--parity_video", video_path, "--ref_csv", bad_csv,
        "--config", cfg_path, "--cam_config", cam_path, "--device", "cpu",
    ])
    assert rc == 1


def test_egress_day_strict_skips_fail(fake_weights, tmp_path):  # noqa: F811
    yolo_pt, reid_t7 = fake_weights
    base = ["--yolo_pt", yolo_pt, "--reid_t7", reid_t7, "--device", "cpu"]
    assert egress_day.main(base + ["--workdir", str(tmp_path / "work")]) == 0  # convert passes; the rest skipped
    assert egress_day.main(base + ["--workdir", str(tmp_path / "work2"), "--strict"]) == 1


def test_egress_day_needs_a_card_unless_asked(fake_weights, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        egress_day.main(["--yolo_pt", fake_weights[0], "--workdir", str(tmp_path / "w")])


def test_csv_parity_matches_jax(tmp_path):
    a = pd.DataFrame({
        "track_id": [1, 2], "frame_id": [1, 1], "box": ["[0, 0, 2, 2]", "[1, 1, 3, 3]"], "color": ["a", "b"],
        "label": [0, 1], "direction": [1, 1], "fpoint": ["(0, 0)", "(1, 1)"], "lpoint": ["(2, 2)", "(3, 3)"],
        "fframe": [1, 1], "lframe": [2, 2],
    })
    pa, pb = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    a.to_csv(pa, index=False)
    a[a.track_id == 1].to_csv(pb, index=False)  # one row dropped: an orphan
    for x, y in ((pa, pb), (pa, pa)):
        assert egress_day.csv_parity(x, y) == j_egress.csv_parity(x, y)
    assert egress_day.csv_parity(pa, pb)[1]["orphans"] == 1 and egress_day.csv_parity(pa, pa)[0]
