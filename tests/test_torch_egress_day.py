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
    pa, pb, pc = str(tmp_path / "a.csv"), str(tmp_path / "b.csv"), str(tmp_path / "c.csv")
    a.to_csv(pa, index=False)
    a[a.track_id == 1].to_csv(pb, index=False)  # one row dropped: an orphan
    a.assign(label=[0, 2], lpoint=["(2, 2)", "(3, 4)"]).to_csv(pc, index=False)  # two fields of one row changed
    for x, y in ((pa, pa), (pa, pc)):
        assert egress_day.csv_parity(x, y) == j_egress.csv_parity(x, y)
    assert egress_day.csv_parity(pa, pa)[0]
    assert egress_day.csv_parity(pa, pc)[1]["mismatches"] == {"box": 0, "label": 1, "direction": 0, "fpoint": 0,
                                                              "lpoint": 1, "fframe": 0, "lframe": 0}
    # the orphan's empty cells turn the merged integer columns into floats: the JAX copy's string compare then
    # counts "0.0" against "0" on the row both files hold; the port compares the values, which are equal
    (ok, d), (j_ok, jd) = egress_day.csv_parity(pa, pb), j_egress.csv_parity(pa, pb)
    assert (ok, d["orphans"], d["rows_ref"], d["rows_tpu"]) == (j_ok, jd["orphans"], jd["rows_ref"], jd["rows_tpu"])
    assert (ok, d["orphans"]) == (False, 1) and not any(d["mismatches"].values())
    assert jd["mismatches"] == {"box": 0, "label": 1, "direction": 1, "fpoint": 0, "lpoint": 0, "fframe": 1,
                                "lframe": 1}


ROW = {"track_id": 1, "frame_id": 3, "box": "[10, 20, 30, 40]", "color": "(1, 2, 3)", "label": 2, "direction": 1,
       "fpoint": "(20.0, 30.0)", "lpoint": "(21.5, 30.0)", "fframe": 3, "lframe": 9}
# each field one unit off, and each field unparsable
ONE_UNIT = {"box": "[11, 20, 30, 40]", "label": 3, "direction": 2, "fpoint": "(21.0, 30.0)", "lpoint": "(21.5, 31.0)",
            "fframe": 4, "lframe": 10}
GARBAGE = {"box": "[10, 20, x, 40]", "label": "car", "direction": "1.5", "fpoint": "(20.0 30.0", "lpoint": "",
           "fframe": "three", "lframe": "[9]"}


def _parity(tmp_path, ref, other):
    pa, pb = str(tmp_path / "ref.csv"), str(tmp_path / "other.csv")
    pd.DataFrame([ref]).to_csv(pa, index=False)
    pd.DataFrame([other]).to_csv(pb, index=False)
    return egress_day.csv_parity(pa, pb)


def test_csv_parity_equal_values_written_differently(tmp_path):
    """The same values in another writer's format are equal: ints as floats,
    floats as ints, another spacing; only `color` may differ."""
    other = dict(ROW, box="[10.0, 20.0, 30.0, 40.0]", fpoint="(20, 30)", lpoint="(21.50,30)", label="2.0",
                 fframe=3.0, color="(9, 9, 9)")
    ok, detail = _parity(tmp_path, ROW, other)
    assert ok, detail
    assert detail["mismatches"] == dict.fromkeys(ONE_UNIT, 0) and detail["orphans"] == 0


@pytest.mark.parametrize("field", sorted(ONE_UNIT))
def test_csv_parity_one_unit_change_fails_that_field(tmp_path, field):
    ok, detail = _parity(tmp_path, ROW, dict(ROW, **{field: ONE_UNIT[field]}))
    assert not ok
    assert detail["mismatches"] == dict(dict.fromkeys(ONE_UNIT, 0), **{field: 1})


@pytest.mark.parametrize("field", sorted(GARBAGE))
def test_csv_parity_unparsable_field_is_a_mismatch(tmp_path, field):
    ok, detail = _parity(tmp_path, ROW, dict(ROW, **{field: GARBAGE[field]}))
    assert not ok
    assert detail["mismatches"] == dict(dict.fromkeys(ONE_UNIT, 0), **{field: 1})
