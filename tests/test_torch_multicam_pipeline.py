"""PyTorch port, `pipeline/multicam.py::MultiCamCountingPipeline` against the
port's serial `CountingPipeline` on the same synthetic videos (the cases of
the JAX package's tests/test_multicam_pipeline.py): per-camera CSVs equal
field by field with `color` left out (random per track by design), and
rows compared in every case. Random-init yolov5n at 96x96, f32 on the CPU,
B = 4, K = 8. The serial CSV is held against the JAX pipeline's by
test_torch_csv.py."""

import json
import os
import types

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

from vehicle_counting_tpu_torch import run as cli
from vehicle_counting_tpu_torch.configs import Config, config_from_dict, default_cam_config, default_config
from vehicle_counting_tpu_torch.pipeline import CountingPipeline
from vehicle_counting_tpu_torch.pipeline.multicam import MultiCamCountingPipeline

W, H, N = 128, 96, 12
RESULT_KEYS = {"csv", "counts", "camera", "video", "error", "frames", "fps"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small ops, which spin
    8 threads against the other test workers' for nothing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _static_video(path, seed, n=N, size=(W, H)):
    """Identical textured frames: the random-init detector's boxes repeat,
    so tracks confirm."""
    w, h = size
    img = cv2.GaussianBlur(np.random.default_rng(seed).integers(0, 255, size=(h, w, 3), dtype=np.uint8), (5, 5), 2)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (w, h))
    for _ in range(n):
        writer.write(img)
    writer.release()


def _zone(w=W, h=H):
    # a margin past the frame: the corner-in-polygon rule wants corners strictly inside
    return {"shapes": [{"label": "zone", "points": [[-5, -5], [w + 5, -5], [w + 5, h + 5], [-5, h + 5]]},
                       {"label": "direction01", "points": [[10, h // 2], [w - 10, h // 2]]}]}


def _cams(tmp_path, specs):
    """specs: (name, seed, frames[, (w, h)]) -> (video dir, zone dir)."""
    vids, zones = tmp_path / "vids", tmp_path / "zones"
    vids.mkdir()
    zones.mkdir()
    for name, seed, n, *size in specs:
        size = size[0] if size else (W, H)
        _static_video(vids / f"{name}.mp4", seed, n, size)
        (zones / f"{name}.json").write_text(json.dumps(_zone(*size)))
    return str(vids), str(zones)


def _configs(zones, config_over=None, tracking=None):
    cfg = config_from_dict(default_config(), dict({
        "detect_batch": 4, "max_tracks_per_class": 8, "image_size": [96, 96], "model_name": "yolov5n",
        "min_conf": 0.05, "max_det": 8, "compute_dtype": "float32"}, **(config_over or {})))
    cam = default_cam_config().to_dict()
    cam["zone_path"] = zones
    base = cam["cam"]["default"]["tracking_config"]
    for name, over in (tracking or {}).items():
        cam["cam"][name] = {"tracking_config": dict(base, **over)}
    return cfg, Config(_settings=cam)


def _args(vids, out):
    return types.SimpleNamespace(weight=None, input_path=vids, output_path=str(out), device="cpu",
                                 mapping_dict=None, debug=False)


def _run_both(tmp_path, vids, zones, visualize=False, **over):
    cfg, cam = _configs(zones, **over)
    serial = CountingPipeline(_args(vids, tmp_path / "serial"), cfg, cam).run(visualize=False)
    multi = MultiCamCountingPipeline(_args(vids, tmp_path / "multicam"), cfg, cam).run(visualize=visualize)
    assert len(multi) == len(serial)
    for r in multi:
        assert set(r) == RESULT_KEYS, r
    return serial, multi


def _compare(tmp_path, cams):
    """Per-camera CSVs of the two runs equal field by field (color left
    out). Returns the number of rows compared."""
    rows = 0
    for cam in cams:
        a = pd.read_csv(tmp_path / "serial" / f"{cam}.csv")
        b = pd.read_csv(tmp_path / "multicam" / f"{cam}.csv")
        cols = [c for c in a.columns if c != "color"]
        pd.testing.assert_frame_equal(a[cols], b[cols])
        rows += len(a)
    return rows


def test_two_static_cameras_match_serial(tmp_path):
    vids, zones = _cams(tmp_path, [("cam_s1", 10, N), ("cam_s2", 11, N)])
    serial, multi = _run_both(tmp_path, vids, zones, visualize=True)
    assert [r["camera"] for r in multi] == ["cam_s1", "cam_s2"]
    assert all(r["error"] is None and r["frames"] == N and r["fps"] > 0 for r in multi)
    assert [r["counts"] for r in multi] == [r["counts"] for r in serial]
    assert _compare(tmp_path, ["cam_s1", "cam_s2"]) > 0
    for cam in ("cam_s1", "cam_s2"):
        cap = cv2.VideoCapture(str(tmp_path / "multicam" / f"{cam}.mp4"))
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == N
        cap.release()


def test_ragged_cameras_match_serial(tmp_path):
    """Unequal lengths: an exhausted camera rides along with its frames
    invalid and gains no row past its own last frame."""
    vids, zones = _cams(tmp_path, [("cam_r1", 20, 8), ("cam_r2", 21, 12), ("cam_r3", 22, 20)])
    _, multi = _run_both(tmp_path, vids, zones)
    assert [r["frames"] for r in multi] == [8, 12, 20]
    assert _compare(tmp_path, ["cam_r1", "cam_r2", "cam_r3"]) > 0
    short = pd.read_csv(tmp_path / "multicam" / "cam_r1.csv")
    assert len(short) and short.frame_id.max() <= 8


def test_per_camera_params_match_serial(tmp_path):
    """Different tracking_config per camera: two groups, each camera with its
    own parameters."""
    vids, zones = _cams(tmp_path, [("cam_s1", 10, N), ("cam_s2", 11, N)])
    tracking = {"cam_s1": {"N_INIT": 1}, "cam_s2": {"N_INIT": 4, "MAX_IOU_DISTANCE": 0.9}}
    _run_both(tmp_path, vids, zones, tracking=tracking)
    assert _compare(tmp_path, ["cam_s1", "cam_s2"]) > 0
    # N_INIT 1 confirms on the first frame: the parameters really differ
    first = [pd.read_csv(tmp_path / "multicam" / f"{c}.csv").frame_id.min() for c in ("cam_s1", "cam_s2")]
    assert first[0] < first[1]


def test_mixed_geometry_groups_match_serial(tmp_path):
    vids, zones = _cams(tmp_path, [("cam_g1", 30, N), ("cam_g2", 31, 8, (96, 64))])
    _, multi = _run_both(tmp_path, vids, zones)
    assert all(r["csv"] and os.path.exists(r["csv"]) for r in multi)
    assert [r["frames"] for r in multi] == [N, 8]
    assert _compare(tmp_path, ["cam_g1", "cam_g2"]) > 0


def test_raw_upload_matches_serial(tmp_path):
    """thin_upload: false: raw frames uploaded, letterboxed on the device."""
    vids, zones = _cams(tmp_path, [("cam_s1", 10, N), ("cam_s2", 11, N)])
    _run_both(tmp_path, vids, zones, config_over={"thin_upload": False})
    assert _compare(tmp_path, ["cam_s1", "cam_s2"]) > 0


def test_fault_isolation_and_result_schema(tmp_path):
    """A missing zone file fails its camera alone at output, an unopenable
    video fails alone at open time; every entry has the same keys."""
    vids, zones = _cams(tmp_path, [("cam_a1", 10, N), ("cam_a2", 11, N)])
    os.remove(os.path.join(zones, "cam_a1.json"))
    with open(os.path.join(vids, "cam_a3.mp4"), "wb"):
        pass
    serial, multi = _run_both(tmp_path, vids, zones)
    by_cam = {r["camera"]: r for r in multi}
    for cam in ("cam_a1", "cam_a3"):
        r = by_cam[cam]
        assert r["csv"] is None and r["error"] and r["counts"] == {} and r["frames"] == 0, r
        assert r["video"] == os.path.join(vids, f"{cam}.mp4")
    ok = by_cam["cam_a2"]
    assert ok["error"] is None and os.path.exists(ok["csv"]) and ok["frames"] == N
    assert [r.get("csv") is None for r in serial] == [True, False, True]
    assert _compare(tmp_path, ["cam_a2"]) > 0


def test_cli_multicam(tmp_path, capsys):
    """The port's run.main with --multicam: the JAX CLI's lines, one result
    per video in path order."""
    vids, zones = _cams(tmp_path, [("cam_c1", 10, 8), ("cam_c2", 11, 8)])
    cfg, cam = _configs(zones)
    args = cli.parser.parse_args(["--input_path", vids, "--output_path", str(tmp_path / "out"), "--device", "cpu",
                                  "--multicam", "--no_visualize"])
    results = cli.main(args, cfg, cam)
    assert [r["camera"] for r in results] == ["cam_c1", "cam_c2"]
    out = capsys.readouterr().out
    for r in results:
        assert os.path.exists(r["csv"])
        assert f"{r['csv']}: counts={r['counts']}" in out


def test_cli_multicam_detect_only_refused(tmp_path):
    args = cli.parser.parse_args(["--input_path", str(tmp_path), "--output_path", str(tmp_path), "--multicam",
                                  "--detect_only"])
    with pytest.raises(SystemExit, match="incompatible"):
        cli.main(args, None, None)
