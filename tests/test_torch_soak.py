"""PyTorch port, `vehicle_counting_tpu_torch/benchmarks/soak.py` (the long
soak of `CountingPipeline.run_video`) at tiny scale on the CPU: video
generation against the root `benchmarks/soak.py`'s, the sampling thread
(`frames_done`, RSS, device memory), the all-classes LUT fold, the CSV
sanity checks and the report contract (the JAX report's keys and more).
The cases of tests/test_soak_smoke.py."""

import importlib.util
import json
import os

import cv2
import numpy as np
import pytest
import torch

from vehicle_counting_tpu_torch.benchmarks import soak

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_REPORT_KEYS = {"frames", "wall_s", "fps_overall", "fps_interval_min", "fps_interval_max", "fps_interval_last",
                   "rss_start_mb", "rss_end_mb", "rss_max_mb", "device_mb_series", "csv_rows", "counts", "checks",
                   "ok", "samples"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six test workers at once, and
    more threads per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_soak():
    spec = importlib.util.spec_from_file_location("vct_soak", os.path.join(REPO, "benchmarks", "soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _frames(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return out


def test_soak_video_generator_matches_jax(tmp_path):
    a, b = str(tmp_path / "port.mp4"), str(tmp_path / "jax.mp4")
    soak.make_video(a, 12, h=120, w=160)
    _jax_soak().make_video(b, 12, h=120, w=160)
    fa, fb = _frames(a), _frames(b)
    assert len(fa) == len(fb) == 12
    assert all(np.array_equal(x, y) for x, y in zip(fa, fb))
    assert (fa[0] != fa[1]).any()  # blobs move


def test_soak_harness_smoke(tmp_path, capsys):
    out = str(tmp_path / "soak")
    rc = soak.main(["--frames", "24", "--batch", "8", "--variant", "yolov5n", "--image_size", "128", "--out", out,
                    "--sample_s", "0.2", "--device", "cpu"])
    assert rc == 0, capsys.readouterr().out
    report = json.load(open(os.path.join(out, "soak_report.json")))
    assert JAX_REPORT_KEYS <= set(report)
    assert report["ok"] and report["frames"] == 24 and all(report["checks"].values())
    assert report["csv_rows"] > 0 and report["rss_end_mb"] > 0
    assert report["card"] == "cpu" and report["device_peak_allocated_mb"] is None
    assert report["samples"] and all(s["frames"] <= 24 for s in report["samples"])


def test_soak_needs_a_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        soak.main(["--frames", "8", "--out", str(tmp_path / "s")])
    assert not (tmp_path / "s").exists()
