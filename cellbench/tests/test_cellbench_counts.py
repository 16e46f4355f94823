"""Operation and byte counts against hand-worked values."""

import json
import os

import pytest

from cellbench import counts

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(os.path.dirname(HERE), "configs")


def _cfg(name):
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        return json.load(f)


def test_one_conv_call():
    # x [2, 16, 10, 12], w [32, 16, 3, 3], stride 2, pad 1: out [2, 32, 5, 6]
    flops, nbytes = counts.conv_call([2, 16, 10, 12], [32, 16, 3, 3], [2, 2], [1, 1], [1, 1], 1, 2)
    assert flops == 2 * 2 * 32 * 5 * 6 * 16 * 3 * 3 == 552960
    assert nbytes == 2 * (2 * 16 * 10 * 12 + 32 * 16 * 3 * 3 + 2 * 32 * 5 * 6) == 20736


def test_one_k1_call():
    # two crops, 20x30 and 200x300 pixels, one launch of 4 rows of 50x50
    got = counts.k1_bytes([(20, 30), (200, 300)], launches=1, rows_per_launch=4, crop_hw=(50, 50))
    read = 3 * 21 * 31 + 3 * 100 * 100
    written = 4 * 50 * 50 * 3 * 4
    assert got == read + written == 151953


@pytest.mark.parametrize("depth,width,gflops", [(0.33, 0.50, 16.5), (0.67, 0.75, 49.0)])
def test_detector_flops_match_the_published_table(depth, width, gflops):
    """ultralytics' model summary gives 16.5 (yolov5s) and 49.0 (yolov5m)
    GFLOPs at 640x640; the v6.0 yamls differ only in the two multiples."""
    cfg = dict(_cfg("yolov5s-640"), depth_multiple=depth, width_multiple=width)
    assert counts.detector_flops(cfg, (640, 640)) / 1e9 == pytest.approx(gflops, rel=0.01)


def test_reid_flops_by_hand():
    rc = _cfg("yolov5s-640")["reid"]
    # stem 3->64 at 50x50, then 25x25 (64), 13x13 (128), 7x7 (256), 4x4 (512)
    by_hand = 2 * 50 * 50 * 64 * 3 * 9
    for hw, cin, cout in ((25, 64, 64), (13, 64, 128), (7, 128, 256), (4, 256, 512)):
        by_hand += 2 * hw * hw * cout * (cin * 9 + cout * 9 + (cin if cin != cout else 0))
        by_hand += 2 * hw * hw * cout * cout * 9 * 2
    assert counts.reid_flops(rc) == by_hand


def test_peaks_by_card_name():
    assert counts.peaks("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
    assert counts.peaks("cpu") is None
