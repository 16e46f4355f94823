"""A detector configuration reaches the harness on its own anchors and
strides: the reference takes the strides from the layer table and decodes
every head, and the port's network is held to the table conv by conv
(`run.port_yolo_config`) before anything is drawn."""

import json
import math
import os

import pytest
import torch

from cellbench import run
from cellbench.reference import yolo as yolo_ref

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(*path):
    with open(os.path.join(*path)) as f:
        return json.load(f)


S640 = _load(run.ROOT, "cellbench", "configs", "yolov5s-640.json")
TINY = _load(HERE, "data", "tiny.json")
P6 = _load(HERE, "data", "p6-tiny.json")  # the v6.0 yolov5s6 table at a sixteenth of its widths


def test_strides_from_the_table():
    assert yolo_ref.strides(S640) == (8, 16, 32)
    assert yolo_ref.strides(TINY) == (8, 16, 32)
    assert yolo_ref.strides(P6) == (8, 16, 32, 64)


def test_a_concat_of_two_strides_is_refused():
    head = [list(r) for r in S640["head"]]
    head[2] = [[-1, 4], 1, "Concat", [1]]  # the upsampled P5 (stride 16) beside P3 (stride 8)
    with pytest.raises(ValueError, match="Concat of inputs at strides"):
        yolo_ref.strides(dict(S640, head=head))


def test_a_four_scale_table_decodes_every_head():
    heads = yolo_ref.forward(P6, _p6_weights(), torch.rand(2, 3, *P6["net_hw"]))
    assert [tuple(h.shape[-2:]) for h in heads] == [(16, 16), (8, 8), (4, 4), (2, 2)]
    dec = yolo_ref.decode(P6, heads)
    assert dec["boxes"].shape == (2, 1020, 4) and dec["scores"].shape == dec["classes"].shape == (2, 1020)


def _p6_weights():
    from cellbench import weights

    return weights.draw(P6, weights.generator(3, "cpu"), "cpu")[0]


def test_one_box_at_the_stride_64_scale():
    """Zero logits everywhere but one anchor of the P6 head: cell (row 1,
    column 0), anchor 2 (925 x 792), x and y offsets at sigmoid 0.75,
    width and height at sigmoid 0.5, objectness 2, class 3 at 1."""
    no = P6["nc"] + 5
    heads = [torch.zeros(1, 3 * no, n, n) for n in (16, 8, 4, 2)]
    p = heads[3].view(1, 3, no, 2, 2)
    p[0, 2, 0:2, 1, 0] = math.log(3.0)
    p[0, 2, 4, 1, 0] = 2.0
    p[0, 2, 5 + 3, 1, 0] = 1.0
    dec = yolo_ref.decode(P6, heads)
    a = 3 * (16 * 16 + 8 * 8 + 4 * 4) + 3 * (1 * 2 + 0) + 2
    cx, cy = (2 * 0.75 - 0.5 + 0) * 64, (2 * 0.75 - 0.5 + 1) * 64
    torch.testing.assert_close(dec["boxes"][0, a], torch.tensor([cx - 462.5, cy - 396.0, cx + 462.5, cy + 396.0]))
    torch.testing.assert_close(dec["scores"][0, a], torch.sigmoid(torch.tensor(2.0)) * torch.sigmoid(torch.tensor(1.0)))
    assert int(dec["classes"][0, a]) == 3


@pytest.mark.parametrize("anchors", [3, 5])
def test_anchor_sets_and_detect_inputs_differ_in_number(anchors):
    cfg = dict(P6, anchors=(P6["anchors"] * 2)[:anchors])
    heads = [torch.zeros(1, 3 * (P6["nc"] + 5), n, n) for n in (16, 8, 4, 2)]
    with pytest.raises(ValueError, match=f"{anchors} anchor sets for 4 Detect inputs"):
        yolo_ref.decode(cfg, heads)


def test_the_guard_hands_the_tiny_configuration_to_the_port():
    ycfg = run.port_yolo_config(TINY)
    assert ycfg.variant == "yolov5n" and ycfg.num_classes == TINY["nc"]
    assert ycfg.strides == (8, 16, 32)
    assert [list(sum(a, ())) for a in ycfg.anchors] == TINY["anchors"]


def test_the_s640_configuration_is_the_ports_default():
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig

    assert run.port_yolo_config(S640) == YoloConfig("yolov5s", 80)


@pytest.mark.parametrize("anchors", [[[a + 1 for a in s] for s in S640["anchors"]], [s[:4] for s in S640["anchors"]]],
                         ids=["moved", "two-a-scale"])
def test_own_anchors_and_classes_reach_the_port(anchors):
    ycfg = run.port_yolo_config(dict(S640, anchors=anchors, nc=4))
    assert [list(sum(a, ())) for a in ycfg.anchors] == anchors and ycfg.num_classes == 4


@pytest.mark.parametrize("change, reason", [
    (dict(P6, variant="yolov5s", width_multiple=0.5), r"layer\.7\.w: the port has \(512, 256, 3, 3\)"),
    (dict(P6, variant="yolov5n", width_multiple=0.25), r"is not the configuration's network: layer\.7"),
    (dict(P6), "the port builds no 'yolov5s6' network"),
    (dict(S640, width_multiple=0.25), r"layer\.0\.w: the port has \(32, 3, 6, 6\), the configuration \(16, 3, 6, 6\)"),
    (dict(S640, depth_multiple=0.67), r"layer\.2\.m: the port has 1 blocks, the configuration 2"),
    (dict(S640, variant="yolov5m"), r"layer\.0\.w: the port has \(48, 3, 6, 6\)"),
    (dict(S640, head=S640["head"][:-1] + [[[17, 20], 1, "Detect", ["nc", "anchors"]]]),
     "3 anchor sets for 2 Detect inputs"),
    (dict(S640, anchors=S640["anchors"][:2] + [S640["anchors"][2][:4]]), "not of one count"),
], ids=["p6-as-s", "p6-as-n", "p6-variant", "width", "depth", "variant", "detect-inputs", "uneven-anchors"])
def test_the_guard_refuses_another_network(change, reason):
    with pytest.raises(SystemExit, match=reason):
        run.port_yolo_config(change)


def test_the_guard_comes_before_anything_is_drawn(tmp_path, monkeypatch):
    """A run of the tiny cell whose table is the P6 one stops at the
    guard, with no weight drawn."""
    from cellbench import weights
    from cellbench.tests.tiny import make_root

    root = make_root(tmp_path)
    path = os.path.join(root, "cellbench", "tests", "data", "tiny.json")
    with open(path, "w") as f:
        json.dump(dict(P6, variant="yolov5n", width_multiple=0.25, net_hw=TINY["net_hw"]), f)

    def drawn(*a, **k):
        raise AssertionError("weights drawn before the guard")

    monkeypatch.setattr(weights, "generator", drawn)
    with pytest.raises(SystemExit, match="is not the configuration's network"):
        run.main(["--workload", "tiny-dense", "--seed", "5", "--seconds", "0"], device="cpu", root=root)
