"""Checkpoint loading in the port against the JAX package's loaders.

The checkpoints are made from seeds and shaped like the real files: a
pickled ultralytics-style DetectionModel in fp16 inside the hub dict (its
classes are gone at load time, so the stub unpickler runs), the ReID
`{net_dict: ...}` .t7, and .npz state dicts of both. The port's loaded
trees must be bitwise equal to the JAX loader's trees carried across with
`convert.*_from_jax`: the BN fold happens in numpy in the same order."""

import os
import sys

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX and PyTorch in one process: both at the top)

sys.path.insert(0, os.path.dirname(__file__))
from test_convert_ultralytics import _build_fake_checkpoint
from test_reid import TorchReidNet

from vehicle_counting_tpu.models import convert as jconvert
from vehicle_counting_tpu.models import reid as jreid
from vehicle_counting_tpu_torch.models import convert, reid
from vehicle_counting_tpu_torch.testing import fake_reid_state_dict, fake_yolov5_state_dict, one_torch_thread

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("weights")
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
    # .npz state dicts of the same weights (the torch-free serving path)
    yolo_npz, reid_npz = str(tmp / "y.npz"), str(tmp / "r.npz")
    np.savez(yolo_npz, **jconvert.extract_state_dict(jconvert.load_torch_checkpoint(yolo_pt)))
    np.savez(reid_npz, **jconvert.extract_state_dict(jconvert.load_torch_checkpoint(reid_t7)))
    return {"yolo_pt": yolo_pt, "reid_t7": reid_t7, "yolo_npz": yolo_npz, "reid_npz": reid_npz}


def assert_trees_bitwise_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_trees_bitwise_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_bitwise_equal(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype, got.shape, want.shape)
        assert torch.equal(got, want), f"{path}: max |diff| {float((got - want).abs().max())}"


@pytest.mark.parametrize("kind", ["yolo_pt", "yolo_npz"])
def test_yolov5_tree_bitwise_equal_to_jax_loader(checkpoints, kind):
    got = convert.load_yolov5_weights(checkpoints[kind])
    want = convert.yolo_params_from_jax(jconvert.load_yolov5_weights(checkpoints[kind]))
    assert_trees_bitwise_equal(got, want)
    assert got["0"]["w"].dtype == torch.float32 and got["0"]["w"].dim() == 4
    assert got["0"]["w"].shape[1] == 3  # OIHW: 3 input channels on axis 1


@pytest.mark.parametrize("kind", ["reid_t7", "reid_npz"])
def test_reid_trees_bitwise_equal_to_jax_loader(checkpoints, kind):
    gp, gs = reid.load_reid_weights(checkpoints[kind])
    wp, ws = convert.reid_params_from_jax(*jreid.load_reid_weights(checkpoints[kind]))
    assert_trees_bitwise_equal(gp, wp)
    assert_trees_bitwise_equal(gs, ws)
    assert "fc1" in gp and gp["fc1"]["w"].shape == (512, 256)  # the classifier rides along, [in, out]


def test_state_dict_extraction_equal(checkpoints):
    """The stub unpickler and the module-tree walk give the JAX loader's
    arrays, name by name (fp16 weights widened to f32)."""
    for kind in ("yolo_pt", "reid_t7"):
        got = convert.extract_state_dict(convert.load_torch_checkpoint(checkpoints[kind]))
        want = jconvert.extract_state_dict(jconvert.load_torch_checkpoint(checkpoints[kind]))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k])
    ysd = convert.extract_state_dict(convert.load_torch_checkpoint(checkpoints["yolo_pt"]))
    assert all(k.split(".")[0].isdigit() for k in convert._strip_prefix(ysd))


def test_checkpoint_anchors_equal(checkpoints):
    sd = convert.extract_state_dict(convert.load_torch_checkpoint(checkpoints["yolo_pt"]))
    got, want = convert.checkpoint_anchors(sd), jconvert.checkpoint_anchors(sd)
    assert got is not None and got == want
    no_anchors = {k: v for k, v in sd.items() if "anchors" not in k}
    assert convert.checkpoint_anchors(no_anchors) is None and jconvert.checkpoint_anchors(no_anchors) is None


def test_fuse_conv_bn_matches_jax_fold():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((8, 4, 3, 3)).astype(np.float32)
    g, b, m = (rng.standard_normal(8).astype(np.float32) for _ in range(3))
    v = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    cb = rng.standard_normal(8).astype(np.float32)
    for conv_b in (None, cb):
        gw, gb = convert.fuse_conv_bn(w, g, b, m, v, conv_b=conv_b)
        ww, wb = jconvert.fuse_conv_bn(w, g, b, m, v, conv_b=conv_b)
        np.testing.assert_array_equal(gw, np.transpose(ww, (3, 2, 0, 1)))  # the port keeps OIHW
        np.testing.assert_array_equal(gb, wb)


@pytest.mark.parametrize("variant,nc", [("yolov5n", 4), ("yolov5s", 80)])
def test_seeded_state_dicts_load_in_both_packages(tmp_path, variant, nc):
    """The smoke test's seeded checkpoints (`testing.fake_*_state_dict`, a
    .pt state dict in fp16 and a .t7): both packages load them to equal
    trees, with the class count read from the head's bias."""
    rng = np.random.default_rng(9)
    pt, t7 = str(tmp_path / "y.pt"), str(tmp_path / "r.t7")
    torch.save({"model": {k: torch.from_numpy(v).half() for k, v in fake_yolov5_state_dict(rng, variant, nc).items()},
                "epoch": -1}, pt)
    torch.save({"net_dict": {k: torch.from_numpy(v) for k, v in fake_reid_state_dict(rng).items()}}, t7)
    got = convert.load_yolov5_weights(pt)
    assert_trees_bitwise_equal(got, convert.yolo_params_from_jax(jconvert.load_yolov5_weights(pt)))
    assert got["24"]["m"][0]["b"].shape[0] // 3 - 5 == nc
    gp, gs = reid.load_reid_weights(t7)
    wp, ws = convert.reid_params_from_jax(*jreid.load_reid_weights(t7))
    assert_trees_bitwise_equal(gp, wp)
    assert_trees_bitwise_equal(gs, ws)
    assert "fc1" not in gp
