"""PyTorch port: the offline tools and utils (`vehicle_counting_tpu_torch/tools/`,
`utils/seed.py`, `utils/registry.py`, `utils/debug_draw.py`), each held
against its JAX-package counterpart's output on the same inputs (files,
schema, counts), and `tools/e2e_smoke.py` driving the port's CLI on the CPU.
The cases of tests/test_tools.py and tests/test_debug_draw.py."""

import json
import os
import random

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

import jax

from test_real_weights_path import fake_weights  # noqa: F401 (fixture)
from vehicle_counting_tpu.tools import cocosplit as j_cocosplit
from vehicle_counting_tpu.tools import convert_weights as j_cw
from vehicle_counting_tpu.tools import split_csv as j_split_csv
from vehicle_counting_tpu.tools import split_images as j_split_images
from vehicle_counting_tpu.tools import yolo2coco as j_yolo2coco
from vehicle_counting_tpu.utils import registry as j_registry
from vehicle_counting_tpu_torch.models.reid import init_reid
from vehicle_counting_tpu_torch.tools import convert_weights as cw
from vehicle_counting_tpu_torch.tools import e2e_smoke
from vehicle_counting_tpu_torch.tools.cocosplit import split_coco
from vehicle_counting_tpu_torch.tools.split_csv import split_csv
from vehicle_counting_tpu_torch.tools.split_images import split_images
from vehicle_counting_tpu_torch.tools.yolo2coco import yolo_to_coco
from vehicle_counting_tpu_torch.utils import registry
from vehicle_counting_tpu_torch.utils.debug_draw import draw_detections, draw_pred_gt
from vehicle_counting_tpu_torch.utils.seed import seed_everything


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six test workers at once, and
    more threads per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def yolo_dataset(tmp_path, rng):
    img_dir = tmp_path / "images"
    lbl_dir = tmp_path / "labels"
    img_dir.mkdir()
    lbl_dir.mkdir()
    for i in range(6):
        img = rng.integers(0, 255, size=(60, 80, 3), dtype=np.uint8)
        cv2.imwrite(str(img_dir / f"im{i}.jpg"), img)
        lines = []
        for _ in range(int(rng.integers(1, 4))):
            cls = int(rng.integers(0, 3))
            cx, cy = rng.uniform(0.3, 0.7, 2)
            w, h = rng.uniform(0.1, 0.25, 2)
            lines.append(f"{cls} {cx:.4f} {cy:.4f} {w:.4f} {h:.4f}")
        (lbl_dir / f"im{i}.txt").write_text("\n".join(lines))
    return str(img_dir), str(lbl_dir)


def test_yolo2coco_and_split_match_jax(yolo_dataset, tmp_path):
    img_dir, lbl_dir = yolo_dataset
    coco = yolo_to_coco(img_dir, lbl_dir, ["a", "b", "c"], str(tmp_path / "coco.json"))
    want = j_yolo2coco.yolo_to_coco(img_dir, lbl_dir, ["a", "b", "c"], str(tmp_path / "coco_jax.json"))
    assert coco == want
    assert (tmp_path / "coco.json").read_text() == (tmp_path / "coco_jax.json").read_text()
    assert len(coco["images"]) == 6 and len(coco["categories"]) == 3
    for a in coco["annotations"]:
        img = next(im for im in coco["images"] if im["id"] == a["image_id"])
        assert 0 <= a["bbox"][0] <= img["width"] and a["bbox"][0] + a["bbox"][2] <= img["width"] + 1e-6

    train, val = split_coco(coco, ratio=0.67)
    assert (train, val) == j_cocosplit.split_coco(want, ratio=0.67)
    assert len(train["images"]) == 4 and len(val["images"]) == 2
    train_ids = {im["id"] for im in train["images"]}
    assert all(a["image_id"] in train_ids for a in train["annotations"])
    assert train_ids.isdisjoint({im["id"] for im in val["images"]})


def test_split_csv_matches_jax():
    df = pd.DataFrame([{"image_id": f"im{i}", "class_id": i % 4} for i in range(20)])
    out = split_csv(df, ratio=0.75)
    pd.testing.assert_frame_equal(out, j_split_csv.split_csv(df, ratio=0.75))
    assert set(out[out.fold == 0].class_id.unique()) == {0, 1, 2, 3}
    assert (out.fold == 1).sum() > 0


def test_split_images_matches_jax(yolo_dataset, tmp_path):
    img_dir, lbl_dir = yolo_dataset
    counts = split_images(img_dir, str(tmp_path / "out"), ratio=0.5, label_dir=lbl_dir)
    assert counts == j_split_images.split_images(img_dir, str(tmp_path / "out_jax"), ratio=0.5, label_dir=lbl_dir)
    assert counts == {"train": 3, "val": 3}
    for split in ("train", "val"):
        for kind in ("images", "labels"):
            got = sorted(os.listdir(tmp_path / "out" / split / kind))
            assert got == sorted(os.listdir(tmp_path / "out_jax" / split / kind)) and len(got) == 3


def test_flatten_to_npz_keys_and_roundtrip(tmp_path):
    """The port's dump keys a (params, stats) tree as the JAX dump does,
    and restores it bitwise into tensors of the same structure."""
    params, stats = init_reid(torch.Generator().manual_seed(0), num_classes=8)
    path = str(tmp_path / "reid.npz")
    n = cw._flatten_to_npz((params, stats), path)
    from vehicle_counting_tpu.models.reid import init_reid as j_init_reid

    jpath = str(tmp_path / "reid_jax.npz")
    assert n == j_cw._flatten_to_npz(j_init_reid(jax.random.PRNGKey(0), num_classes=8), jpath) > 50
    assert list(np.load(path).files) == list(np.load(jpath).files)
    like = init_reid(torch.Generator().manual_seed(1), num_classes=8)
    restored = cw.load_npz_pytree(path, like)
    for a, b in zip(cw._paths((params, stats)), cw._paths(restored)):
        assert a[0] == b[0] and torch.equal(a[1], b[1])


def test_convert_weights_cli_matches_jax(fake_weights, tmp_path):  # noqa: F811
    """.pt / .t7 -> state-dict .npz through the port's loaders: the same
    arrays as the JAX tool writes, loadable by both packages."""
    yolo_pt, reid_t7 = fake_weights
    import sys

    for kind, src in (("yolov5", yolo_pt), ("reid", reid_t7)):
        out, jout = str(tmp_path / f"{kind}.npz"), str(tmp_path / f"{kind}_jax.npz")
        cw.main(["--kind", kind, "--input", src, "--output", out])
        argv = sys.argv
        try:
            sys.argv = ["convert_weights", "--kind", kind, "--input", src, "--output", jout]
            j_cw.main()
        finally:
            sys.argv = argv
        a, b = np.load(out), np.load(jout)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_seed_everything():
    seed_everything(11)
    a = (random.random(), np.random.rand(), torch.rand(1).item())
    seed_everything(11)
    assert (random.random(), np.random.rand(), torch.rand(1).item()) == a


def test_registry_matches_jax():
    for mod in (registry, j_registry):
        @mod.register("toy_port_test")
        def toy(a=1, b=2):
            return (a, b)

        assert mod.get_instance({"name": "toy_port_test", "args": {"a": 5}}, b=7) == (5, 7)
        with pytest.raises(KeyError):
            mod.get_instance({"name": "missing_port_test"})


def _img(rng):
    return rng.integers(0, 255, size=(120, 160, 3), dtype=np.uint8)


def test_draw_detections_writes_figure(tmp_path, rng):
    boxes = np.array([[10, 10, 40, 30], [60, 50, 50, 40]], np.float32)
    draw_detections(str(tmp_path / "dets.jpg"), _img(rng), boxes, [0, 2], [0.91, 0.45], obj_list=["car", "x", "truck"])
    assert (tmp_path / "dets.jpg").stat().st_size > 1000


def test_draw_detections_accepts_chw_tensors_and_int_labels(tmp_path, rng):
    img = torch.from_numpy(_img(rng).transpose(2, 0, 1).copy())  # CHW tensor
    draw_detections(str(tmp_path / "chw.png"), img, np.array([[5, 5, 20, 20]]), [1], [0.5])
    assert (tmp_path / "chw.png").stat().st_size > 1000


def test_draw_pred_gt_two_panels_and_negative_gt_skipped(tmp_path, rng):
    draw_pred_gt(str(tmp_path / "pair.jpg"), _img(rng), np.array([[10, 10, 30, 30]], np.float32), [0], [0.8],
                 np.array([[12, 12, 28, 28], [0, 0, 10, 10]], np.float32), [0, -1])
    assert (tmp_path / "pair.jpg").stat().st_size > 1000


def test_e2e_smoke_on_the_cpu(tmp_path, capsys, monkeypatch):
    """The port's CLI in a subprocess on a synthetic video (--fast config):
    the 10-column CSV schema and the annotated MP4's frame count."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the subprocess's torch threads, as _one_thread's
    rc = e2e_smoke.main(["--out", str(tmp_path / "w"), "--frames", "12", "--size", "320x180", "--fast",
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[e2e_smoke] PASS" in out and "annotated MP4 frames: 12 (want 12)" in out
    assert list(pd.read_csv(tmp_path / "w" / "out" / "cam_s1.csv").columns) == e2e_smoke.CSV_SCHEMA


def test_e2e_smoke_needs_a_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        e2e_smoke.main(["--out", str(tmp_path / "w"), "--frames", "4"])
    assert not (tmp_path / "w").exists()
