"""The port's own copies of the host modules (configs, colors, counting,
visualize, video) against the JAX package's originals on the same inputs."""

import json
import os

import cv2
import numpy as np
import pandas as pd
import pytest

import vehicle_counting_tpu.configs as jcfg
import vehicle_counting_tpu.counting as jcount
import vehicle_counting_tpu.counting.polygon as jpoly
import vehicle_counting_tpu.counting.visualize as jvis
import vehicle_counting_tpu.data.video as jvideo
import vehicle_counting_tpu.utils.colors as jcolors
import vehicle_counting_tpu_torch.configs as pcfg
import vehicle_counting_tpu_torch.counting as pcount
import vehicle_counting_tpu_torch.counting.polygon as ppoly
import vehicle_counting_tpu_torch.counting.visualize as pvis
import vehicle_counting_tpu_torch.data.video as pvideo
import vehicle_counting_tpu_torch.utils.colors as pcolors

W, H, N_FRAMES = 160, 120, 11
ZONE = [[20, 20], [140, 25], [150, 100], [30, 110]]


@pytest.mark.parametrize("name", ["default_config", "default_cam_config"])
def test_packaged_yaml_equal(name):
    got, want = getattr(pcfg, name)(), getattr(jcfg, name)()
    assert got.to_dict() == want.to_dict()
    assert got.to_dict()  # the yaml files ship inside the port's package


def test_config_surface_equal(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text("settings:\n  a: 1\n  nested:\n    b: [1, 2]\n")
    got, want = pcfg.Config(str(path)), jcfg.Config(str(path))
    assert got.to_dict() == want.to_dict() and got.a == 1 and got.missing is None
    over = {"a": 5, "new": "x"}
    assert pcfg.config_from_dict(got, over).to_dict() == jcfg.config_from_dict(want, over).to_dict()
    assert repr(got) == repr(want)


def test_color_for_track_equal():
    for track_id, label in ((1, 0), (7, 3), (1234, 2)):
        assert pcolors.color_for_track(track_id, label) == jcolors.color_for_track(track_id, label)
    assert pcolors.color_list == jcolors.color_list


@pytest.mark.parametrize("fn", ["points_in_polygon", "boxes_intersect_polygon", "cosine_similarity_batch"])
def test_polygon_functions_equal(fn):
    rng = np.random.default_rng(11)
    if fn == "points_in_polygon":
        args = (ZONE, rng.uniform(0, 160, (200, 2)))
    elif fn == "boxes_intersect_polygon":
        xy = rng.uniform(0, 130, (200, 2))
        args = (ZONE, np.concatenate([xy, xy + rng.uniform(2, 40, (200, 2))], 1))
    else:
        args = (rng.normal(size=(50, 2)), rng.normal(size=(4, 2)))
    np.testing.assert_array_equal(getattr(ppoly, fn)(*args), getattr(jpoly, fn)(*args))


def test_polygon_scalar_functions_equal():
    rng = np.random.default_rng(12)
    for p in rng.uniform(0, 160, (20, 2)):
        assert ppoly.is_point_in_polygon(ZONE, p) == jpoly.is_point_in_polygon(ZONE, p)
    for b in rng.uniform(0, 120, (20, 2)):
        box = [b[0], b[1], b[0] + 30, b[1] + 20]
        assert ppoly.check_bbox_intersect_polygon(ZONE, box) == jpoly.check_bbox_intersect_polygon(ZONE, box)
    a, b = rng.normal(size=(2, 2)), rng.normal(size=(2, 2))
    assert ppoly.cosin_similarity(a, b) == jpoly.cosin_similarity(a, b)


def _zone_file(tmp_path):
    zone = {"shapes": [
        {"label": "zone", "points": ZONE},
        {"label": "direction01", "points": [[20, 60], [150, 60]]},
        {"label": "direction02", "points": [[150, 60], [20, 60]]},
        {"label": "direction03", "points": [[80, 20], [80, 110]]},
    ]}
    path = tmp_path / "cam.json"
    path.write_text(json.dumps(zone))
    return str(path)


def _seeded_rows(seed=5, n_tracks=12):
    """Track rows: each track drifts in its own direction over its frames."""
    rng = np.random.default_rng(seed)
    frames, tracks, labels, boxes = [], [], [], []
    for t in range(1, n_tracks + 1):
        label = int(rng.integers(0, 3))
        start, length = int(rng.integers(1, 5)), int(rng.integers(2, 8))
        xy, v = rng.uniform(10, 110, 2), rng.uniform(-9, 9, 2)
        wh = rng.uniform(10, 40, 2)
        for i in range(length):
            c = xy + v * i
            frames.append(start + i)
            tracks.append(t)
            labels.append(label)
            boxes.append([c[0], c[1], c[0] + wh[0], c[1] + wh[1]])
    return frames, tracks, labels, np.asarray(boxes, np.float32)


def test_vehicle_counter_csv_equal(tmp_path):
    """Same seeded rows through both counters: CSVs equal column by column,
    `color` left out (it is random per track by design)."""
    zone = _zone_file(tmp_path)
    rows = _seeded_rows()
    csvs = []
    for mod, name in ((pcount, "port"), (jcount, "jax")):
        counter = mod.VehicleCounter(["a", "b", "c"], zone)
        out = str(tmp_path / f"{name}.csv")
        counter.run(*rows, output_path=out)
        csvs.append(pd.read_csv(out).drop(columns=["color"]))
        polygons, directions = mod.load_zone_anno(zone)
        assert polygons == ZONE and sorted(directions) == ["01", "02", "03"]
    assert len(csvs[0]) > 10
    pd.testing.assert_frame_equal(csvs[0], csvs[1])
    got, want = pcount.count_directions(csvs[0], 3), jcount.count_directions(csvs[1], 3)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _video(tmp_path):
    path = str(tmp_path / "cam.mp4")
    rng = np.random.default_rng(2)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (W, H))
    for _ in range(N_FRAMES):
        writer.write(cv2.GaussianBlur(rng.integers(0, 255, (H, W, 3), dtype=np.uint8), (5, 5), 2))
    writer.release()
    return path


def test_video_reader_batches_equal(tmp_path):
    path = _video(tmp_path)
    assert pvideo.list_videos(path) == jvideo.list_videos(path)
    assert pvideo.list_videos(str(tmp_path)) == jvideo.list_videos(str(tmp_path))
    a, b = pvideo.VideoReader(path, batch_size=4), jvideo.VideoReader(path, batch_size=4)
    assert a.video_info == b.video_info
    got, want = list(a.batches()), list(b.batches())
    assert len(got) == len(want) == 3  # 11 frames in batches of 4, the tail zero-padded
    for x, y in zip(got, want):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    a.reinitialize_stream()
    assert sum(1 for _ in a.frames()) == N_FRAMES
    a.release()
    b.release()


def test_visualize_merged_pixel_equal(tmp_path):
    """One CSV (colours and all) drawn by both copies onto the same tiny
    video: every written frame pixel-equal."""
    path, zone = _video(tmp_path), _zone_file(tmp_path)
    counter = jcount.VehicleCounter(["a", "b", "c"], zone)
    csv = str(tmp_path / "rows.csv")
    counter.run(*_seeded_rows(), output_path=csv)
    outs = []
    for vis, video, name in ((pvis, pvideo, "port"), (jvis, jvideo, "jax")):
        reader = video.VideoReader(path, batch_size=4)
        out = str(tmp_path / f"{name}.mp4")
        writer = video.VideoWriter(reader.video_info, out)
        vis.visualize_merged(reader, csv, counter.directions, counter.polygons, 3, writer)
        writer.release()
        reader.release()
        outs.append(out)
    caps = [cv2.VideoCapture(o) for o in outs]
    n = 0
    while True:
        (ok_a, fa), (ok_b, fb) = caps[0].read(), caps[1].read()
        assert ok_a == ok_b
        if not ok_a:
            break
        np.testing.assert_array_equal(fa, fb)
        n += 1
    assert n == N_FRAMES
    assert os.path.getsize(outs[0]) == os.path.getsize(outs[1])


# ---- evaluation, box fusion, box converters --------------------------------

def _eval_case(seed, n_img=6, nc=3):
    """Seeded predictions and ground truth: jittered copies of the truth
    (some with the wrong class), false positives, missed objects, score
    ties."""
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for _ in range(n_img):
        n = int(rng.integers(0, 6))
        xy = rng.uniform(0, 200, (n, 2))
        gb = np.concatenate([xy, xy + rng.uniform(10, 60, (n, 2))], 1)
        gc = rng.integers(0, nc, n)
        keep = rng.random(n) < 0.8
        pb = gb[keep] + rng.normal(0, 3, (int(keep.sum()), 4))
        pc = np.where(rng.random(int(keep.sum())) < 0.85, gc[keep], rng.integers(0, nc, int(keep.sum())))
        fxy = rng.uniform(0, 200, (2, 2))
        pb = np.concatenate([pb, np.concatenate([fxy, fxy + 20], 1)])
        pc = np.concatenate([pc, rng.integers(0, nc, 2)])
        ps = np.round(rng.uniform(0.05, 1.0, len(pb)), 1)  # rounded: ties
        preds.append({"boxes": pb, "classes": pc, "scores": ps})
        gts.append({"boxes": gb, "classes": gc})
    return preds, gts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluation_metrics_equal(seed):
    import vehicle_counting_tpu.evaluation as jev
    import vehicle_counting_tpu_torch.evaluation as pev

    preds, gts = _eval_case(seed)
    for kw in ({}, {"max_dets": 2, "conf_for_pr": 0.5}):
        got = pev.evaluate_detections(preds, gts, num_classes=3, **kw)
        assert got == jev.evaluate_detections(preds, gts, num_classes=3, **kw)
    assert pev.evaluate_yolov5_v6(preds, gts) == jev.evaluate_yolov5_v6(preds, gts)
    tp, sc = np.random.default_rng(seed).random(20) < 0.5, np.round(np.random.default_rng(seed + 9).random(20), 1)
    assert pev.average_precision(tp, sc, 12) == jev.average_precision(tp, sc, 12)


def test_evaluation_cli_equal(tmp_path, capsys):
    """`python -m vehicle_counting_tpu_torch.evaluation` on a detections
    CSV against a COCO json and a CSV ground truth, both harnesses."""
    import vehicle_counting_tpu.evaluation as jev
    import vehicle_counting_tpu_torch.evaluation as pev

    preds, gts = _eval_case(7)
    rows = [(i, *b, s, c) for i, p in enumerate(preds) for b, s, c in zip(p["boxes"], p["scores"], p["classes"])]
    pred_csv = str(tmp_path / "cam_detections.csv")
    pd.DataFrame(rows, columns=["frame_id", "x1", "y1", "x2", "y2", "score", "label"]).to_csv(pred_csv, index=False)
    gt_rows = [(i, *b, c) for i, g in enumerate(gts) for b, c in zip(g["boxes"], g["classes"])]
    gt_csv = str(tmp_path / "gt.csv")
    pd.DataFrame(gt_rows, columns=["frame_id", "x1", "y1", "x2", "y2", "label"]).to_csv(gt_csv, index=False)
    coco = {"images": [{"id": i} for i in range(len(gts))],
            "annotations": [{"image_id": i, "bbox": [b[0], b[1], b[2] - b[0], b[3] - b[1]], "category_id": int(c)}
                            for i, g in enumerate(gts) for b, c in zip(g["boxes"], g["classes"])]}
    gt_json = str(tmp_path / "gt.json")
    with open(gt_json, "w") as f:
        json.dump(coco, f)
    for gt in (gt_csv, gt_json):
        for harness in ("yolov5", "coco"):
            argv = ["--pred", pred_csv, "--gt", gt, "--harness", harness, "--num_classes", "3"]
            got, want = pev.main(argv), jev.main(argv)
            assert got == want and got["mAP50"] > 0
            out = capsys.readouterr().out.splitlines()
            assert out[0] == out[1]


def test_weighted_boxes_fusion_equal():
    import vehicle_counting_tpu.ops.fusion as jfu
    import vehicle_counting_tpu_torch.ops.fusion as pfu

    rng = np.random.default_rng(8)
    base = rng.uniform(0, 100, (6, 2))
    boxes = [np.concatenate([base, base + 30], 1) + rng.normal(0, 2, (6, 4)) for _ in range(3)]
    scores = [rng.uniform(0, 1, 6) for _ in range(3)]
    labels = [rng.integers(0, 2, 6) for _ in range(3)]
    for kw in ({}, {"iou_thr": 0.7, "skip_box_thr": 0.2, "weights": [2.0, 1.0, 1.0]}):
        for g, w in zip(pfu.weighted_boxes_fusion(boxes, scores, labels, **kw),
                        jfu.weighted_boxes_fusion(boxes, scores, labels, **kw)):
            np.testing.assert_array_equal(g, w)
    empty = pfu.weighted_boxes_fusion([np.zeros((0, 4))], [np.zeros(0)], [np.zeros(0)])
    assert all(len(a) == 0 for a in empty)
    sizes = np.asarray([[0, 0, 1, 5], [0, 0, 5, 5], [0, 0, 5000, 5]], np.float64)
    np.testing.assert_array_equal(pfu.filter_area(sizes), jfu.filter_area(sizes))


@pytest.mark.parametrize("fn", ["clip_boxes", "cxcywh_to_xyxy", "xyxy_to_cxcywh", "xyah_to_tlwh"])
def test_box_converters_equal(fn):
    """The port's torch converters against the JAX package's, array-equal
    on seeded f32 boxes (elementwise f32 arithmetic in the same order)."""
    import jax.numpy as jnp
    import torch

    import vehicle_counting_tpu.ops.boxes as jb
    import vehicle_counting_tpu_torch.ops.boxes as tb

    b = np.random.default_rng(9).uniform(-50, 400, (2, 7, 4)).astype(np.float32)
    b[..., 2:] = np.abs(b[..., 2:]) + 1
    extra = (240, 320) if fn == "clip_boxes" else ()
    got = getattr(tb, fn)(torch.from_numpy(b), *extra).numpy()
    want = np.asarray(getattr(jb, fn)(jnp.asarray(b), *extra))
    np.testing.assert_array_equal(got, want)
