"""Detection metrics: precision / recall / mAP@0.5 / mAP@0.5:0.95.

The reference publishes these four numbers per model (README.md:50-53,
BASELINE.md) but computed them with the upstream YOLOv5 val harness — this
module is the in-framework equivalent so accuracy parity can be measured
against real checkpoints. Standard COCO-style evaluation: greedy matching of
score-sorted predictions to ground truth per class per image at each IoU
threshold, 101-point interpolated AP.

The port's own copy of `vehicle_counting_tpu/evaluation.py` (numpy and
pandas only), kept so the port imports nothing of the JAX package:

    python -m vehicle_counting_tpu_torch.evaluation --pred cam_detections.csv --gt gt.json
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

IOU_RANGE = np.arange(0.5, 1.0, 0.05)


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def _match_image(pred_boxes, pred_scores, gt_boxes, iou_thr: float):
    """Greedy score-order matching; returns tp flags aligned to score order."""
    order = np.argsort(-pred_scores, kind="stable")
    iou = _iou_matrix(pred_boxes[order], gt_boxes)
    taken = np.zeros(len(gt_boxes), bool)
    tp = np.zeros(len(order), bool)
    for r in range(len(order)):
        if len(gt_boxes) == 0:
            break
        cand = np.where(~taken & (iou[r] >= iou_thr))[0]
        if len(cand):
            g = cand[np.argmax(iou[r][cand])]
            taken[g] = True
            tp[r] = True
    return tp, pred_scores[order]


def average_precision(tp: np.ndarray, scores: np.ndarray, n_gt: int) -> float:
    """101-point interpolated AP from pooled (tp, score) pairs."""
    if n_gt == 0:
        return float("nan")
    if len(tp) == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = tp[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    recall = cum_tp / n_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-9)
    # precision envelope
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    r_pts = np.linspace(0, 1, 101)
    p_interp = np.zeros_like(r_pts)
    for i, r in enumerate(r_pts):
        idx = np.searchsorted(recall, r, side="left")
        p_interp[i] = precision[idx] if idx < len(precision) else 0.0
    return float(p_interp.mean())


def evaluate_detections(
    predictions: Sequence[Dict],
    ground_truths: Sequence[Dict],
    num_classes: int,
    conf_for_pr: float = 0.25,
    max_dets: int = None,
) -> Dict[str, float]:
    """COCO-style detection metrics.

    predictions / ground_truths: one dict per image with
      'boxes' [N, 4] xyxy, 'classes' [N], and (preds only) 'scores' [N].

    Returns {'precision', 'recall', 'mAP50', 'mAP50_95'} — the reference's
    published metric set (README.md:50-53). mAP values follow official
    COCOeval semantics (score-greedy matching, pooled PR curve, backward
    precision envelope, 101-point searchsorted interpolation; verified
    against a pycocotools transcription in tests/test_cocoeval_golden.py);
    pass max_dets=100 for COCO's per-image detection cap. P/R are reported
    at a fixed confidence (COCOeval has no P/R summary; for parity with
    the upstream YOLOv5 val harness's best-F1 P/R use evaluate_yolov5_v6).
    """
    aps = {t: [] for t in IOU_RANGE}
    tp_at_conf = fp_at_conf = fn_at_conf = 0

    for c in range(num_classes):
        pooled = {t: ([], []) for t in IOU_RANGE}  # (tp list, score list)
        n_gt = 0
        for pred, gt in zip(predictions, ground_truths):
            pm = np.asarray(pred["classes"]) == c
            gm = np.asarray(gt["classes"]) == c
            pb = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)[pm]
            ps = np.asarray(pred["scores"], np.float64)[pm]
            if max_dets is not None and len(ps) > max_dets:
                # COCOeval evaluates per (image, category) and truncates
                # each category's detections to maxDets by score (stable
                # ties) BEFORE matching — per class, NOT per image
                keep = np.argsort(-ps, kind="stable")[:max_dets]
                keep.sort()
                pb, ps = pb[keep], ps[keep]
            gb = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)[gm]
            n_gt += len(gb)
            for t in IOU_RANGE:
                tp, sc = _match_image(pb, ps, gb, t)
                pooled[t][0].append(tp)
                pooled[t][1].append(sc)
            # P/R at the reporting confidence and IoU 0.5
            keep = ps >= conf_for_pr
            tp50, _ = _match_image(pb[keep], ps[keep], gb, 0.5)
            tp_at_conf += int(tp50.sum())
            fp_at_conf += int((~tp50).sum())
            fn_at_conf += len(gb) - int(tp50.sum())
        for t in IOU_RANGE:
            tp_all = np.concatenate(pooled[t][0]) if pooled[t][0] else np.zeros(0, bool)
            sc_all = np.concatenate(pooled[t][1]) if pooled[t][1] else np.zeros(0)
            ap = average_precision(tp_all, sc_all, n_gt)
            if not np.isnan(ap):
                aps[t].append(ap)

    map50 = float(np.mean(aps[IOU_RANGE[0]])) if aps[IOU_RANGE[0]] else 0.0
    map_all = float(np.mean([np.mean(aps[t]) for t in IOU_RANGE if aps[t]])) if aps[IOU_RANGE[0]] else 0.0
    precision = tp_at_conf / max(tp_at_conf + fp_at_conf, 1)
    recall = tp_at_conf / max(tp_at_conf + fn_at_conf, 1)
    return {
        "precision": float(precision),
        "recall": float(recall),
        "mAP50": map50,
        "mAP50_95": map_all,
    }


# ---------------------------------------------------------------------------
# YOLOv5 v6.0 val-harness semantics — the instrument that produced the
# reference's published table (the reference's README.md:50-53 comes from
# upstream val.py, NOT pycocotools). Differences from COCOeval, reproduced
# faithfully here:
#   * matching (val.py process_batch): candidate (gt, det) pairs are taken
#     at IoU >= 0.50 with class agreement, sorted by IoU descending, then
#     deduplicated per detection and per ground truth (np.unique
#     first-occurrence, which reorders by index — the v6.0 quirk);
#     HIGHER thresholds are judged by the matched pair's IoU, i.e. the
#     match itself is fixed at 0.5;
#   * AP (metrics.compute_ap, method='interp'): precision envelope then
#     np.trapz(np.interp(linspace(0,1,101), mrec, mpre)) with sentinel
#     points [0, ..., recall[-1] + 0.01];
#   * P/R (metrics.ap_per_class): per-class P/R curves interpolated onto a
#     1000-point confidence grid; the reported P/R are the columns at the
#     confidence maximizing MEAN F1 across classes;
#   * classes = np.unique(target_cls): predictions of classes absent from
#     the ground truth are dropped entirely (not counted as FP anywhere).
# ---------------------------------------------------------------------------


def _yolo_process_batch(pred_boxes, pred_scores, pred_cls, gt_boxes, gt_cls):
    """v6.0 val.py process_batch: tp flags [n_pred, 10] over IOU_RANGE."""
    correct = np.zeros((len(pred_boxes), len(IOU_RANGE)), bool)
    if len(pred_boxes) == 0 or len(gt_boxes) == 0:
        return correct
    iou = _iou_matrix(gt_boxes, pred_boxes)  # [n_gt, n_pred], labels-first
    cls_ok = gt_cls[:, None] == pred_cls[None, :]
    gi, di = np.where((iou >= IOU_RANGE[0]) & cls_ok)
    if len(gi):
        matches = np.stack([gi, di, iou[gi, di]], axis=1)
        if len(gi) > 1:
            matches = matches[matches[:, 2].argsort()[::-1]]
            matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
            matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        correct[matches[:, 1].astype(int)] = (
            matches[:, 2:3] >= IOU_RANGE[None, :]
        )
    return correct


_trapz = getattr(np, "trapezoid", None) or np.trapz  # np.trapz deprecated in numpy 2


def _yolo_compute_ap(recall, precision):
    """v6.0 metrics.compute_ap (method='interp')."""
    mrec = np.concatenate(([0.0], recall, [recall[-1] + 0.01]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    return float(_trapz(np.interp(x, mrec, mpre), x))


def evaluate_yolov5_v6(
    predictions: Sequence[Dict], ground_truths: Sequence[Dict]
) -> Dict[str, float]:
    """The reference table's exact metric semantics (upstream v6.0 val.py).

    Same input contract as evaluate_detections. Use THIS when comparing to
    the reference's README.md:50-53 / BASELINE.md on egress day; use
    evaluate_detections for COCOeval-style numbers.
    """
    tps, confs, pcls_all, tcls_all = [], [], [], []
    for pred, gt in zip(predictions, ground_truths):
        pb = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
        ps = np.asarray(pred["scores"], np.float64).reshape(-1)
        pc = np.asarray(pred["classes"]).reshape(-1)
        gb = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)
        gc = np.asarray(gt["classes"]).reshape(-1)
        tps.append(_yolo_process_batch(pb, ps, pc, gb, gc))
        confs.append(ps)
        pcls_all.append(pc)
        tcls_all.append(gc)
    tp = np.concatenate(tps) if tps else np.zeros((0, len(IOU_RANGE)), bool)
    conf = np.concatenate(confs) if confs else np.zeros(0)
    pred_cls = np.concatenate(pcls_all) if pcls_all else np.zeros(0, np.int64)
    target_cls = np.concatenate(tcls_all) if tcls_all else np.zeros(0, np.int64)

    if not tp.any():
        # val.py computes metrics only `if len(stats) and stats[0].any()`:
        # a run with ZERO true positives reports all-zero metrics without
        # entering ap_per_class (upstream v6.0 val.py stats fallback)
        return {"precision": 0.0, "recall": 0.0, "mAP50": 0.0, "mAP50_95": 0.0}

    # metrics.ap_per_class (v6.0), transcription with a stable sort for
    # deterministic score ties (upstream uses default quicksort; order of
    # equal scores is unspecified there)
    order = np.argsort(-conf, kind="stable")
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes = np.unique(target_cls)
    nc = len(unique_classes)
    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, len(IOU_RANGE)))
    p = np.zeros((nc, 1000))
    r = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        sel = pred_cls == c
        n_l = int((target_cls == c).sum())
        if not sel.any() or n_l == 0:
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_l + 1e-16)
        r[ci] = np.interp(-px, -conf[sel], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p[ci] = np.interp(-px, -conf[sel], precision[:, 0], left=1)
        for j in range(len(IOU_RANGE)):
            ap[ci, j] = _yolo_compute_ap(recall[:, j], precision[:, j])
    f1 = 2 * p * r / (p + r + 1e-16)
    best = int(f1.mean(0).argmax()) if nc else 0
    return {
        "precision": float(p[:, best].mean()) if nc else 0.0,
        "recall": float(r[:, best].mean()) if nc else 0.0,
        "mAP50": float(ap[:, 0].mean()) if nc else 0.0,
        "mAP50_95": float(ap.mean()) if nc else 0.0,
    }


# ---------------------------------------------------------------------------
# CLI: score a detections CSV (`python -m vehicle_counting_tpu_torch.run --detect_only` output) against ground
# truth, producing the reference's published metric set (README.md:50-53).
# ---------------------------------------------------------------------------

def _load_pred_csv(path: str) -> Dict[int, Dict]:
    """{frame_id: {'boxes','classes','scores'}} from the detect-only CSV
    (columns: frame_id, x1, y1, x2, y2, score, label)."""
    import pandas as pd

    df = pd.read_csv(path)
    out: Dict[int, Dict] = {}
    for fid, g in df.groupby("frame_id"):
        out[int(fid)] = {
            "boxes": g[["x1", "y1", "x2", "y2"]].to_numpy(np.float64),
            "classes": g["label"].to_numpy(np.int64),
            "scores": (
                g["score"].to_numpy(np.float64)
                if "score" in g
                else np.ones(len(g))
            ),
        }
    return out


def _load_gt(path: str) -> Dict[int, Dict]:
    """Ground truth from COCO json (image id keyed, xywh bboxes) or from a
    CSV with the same columns as the detections file (score optional)."""
    if path.endswith(".json"):
        import json

        with open(path) as f:
            coco = json.load(f)
        out = {int(img["id"]): {"boxes": [], "classes": []} for img in coco["images"]}
        for ann in coco["annotations"]:
            x, y, w, h = ann["bbox"]
            rec = out[int(ann["image_id"])]
            rec["boxes"].append([x, y, x + w, y + h])
            rec["classes"].append(int(ann["category_id"]))
        return {
            k: {
                "boxes": np.asarray(v["boxes"], np.float64).reshape(-1, 4),
                "classes": np.asarray(v["classes"], np.int64),
            }
            for k, v in out.items()
        }
    return _load_pred_csv(path)


def main(argv=None) -> Dict[str, float]:
    import argparse
    import json as _json

    ap = argparse.ArgumentParser(
        description="P/R/mAP50/mAP50:95 for a detections CSV vs ground truth"
    )
    ap.add_argument("--pred", required=True, help="detections CSV (run --detect_only)")
    ap.add_argument("--gt", required=True, help="ground truth: COCO json or CSV")
    ap.add_argument("--num_classes", type=int, default=4)
    ap.add_argument("--conf", type=float, default=0.25, help="P/R reporting confidence")
    ap.add_argument(
        "--harness", choices=["yolov5", "coco"], default="yolov5",
        help="yolov5: the upstream v6.0 val.py semantics that produced the "
        "reference's published table (default); coco: COCOeval-style",
    )
    ap.add_argument("--max_dets", type=int, default=None,
                    help="COCO per-image detection cap (coco harness only)")
    args = ap.parse_args(argv)

    preds = _load_pred_csv(args.pred)
    gts = _load_gt(args.gt)
    empty_p = {"boxes": np.zeros((0, 4)), "classes": np.zeros(0, np.int64),
               "scores": np.zeros(0)}
    empty_g = {"boxes": np.zeros((0, 4)), "classes": np.zeros(0, np.int64)}
    frame_ids = sorted(set(preds) | set(gts))
    pl = [preds.get(f, empty_p) for f in frame_ids]
    gl = [gts.get(f, empty_g) for f in frame_ids]
    if args.harness == "yolov5":
        metrics = evaluate_yolov5_v6(pl, gl)
    else:
        metrics = evaluate_detections(
            pl, gl, num_classes=args.num_classes, conf_for_pr=args.conf,
            max_dets=args.max_dets,
        )
    print(_json.dumps({k: round(v, 5) for k, v in metrics.items()}))
    return metrics


if __name__ == "__main__":
    main()
