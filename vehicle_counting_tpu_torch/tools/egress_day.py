#!/usr/bin/env python
"""Egress-day validation — EGRESS_RUNBOOK.md as ONE executable command, on the card.

    python -m vehicle_counting_tpu_torch.tools.egress_day \
        --yolo_pt .cache/yolov5s.pt --reid_t7 .cache/ckpt.t7 \
        --workdir out_egress \
        [--val_video cam.mp4 --gt val.json]           # step 2: accuracy \
        [--parity_video cam_04.mp4 --ref_csv ref_out/cam_04.csv]  # step 3 \
        [--config configs.yaml --cam_config cam_configs.yaml] \
        [--map50_min 0.85] [--strict] [--device cuda|cpu]

Port of `vehicle_counting_tpu/tools/egress_day.py`: the same steps and exit
codes through the port's own converter, loaders, pipeline and evaluation;
the pipeline runs on the card (`--device cpu` for a functional check; it
raises without a card otherwise). Runs the runbook's steps in order and exits NONZERO if any executed step
fails its binary pass criterion:

  1. convert  — .pt/.t7 -> state-dict .npz; the npz must load IDENTICALLY
                to the torch original (bit-equal trees).
  2. val      — run --detect_only semantics on --val_video, scored with
                the upstream v6.0 val-harness semantics
                (evaluation.evaluate_yolov5_v6, the instrument behind
                the reference README.md:50-53); PASS iff
                mAP@0.5 >= --map50_min.
  3. parity   — full counting pipeline on --parity_video; the produced CSV
                must field-equal --ref_csv (the torch reference's output on
                the same video+weights) on all columns except the by-design
                random `color` (SURVEY.md §7).

Steps whose inputs are absent are SKIPPED (reported; `--strict` turns any
skip into a failure). Dry-runnable today with the byte-faithful fake
checkpoints from tests/test_real_weights_path.py —
tests/test_torch_egress_day.py drives exactly that and pins the exit codes.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import types
from typing import Dict, List, Optional, Tuple

import numpy as np


def _tree_equal(a, b) -> bool:
    """The same keys, dtypes, shapes and values, leaf for leaf."""
    from vehicle_counting_tpu_torch.tools.convert_weights import _paths

    pa, pb = list(_paths(a)), list(_paths(b))
    return [k for k, _ in pa] == [k for k, _ in pb] and all(
        x.dtype == y.dtype and x.shape == y.shape and bool((x.cpu() == y.cpu()).all())
        for (_, x), (_, y) in zip(pa, pb))


def step_convert(yolo_pt: str, reid_t7: Optional[str], workdir: str) -> Dict:
    """Runbook step 1: convert to torch-free .npz and verify load equality."""
    from vehicle_counting_tpu_torch.models.convert import load_yolov5_weights
    from vehicle_counting_tpu_torch.tools import convert_weights as cw

    os.makedirs(workdir, exist_ok=True)
    out: Dict = {"step": "convert", "ok": True, "detail": {}}

    ynpz = os.path.join(workdir, "yolo.npz")
    cw.main(["--kind", "yolov5", "--input", yolo_pt, "--output", ynpz])
    same = _tree_equal(load_yolov5_weights(ynpz), load_yolov5_weights(yolo_pt))
    out["detail"]["yolo_npz"] = ynpz
    out["detail"]["yolo_npz_equals_pt"] = bool(same)
    out["ok"] &= same

    if reid_t7:
        from vehicle_counting_tpu_torch.models.reid import load_reid_weights

        rnpz = os.path.join(workdir, "reid.npz")
        cw.main(["--kind", "reid", "--input", reid_t7, "--output", rnpz])
        same = _tree_equal(load_reid_weights(rnpz), load_reid_weights(reid_t7))
        out["detail"]["reid_npz"] = rnpz
        out["detail"]["reid_npz_equals_t7"] = bool(same)
        out["ok"] &= same
    return out


def _make_pipeline(args, workdir: str, detect_only: bool = False):
    from vehicle_counting_tpu_torch.configs import Config, default_cam_config, default_config

    config = Config(args.config) if args.config else default_config()
    cam_config = Config(args.cam_config) if args.cam_config else default_cam_config()
    if args.reid_t7:
        cam_config.checkpoint = args.reid_t7
    ns = types.SimpleNamespace(
        weight=args.yolo_pt,
        input_path="__resolved_per_step__",
        output_path=workdir,
        mapping_dict=None,
        debug=False,
        profile=None,
        check_numerics=False,
        device=getattr(args, "device", "cuda"),
    )
    from vehicle_counting_tpu_torch.pipeline import CountingPipeline

    return CountingPipeline(ns, config, cam_config)


def step_val(args, workdir: str) -> Dict:
    """Runbook step 2: detect-only CSV on the val video, scored with the
    upstream v6.0 harness semantics vs --gt."""
    from vehicle_counting_tpu_torch.evaluation import _load_gt, _load_pred_csv, evaluate_yolov5_v6

    out: Dict = {"step": "val", "ok": True, "detail": {}}
    pipe = _make_pipeline(args, os.path.join(workdir, "val"))
    res = pipe.run_video_detect_only(args.val_video)
    out["detail"]["csv"] = res["csv"]
    out["detail"]["frames"] = res["frames"]

    preds = _load_pred_csv(res["csv"])
    gts = _load_gt(args.gt)
    empty_p = {"boxes": np.zeros((0, 4)), "classes": np.zeros(0, np.int64),
               "scores": np.zeros(0)}
    empty_g = {"boxes": np.zeros((0, 4)), "classes": np.zeros(0, np.int64)}
    frame_ids = sorted(set(preds) | set(gts))
    metrics = evaluate_yolov5_v6(
        [preds.get(f, empty_p) for f in frame_ids],
        [gts.get(f, empty_g) for f in frame_ids],
    )
    out["detail"]["metrics"] = {k: round(v, 5) for k, v in metrics.items()}
    out["detail"]["map50_min"] = args.map50_min
    out["ok"] = metrics["mAP50"] >= args.map50_min
    return out


_TUPLE_FIELDS = ("box", "fpoint", "lpoint")  # the rest are integer columns


def _as_tuple(value):
    """A CSV cell such as "[10, 20, 30, 40]" or "(20.0, 30.0)" -> a tuple
    of floats; None where it does not parse."""
    text = str(value).strip()
    if len(text) >= 2 and (text[0], text[-1]) in (("[", "]"), ("(", ")")):
        text = text[1:-1]
    try:
        return tuple(float(x) for x in re.split(r"[,\s]+", text.strip()))
    except ValueError:
        return None


def _as_int(value):
    """A CSV cell holding an integer, written "3" or "3.0" -> 3; None where
    it is not one."""
    try:
        f = float(value)
    except (TypeError, ValueError):
        return None
    return int(f) if f.is_integer() else None


def csv_parity(ref_csv: str, tpu_csv: str) -> Tuple[bool, Dict]:
    """Field-by-field diff of two 10-column tracking CSVs by value; `color`
    excluded (random per track by design). Returns (ok, detail).

    `box`, `fpoint` and `lpoint` compare as tuples of floats, exactly; the
    integer columns as ints. So "[10, 20, 30, 40]" equals
    "[10.0, 20.0, 30.0, 40.0]", as the same value written by another CSV
    writer. A cell that does not parse is a mismatch of its field. (The JAX
    package's copy compares the cells as strings.)"""
    import pandas as pd

    a = pd.read_csv(ref_csv)
    b = pd.read_csv(tpu_csv)
    key = ["track_id", "frame_id"]
    m = a.merge(b, on=key, suffixes=("_ref", "_tpu"), how="outer",
                indicator=True)
    orphans = int((m["_merge"] != "both").sum())
    detail: Dict = {"rows_ref": len(a), "rows_tpu": len(b), "orphans": orphans}
    mismatches = {}
    both = m[m["_merge"] == "both"]
    for col in ("box", "label", "direction", "fpoint", "lpoint", "fframe",
                "lframe"):
        ca, cb = f"{col}_ref", f"{col}_tpu"
        if ca not in m or cb not in m:
            mismatches[col] = -1
            continue
        parse = _as_tuple if col in _TUPLE_FIELDS else _as_int
        pairs = ((parse(x), parse(y)) for x, y in zip(both[ca], both[cb]))
        mismatches[col] = sum(x is None or y is None or x != y for x, y in pairs)
    detail["mismatches"] = mismatches
    ok = orphans == 0 and all(v == 0 for v in mismatches.values())
    return ok, detail


def step_parity(args, workdir: str) -> Dict:
    """Runbook step 3: full pipeline on the parity video; CSV must
    field-equal the torch reference's CSV (9 non-color columns)."""
    out: Dict = {"step": "parity", "ok": True, "detail": {}}
    pipe = _make_pipeline(args, os.path.join(workdir, "parity"))
    res = pipe.run_video(args.parity_video, visualize=False)
    out["detail"]["csv"] = res["csv"]
    ok, detail = csv_parity(args.ref_csv, res["csv"])
    out["detail"].update(detail)
    out["ok"] = ok
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="EGRESS_RUNBOOK.md as one command (nonzero exit on any "
                    "failed pass criterion)")
    p.add_argument("--yolo_pt", required=True, help="real yolov5 .pt (or .npz)")
    p.add_argument("--reid_t7", default=None, help="real ReID ckpt.t7 (or .npz)")
    p.add_argument("--workdir", required=True)
    p.add_argument("--val_video", default=None, help="step 2: validation video")
    p.add_argument("--gt", default=None,
                   help="step 2: ground truth (COCO json keyed by frame id, "
                        "or detections-schema CSV)")
    p.add_argument("--map50_min", type=float, default=0.85,
                   help="step 2 pass bar on mAP@0.5 (BASELINE.md: 0.91797 "
                        "for the published finetuned yolov5s@640; the "
                        "default leaves headroom because those checkpoints "
                        "were lost and COCO weights underperform the table)")
    p.add_argument("--parity_video", default=None, help="step 3: shared video")
    p.add_argument("--ref_csv", default=None,
                   help="step 3: the torch reference's CSV on the same "
                        "video+weights")
    p.add_argument("--config", default=None, help="configs.yaml override")
    p.add_argument("--cam_config", default=None, help="cam_configs.yaml override")
    p.add_argument("--strict", action="store_true",
                   help="treat skipped steps as failures")
    p.add_argument("--device", default="cuda", help="torch device of the pipeline steps ('cpu' for a dry run)")
    args = p.parse_args(argv)

    from vehicle_counting_tpu_torch.utils.device import require_device

    require_device(args.device)  # no card and no --device cpu: raise before any step

    results: List[Dict] = []
    results.append(step_convert(args.yolo_pt, args.reid_t7, args.workdir))

    if args.val_video and args.gt:
        results.append(step_val(args, args.workdir))
    else:
        results.append({"step": "val", "ok": None,
                        "detail": {"skipped": "need --val_video and --gt"}})

    if args.parity_video and args.ref_csv:
        results.append(step_parity(args, args.workdir))
    else:
        results.append({"step": "parity", "ok": None,
                        "detail": {"skipped": "need --parity_video and --ref_csv"}})

    failed = 0
    for r in results:
        status = ("SKIP" if r["ok"] is None else ("PASS" if r["ok"] else "FAIL"))
        if r["ok"] is False or (args.strict and r["ok"] is None):
            failed += 1
        print(f"[egress] {r['step']:8s} {status}  {json.dumps(r['detail'])}")
    summary = {"steps": len(results), "failed": failed,
               "ok": failed == 0}
    print(json.dumps(summary))
    return 0 if failed == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
