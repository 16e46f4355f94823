#!/usr/bin/env python
"""Device-resident stage decomposition of the per-batch step.

    python -m vehicle_counting_tpu_torch.stage_bench [--reps 5] [--batch 32] [--stages detect,...] [--device cuda|cpu]

Counterpart of the JAX package's root `stage_bench.py`, with its flags,
synthetic detections, seeds and calibration recipe. Reports per-stage
ms/frame with the data already in device memory (no host<->device
transfer in the timed region: `bench.py` measures the streamed end-to-end
number, this isolates the card's side of it):

  detect              I420 -> planar RGB + YOLOv5s bf16 forward + decode + NMS + restore
  detect_fwd          ... the forward alone (heads consumed by a tiny reduction)
  detect_tail         ... decode + NMS + restore alone, from materialised heads
  embed               batch-global chunked crop gather + ReID CNN (~30 valid dets/frame)
  embed_gather        the crop gather alone: kernel K1 (on the CPU its plain version)
  embed_gather_plain  K1's plain PyTorch version on the same device
  embed_cnn           the ReID CNN alone on fixed crops
  tracker_churn       per-frame DeepSORT loop, random boxes every frame
  tracker_steady      ... slowly drifting persistent boxes, warmed to confirmed tracks
  e2e                 the full pipeline_batch_step, calibrated to ~30 tracked dets/frame

"churn" feeds random boxes every frame (most tracks die and are born each
frame: the IoU stage dominates, cascade rows are empty); "steady" feeds
slowly drifting persistent boxes (confirmed tracks, matching cascade and
gallery active), the realistic steady-state load. `--stages tracker` runs
both.

Timing: each rep makes `--chain` calls and then synchronises the device
once (`torch.cuda.synchronize()`); a stage's line gives the min and the
median over the reps in ms/frame. PyTorch runs eagerly, so a stage's time
holds the host's launch work as well as the card's kernels; `--trace DIR`
captures one more chain of each stage with torch.profiler
(`tools/profile_summary.py` reads it). The tracker updates its gallery in
place, so the tracker stages clone the start state inside each call (a
15 MB device copy per 128-frame call).

It refuses to run on `cuda` without a card; `--device cpu` is a functional
check at a small `--batch`, not a measurement.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np

STAGES = ("detect", "detect_fwd", "detect_tail", "embed", "embed_gather", "embed_gather_plain",
          "embed_cnn", "tracker_churn", "tracker_steady", "e2e")

def _time_ms_per_frame(fn, sync, b, reps, chain, trace_dir=None):
    """(min, median) over reps of (chain calls; one sync) in ms/frame; with
    `trace_dir`, one more chain under torch.profiler afterwards."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(chain):
            fn()
        sync()
        times.append(time.perf_counter() - t0)
    if trace_dir:
        from vehicle_counting_tpu_torch.utils.profiling import trace

        with trace(trace_dir):
            for _ in range(chain):
                fn()
            sync()
    scale = 1000.0 / (b * chain)
    return min(times) * scale, statistics.median(times) * scale


def main(argv=None, *, src_hw=(720, 1280), size=640, variant="yolov5s"):
    """Runs the stages and prints them; returns {stage: (min, median)}.
    `src_hw`, `size` and `variant` are the bench's 720p -> 640 / yolov5s;
    the tests pass a smaller set."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--chain", type=int, default=8)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--dets", type=int, default=30, help="target valid dets/frame")
    ap.add_argument("--stages", default="detect,embed,tracker,e2e",
                    help=f"comma list of {', '.join(STAGES)}, 'tracker' (both tracker stages) or 'all'")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of each measured stage into DIR")
    ap.add_argument("--reid_dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--max_embed", type=int, default=64, help="ReID crops per CNN forward")
    ap.add_argument("--class_mode", default="batched", choices=["scan", "batched"],
                    help="the tracker's association for all classes at once, or class by class")
    ap.add_argument("--num_classes", type=int, default=4)
    ap.add_argument(
        "--dominant_frac", type=float, default=0.0,
        help="fraction of detections forced into class 0 (realistic traffic "
        "is class-skewed; 0 keeps the uniform class draw)",
    )
    ap.add_argument("--device", default="cuda", help="torch device; 'cpu' for a functional check")
    args = ap.parse_args(argv)

    from vehicle_counting_tpu_torch.utils.device import on_device, require_device

    dev = require_device(args.device)
    with on_device(dev):  # the kernel wrappers launch on the current device
        return _run(args, dev, src_hw, size, variant)


def _run(args, dev, src_hw, size, variant):
    import torch

    from vehicle_counting_tpu_torch.models.detector import fused_detect_tail
    from vehicle_counting_tpu_torch.models.reid import cast_conv_weights, init_reid, reid_embed
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, cast_params, init_yolov5, yolov5_forward_nchw
    from vehicle_counting_tpu_torch.ops import true_div
    from vehicle_counting_tpu_torch.ops.crops import gather_crops_batch, gather_crops_batch_plain
    from vehicle_counting_tpu_torch.ops.letterbox import (
        autoshape_hw, host_letterbox_yuv420, letterbox_params, restore_boxes,
        yuv420_content_to_full, yuv420_to_rgb_u8_planar,
    )
    from vehicle_counting_tpu_torch.benchmarks.load import (
        calibrate_from_det, crop_gather_inputs, synthetic_boxes, synthetic_detections,
    )
    from vehicle_counting_tpu_torch.pipeline.step import detect_embed_core, pipeline_batch_step, tracker_scan
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, embed_detections_batch, init_states
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams, TrackerState
    from vehicle_counting_tpu_torch.utils.device import card_line

    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    B, (H, W) = args.batch, src_hw
    det_hw = autoshape_hw((H, W), size)
    ycfg = YoloConfig(variant=variant, num_classes=80)
    yolo_params = cast_params(init_yolov5(torch.Generator().manual_seed(0), ycfg, dev), torch.bfloat16)
    reid_dt = torch.bfloat16 if args.reid_dtype == "bfloat16" else torch.float32
    reid_params, reid_stats = init_reid(torch.Generator().manual_seed(1), device=dev)
    reid_params = cast_conv_weights(reid_params, reid_dt)
    hp = DeepSortParams(
        tracker=TrackerParams(capacity=64, feat_dtype="bfloat16"),
        num_classes=args.num_classes, max_embed=args.max_embed, class_mode=args.class_mode,
    )

    rng = np.random.default_rng(0)
    frames_host = host_letterbox_yuv420(
        rng.integers(0, 255, size=(B, H, W, 3), dtype=np.uint8), det_hw, content_only=True,
    )
    frames = torch.from_numpy(frames_host).to(dev)
    gain, pad_x, pad_y, _, _ = letterbox_params((H, W), det_hw)

    stages = set(args.stages.split(","))
    if "all" in stages:
        stages = set(STAGES)
    if "tracker" in stages:
        stages |= {"tracker_churn", "tracker_steady"}
    unknown = stages - set(STAGES) - {"tracker"}
    if unknown:
        raise SystemExit(f"unknown stage(s): {sorted(unknown)}")
    results = {}

    def timed(name, fn):
        results[name] = _time_ms_per_frame(fn, sync, B, args.reps, args.chain, args.trace)

    # ---- synthetic detections: args.dets valid boxes/frame over the classes --
    n_det = 300
    k = args.dets

    def boxes_for(seed):
        return synthetic_boxes(seed, B, n_det, (H, W))

    det_valid, classes_h, scores_h = synthetic_detections(B, n_det, k, args.num_classes, args.dominant_frac)
    boxes_churn = torch.from_numpy(boxes_for(3).astype(np.float32)).to(dev)
    dv = torch.from_numpy(det_valid).to(dev)
    cls = torch.from_numpy(classes_h).to(dev)
    sco = torch.from_numpy(scores_h).to(dev)

    def pixels(fr):
        """The pipeline's exact u8 pixel path: planar RGB and the net input."""
        rgb = yuv420_to_rgb_u8_planar(yuv420_content_to_full(fr, (H, W), det_hw))
        return rgb, true_div(rgb.to(torch.float32), 255.0).to(torch.bfloat16)

    def tail(heads):
        det = fused_detect_tail([h.permute(0, 2, 3, 1) for h in heads], ycfg,
                                conf_thres=0.25, iou_thres=0.45, max_det=300)
        det["boxes"] = restore_boxes(det["boxes"], (H, W), det_hw)
        return det

    with torch.no_grad():
        if "detect" in stages:
            timed("detect", lambda: tail(yolov5_forward_nchw(yolo_params, pixels(frames)[1])))

        if "detect_fwd" in stages:
            timed("detect_fwd", lambda: [h.sum() for h in yolov5_forward_nchw(yolo_params, pixels(frames)[1])])

        if "detect_tail" in stages:
            heads = yolov5_forward_nchw(yolo_params, pixels(frames)[1])
            timed("detect_tail", lambda: tail(heads))
            del heads

        if stages & {"embed", "embed_gather", "embed_gather_plain", "embed_cnn"}:
            crop_source = pixels(frames)[0]  # [B, 3, h, w] u8

        if "embed" in stages:
            timed("embed", lambda: embed_detections_batch(
                crop_source, boxes_churn, dv, reid_params, reid_stats, hp,
                crop_gain=float(gain), crop_pad=(float(pad_x), float(pad_y)), dtype=reid_dt))

        if stages & {"embed_gather", "embed_gather_plain", "embed_cnn"}:
            # one call over all valid crops (30/frame)
            fidx, bsel, vsel = crop_gather_inputs(boxes_churn, k, gain, pad_x, pad_y)

            if {"embed_gather", "embed_gather_plain"} <= stages and not torch.equal(
                    gather_crops_batch(crop_source, fidx, bsel, vsel),
                    gather_crops_batch_plain(crop_source, fidx, bsel, vsel)):
                raise AssertionError(f"embed_gather: the kernel differs from its plain version on {B * k} crops")

            if "embed_gather" in stages:
                timed("embed_gather", lambda: gather_crops_batch(crop_source, fidx, bsel, vsel))

            if "embed_gather_plain" in stages:
                timed("embed_gather_plain", lambda: gather_crops_batch_plain(crop_source, fidx, bsel, vsel))

            if "embed_cnn" in stages:
                crops_fixed = gather_crops_batch(crop_source, fidx, bsel, vsel)
                timed("embed_cnn", lambda: reid_embed(reid_params, reid_stats, crops_fixed, dtype=reid_dt))
                del crops_fixed

        if stages & {"tracker_churn", "tracker_steady"}:
            feats_h = np.random.default_rng(4).normal(size=(B, n_det, 512))
            feats_h /= np.linalg.norm(feats_h, axis=-1, keepdims=True)
            feats = torch.from_numpy(feats_h.astype(np.float32)).to(dev)

            def scan(states, bx):
                det = {"boxes": bx, "scores": sco, "classes": cls, "valid": dv}
                return tracker_scan(TrackerState(*(t.clone() for t in states)), det, feats, hp=hp, src_hw=(H, W))

            for name, seeds in (("tracker_churn", (5, 6)), ("tracker_steady", None)):
                if name not in stages:
                    continue
                states = init_states(hp, dev)
                if seeds is None:
                    base = boxes_for(7)[0]  # one frame's boxes, drift slowly
                    drift = np.cumsum(
                        np.random.default_rng(8).normal(0, 2.0, size=(B, n_det, 4)), 0
                    )
                    bx = torch.from_numpy((base[None] + drift).astype(np.float32)).to(dev)
                    # warm the tracker into confirmed steady state; a copy, so
                    # every timed call starts from it (on the card the scan
                    # returns the frame runner's own buffers, which move on)
                    states = TrackerState(*(t.clone() for t in scan(states, bx)[0]))
                else:
                    bx = boxes_churn
                timed(name, lambda: scan(states, bx))

        if "e2e" in stages:
            valid = torch.ones((B,), dtype=torch.bool, device=dev)
            kw = dict(ycfg=ycfg, hp=hp, image_size=det_hw, src_hw=(H, W), iou_thres=0.45, max_det=300,
                      dtype=torch.bfloat16, frames_format="letterboxed_yuv420")
            # calibrate to ~args.dets tracked detections/frame (the bench's
            # recipe: identity lut pass, the 4 dominant random-init classes,
            # threshold at the k-th score)
            det0, _ = detect_embed_core(
                yolo_params, reid_params, reid_stats, frames, valid,
                torch.arange(80, dtype=torch.int32, device=dev), conf_thres=0.0, **kw)
            conf, lut_h, _ = calibrate_from_det(det0, k)
            del det0
            lut = torch.from_numpy(lut_h).to(dev)
            states = init_states(hp, dev)
            # each call starts from the same fresh state, as the JAX stage does
            timed("e2e", lambda: pipeline_batch_step(
                yolo_params, reid_params, reid_stats, TrackerState(*(t.clone() for t in states)),
                frames, valid, lut, conf_thres=conf, **kw))

    card = card_line() if dev.type == "cuda" else "cpu"
    print(f"backend={dev.type} batch={B} dets/frame~{k} reps={args.reps} chain={args.chain} [{card}]")
    for name, (best, med) in results.items():
        print(f"  {name:18s} min {best:8.3f}  median {med:8.3f} ms/frame   ({1000.0 / best:7.1f} fps at min)")
    return results


if __name__ == "__main__":
    main()
