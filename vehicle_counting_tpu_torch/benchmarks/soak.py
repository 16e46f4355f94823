#!/usr/bin/env python
"""Long-video soak of the port's full pipeline path on the card.

Port of the root `benchmarks/soak.py`. The streaming bench runs windows of
independent batches; this instead runs ONE long 720p synthetic video
(10k frames by default) through the port's CountingPipeline.run_video path —
decode -> host letterbox -> upload -> fused step -> readback -> row
accumulation -> counting -> CSV — and records:

  * wall fps per sample interval (stability / drift), from the pipeline's
    published `frames_done`,
  * host RSS over time (leaks in the row accumulator / prefetch queue),
  * device memory: `torch.cuda.memory_allocated` per sample, and
    `max_memory_allocated` / `memory_stats` at the end,
  * CSV sanity at the end (schema, frame-id range, row count).

Track capacity churn is forced: the synthetic video contains moving
textured blobs, and min_conf=0 + max_det=50 makes every frame emit 50
detections — births/deaths continuously exceed the 64-track capacity,
exercising the overflow/lifecycle path for the whole run (the bench's
windows never run one tracker state this long).

Usage: python -m vehicle_counting_tpu_torch.benchmarks.soak [--frames 10000]
           [--out DIR] [--visualize] [--sample_s 10] [--device cuda|cpu]

Runs on the card (`--device cpu` for a functional check; it raises without
a card otherwise). Writes soak_report.json into --out (default: a
directory under the system's temporary directory) and exits nonzero on a
failed sanity check.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time
import types

import numpy as np


def make_video(path: str, n_frames: int, h: int = 720, w: int = 1280,
               seed: int = 3) -> None:
    """Textured background + bouncing textured blobs (content changes every
    frame -> detections move/flicker -> track churn)."""
    import cv2

    rng = np.random.default_rng(seed)
    bg = cv2.GaussianBlur(
        rng.integers(0, 255, (h, w, 3), np.uint8).astype(np.uint8), (7, 7), 3)
    n_blobs = 8
    pos = rng.uniform([0, 0], [w - 120, h - 120], (n_blobs, 2))
    vel = rng.uniform(-8, 8, (n_blobs, 2))
    size = rng.integers(60, 120, (n_blobs,))
    tex = [
        cv2.GaussianBlur(
            rng.integers(0, 255, (int(s), int(s), 3), np.uint8).astype(np.uint8),
            (5, 5), 2)
        for s in size
    ]
    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cannot open writer for {path}")
    for _ in range(n_frames):
        frame = bg.copy()
        for i in range(n_blobs):
            x, y = int(pos[i, 0]), int(pos[i, 1])
            s = int(size[i])
            frame[y:y + s, x:x + s] = tex[i]
            pos[i] += vel[i]
            for d, lim in ((0, w - s - 1), (1, h - s - 1)):
                if pos[i, d] < 0 or pos[i, d] > lim:
                    vel[i, d] = -vel[i, d]
                    pos[i, d] = min(max(pos[i, d], 0), lim)
        writer.write(frame)
    writer.release()


def rss_mb() -> float:
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 1e6


def device_mem_mb(device):
    """MB the caching allocator has handed out on `device` (None on the CPU)."""
    import torch

    if device.type != "cuda":
        return None
    return torch.cuda.memory_allocated(device) / 1e6


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10000)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "vct_soak"))
    ap.add_argument("--sample_s", type=float, default=10.0)
    ap.add_argument("--visualize", action="store_true",
                    help="include the annotated-MP4 second pass")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--variant", default=None, help="smoke override (yolov5n)")
    ap.add_argument("--image_size", type=int, default=None, help="smoke override")
    ap.add_argument("--device", default="cuda", help="torch device ('cpu' for a functional check)")
    args = ap.parse_args(argv)

    import torch

    from vehicle_counting_tpu_torch.utils.device import card_line, require_device

    dev = require_device(args.device)  # no card and no --device cpu: raise before the video is made

    os.makedirs(args.out, exist_ok=True)
    video = os.path.join(args.out, "cam_soak.mp4")
    zones = os.path.join(args.out, "zones")
    os.makedirs(zones, exist_ok=True)
    h, w = 720, 1280
    with open(os.path.join(zones, "cam_soak.json"), "w") as f:
        json.dump({"shapes": [
            {"label": "zone",
             "points": [[-5, -5], [w + 5, -5], [w + 5, h + 5], [-5, h + 5]]},
            {"label": "direction01", "points": [[0, h // 2], [w, h // 2]]},
            {"label": "direction02", "points": [[w, h // 2], [0, h // 2]]},
        ]}, f)

    if not os.path.exists(video):
        print(f"[soak] generating {args.frames}-frame 720p video ...")
        t0 = time.perf_counter()
        make_video(video, args.frames)
        print(f"[soak] video written in {time.perf_counter() - t0:.0f}s "
              f"({os.path.getsize(video) / 1e6:.0f} MB)")

    from vehicle_counting_tpu_torch.configs import Config, config_from_dict, default_cam_config, default_config
    from vehicle_counting_tpu_torch.pipeline import CountingPipeline

    overrides = {
        "detect_batch": args.batch,
        # 50 forced detections/frame every frame: continuous birth/death
        # churn past the 64-track capacity for the entire run
        "min_conf": 0.0, "max_det": 50,
    }
    if args.variant:
        overrides["model_name"] = args.variant
    if args.image_size:
        overrides["image_size"] = [args.image_size, args.image_size]
    cfg = config_from_dict(default_config(), overrides)
    cam_dict = default_cam_config().to_dict()
    cam_dict["zone_path"] = zones
    cam_dict.setdefault("cam", {})["cam_soak"] = {
        "tracking_config": {"MIN_CONFIDENCE": 0.0, "N_INIT": 3, "MAX_AGE": 10}
    }
    ns = types.SimpleNamespace(
        weight=None, input_path=video, output_path=args.out,
        mapping_dict=None, debug=True, profile=None, check_numerics=False, device=str(dev))
    pipe = CountingPipeline(ns, cfg, Config(_settings=cam_dict))
    pipe.frames_done = 0
    # random-init weights spread class argmaxes over all nc classes and the
    # auto COCO->vehicle mapping would drop most of them; fold EVERY
    # detector class onto the 4 tracked classes instead so all max_det
    # detections/frame reach the tracker (the soak's churn load). The lut
    # is a data argument — the same step as production.
    nc = pipe.class_lut.shape[0]
    pipe.class_lut = torch.as_tensor(np.arange(nc) % pipe.num_classes, dtype=torch.int32, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    samples = []
    stop = threading.Event()

    def sampler():
        last_f, last_t = 0, time.perf_counter()
        while not stop.wait(args.sample_s):
            now = time.perf_counter()
            f = int(getattr(pipe, "frames_done", 0))
            samples.append({
                "t_s": round(now - t_start, 1),
                "frames": f,
                "interval_fps": round((f - last_f) / (now - last_t), 1),
                "rss_mb": round(rss_mb(), 1),
                "device_mb": device_mem_mb(dev),
            })
            last_f, last_t = f, now

    t_start = time.perf_counter()
    th = threading.Thread(target=sampler, daemon=True)
    th.start()
    rss0 = rss_mb()
    try:
        result = pipe.run_video(video, visualize=args.visualize)
    finally:
        stop.set()
        th.join(timeout=5)
    wall = time.perf_counter() - t_start
    rss1 = rss_mb()

    # CSV sanity
    import pandas as pd

    ok = True
    df = pd.read_csv(result["csv"])
    checks = {
        "schema": list(df.columns) == [
            "track_id", "frame_id", "box", "color", "label", "direction",
            "fpoint", "lpoint", "fframe", "lframe"],
        "frames_processed": result["frames"] == args.frames,
        "has_rows": len(df) > 0,
        "frame_ids_in_range": bool(df.frame_id.between(1, args.frames).all())
        if len(df) else True,
    }
    ok = all(checks.values())

    interval_fps = [s["interval_fps"] for s in samples[1:] if s["interval_fps"] > 0]
    on_card = dev.type == "cuda"
    mem = torch.cuda.memory_stats(dev) if on_card else {}
    report = {
        "card": card_line() if on_card else "cpu",
        "frames": result["frames"],
        "wall_s": round(wall, 1),
        "fps_overall": round(result["fps"], 1),
        "fps_interval_min": min(interval_fps) if interval_fps else None,
        "fps_interval_max": max(interval_fps) if interval_fps else None,
        "fps_interval_first": interval_fps[0] if interval_fps else None,
        "fps_interval_last": interval_fps[-1] if interval_fps else None,
        "rss_start_mb": round(rss0, 1),
        "rss_end_mb": round(rss1, 1),
        "rss_max_mb": max((s["rss_mb"] for s in samples), default=rss1),
        "rss_growth_mb": round(rss1 - rss0, 1),
        "device_peak_allocated_mb": round(torch.cuda.max_memory_allocated(dev) / 1e6, 1) if on_card else None,
        "device_peak_reserved_mb": round(mem.get("reserved_bytes.all.peak", 0) / 1e6, 1) if on_card else None,
        "device_alloc_retries": mem.get("num_alloc_retries") if on_card else None,
        "device_mb_series": [s["device_mb"] for s in samples[:: max(1, len(samples) // 10)]],
        "csv_rows": len(df),
        "counts": result["counts"],
        "checks": checks,
        "ok": ok,
        "samples": samples,
    }
    with open(os.path.join(args.out, "soak_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    brief = {k: v for k, v in report.items() if k != "samples"}
    print(json.dumps(brief))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
