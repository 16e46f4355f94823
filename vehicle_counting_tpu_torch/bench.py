#!/usr/bin/env python
"""End-to-end benchmark: detect+track+count frames/sec on one card at YOLOv5s-640.

    python -m vehicle_counting_tpu_torch.bench [--device cuda|cpu]

Counterpart of the JAX package's root `bench.py`, with the same load, the
same `BENCH_*` environment variables and the same two output lines: a
`{"telemetry": ...}` line and, last, ONE line `{"metric", "value", "unit",
"vs_baseline"}`.

Measures the full device step (I420 -> YOLOv5s bf16 -> decode -> NMS ->
restore -> ReID embed -> per-class DeepSORT) streaming batches of 720p
frames, the next batch's upload overlapped with the current batch's
compute: the path CountingPipeline runs.

Load (as the reference bench defines it): BENCH_MODE=yolov5s_640 (default;
B=128, 720p -> 384x640) or yolov5m_1024 (B=16, 1080p -> 576x1024);
random-init weights from seeds 0 / 1; two host batches of random pixels
from `default_rng(0)`, host-letterboxed to content-row I420 (345,600 B per
720p frame); a calibration pass with the identity class map picks the 4
dominant classes and the threshold at the 30th score, so the tracker has
~30 tracked detections per frame; C=4, K=64; tracker state carried across
windows.

Metric semantics (frozen by the reference bench):
  value = best (min-time) streamed window of BENCH_BATCHES batches
  (default 256 frames). Windows sweep the upload stream count
  (BENCH_STREAM_SWEEP) first, then alternate the two best settings;
  sampling runs for BENCH_BUDGET_S (default 600 s), at least BENCH_WINDOWS
  windows, and extends up to 2x while the best window is still improving
  (BENCH_PATIENCE).

What one card over PCIe changes against the reference bench:
  * `unit` is "frames/sec" on one H100 (or whatever card it runs on: the
    telemetry names it);
  * `vs_baseline` is null: the JAX bench's baseline is a north-star for
    another machine, and the reference publishes no throughput;
  * the reference's transfer-rate estimates become `upload_gbps_best` /
    `upload_gbps_p50`, measured with CUDA events around the copies of each
    streamed upload (not inferred from window time minus compute);
  * PCIe has no weather, so "best window" no longer estimates an
    uncongested link: the host's clock is what varies between windows. The
    definition stays; read `p50_fps` and `min_fps` in the telemetry beside
    it;
  * the telemetry carries the card's name and power limit (`card`).

A device-resident reference window (no uploads) is part of the telemetry,
so a regressed streamed number can be attributed to transfer or compute.
It refuses to run on `cuda` without a card; `--device cpu` is a functional
check, not a measurement.
"""

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def main(argv=None, *, sizes=None):
    """Runs the benchmark and prints its two lines; returns (telemetry,
    metric line). `sizes` = (variant, size, src_hw, batch) replaces the
    mode's own for the tests."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device; 'cpu' for a functional check")
    args = ap.parse_args(argv)

    from vehicle_counting_tpu_torch.utils.device import on_device, require_device

    dev = require_device(args.device)
    with on_device(dev):  # the kernel wrappers launch on the current device
        return _run(args, dev, sizes)


def _run(args, dev, sizes):
    import torch

    from vehicle_counting_tpu_torch.benchmarks.load import calibrate_from_det
    from vehicle_counting_tpu_torch.models.reid import cast_conv_weights, init_reid
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, cast_params, init_yolov5
    from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw, content_upload_exact, host_letterbox_yuv420
    from vehicle_counting_tpu_torch.pipeline.step import detect_embed_core, pipeline_batch_step
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, init_states
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams
    from vehicle_counting_tpu_torch.utils.device import card_line
    from vehicle_counting_tpu_torch.utils.transfer import parallel_device_put, upload_gbps

    on_card = dev.type == "cuda"

    # BENCH_MODE selects the configuration being measured; the default
    # metric stays YOLOv5s-640. det_hw is the AutoShape-actual network
    # input for the source geometry (stride-aligned minimal pad,
    # ops/letterbox.autoshape_hw: 720p@640 -> 384x640, 1080p@1024 ->
    # 576x1024).
    mode = os.environ.get("BENCH_MODE", "yolov5s_640")
    if mode == "yolov5m_1024":
        variant, size, src_hw_default, b_default = "yolov5m", 1024, (1080, 1920), 16
        metric = "e2e_detect_track_fps_per_chip_yolov5m1024"
    elif mode == "yolov5s_640":
        variant, size, src_hw_default, b_default = "yolov5s", 640, (720, 1280), 128
        metric = "e2e_detect_track_fps_per_chip_yolov5s640"
    else:
        raise SystemExit(f"unknown BENCH_MODE: {mode}")
    if sizes is not None:
        variant, size, src_hw_default, b_default = sizes

    det_hw = autoshape_hw(src_hw_default, size)
    B = int(os.environ.get("BENCH_BATCH", str(b_default)))
    H, W = src_hw_default
    N_BATCHES = int(os.environ.get("BENCH_BATCHES", str(max(2, 256 // B))))

    ycfg = YoloConfig(variant=variant, num_classes=80)
    yolo_params = cast_params(init_yolov5(torch.Generator().manual_seed(0), ycfg, dev), torch.bfloat16)
    reid_params, reid_stats = init_reid(torch.Generator().manual_seed(1), device=dev)
    reid_params = cast_conv_weights(reid_params, torch.bfloat16)
    hp = DeepSortParams(tracker=TrackerParams(capacity=64, feat_dtype="bfloat16"), num_classes=4)
    states = init_states(hp, dev)

    rng = np.random.default_rng(0)
    # a couple of distinct host frame batches to avoid pathological caching;
    # thin-upload path: host-letterboxed content-row I420, exactly what the
    # pipeline ships (content-only is bit-exact for these 16:9 geometries)
    if not content_upload_exact((H, W), det_hw):
        raise SystemExit(f"content-row upload is not exact for {(H, W)} -> {det_hw}")
    host_batches = [
        host_letterbox_yuv420(rng.integers(0, 255, size=(B, H, W, 3), dtype=np.uint8), det_hw, content_only=True)
        for _ in range(2)
    ]
    valid = torch.ones((B,), dtype=torch.bool, device=dev)
    kw = dict(ycfg=ycfg, hp=hp, image_size=det_hw, src_hw=(H, W), iou_thres=0.45, max_det=300,
              dtype=torch.bfloat16, frames_format="letterboxed_yuv420")

    def step(states, fdev, lut, conf):
        with torch.no_grad():
            return pipeline_batch_step(yolo_params, reid_params, reid_stats, states, fdev, valid, lut,
                                       conf_thres=conf, **kw)

    # Calibrate a confidence threshold that admits ~30 tracked detections /
    # frame so the tracker does realistic association work with random-init
    # weights (fixed seed -> deterministic): the detect+embed front at conf 0
    # with the identity class map.
    fdev = parallel_device_put(host_batches[0], device=dev)
    with torch.no_grad():
        det, _ = detect_embed_core(yolo_params, reid_params, reid_stats, fdev, valid,
                                   torch.arange(80, dtype=torch.int32, device=dev), conf_thres=0.0, **kw)
    conf_thres, lut_h, _ = calibrate_from_det(det, 30)
    del det
    lut = torch.from_numpy(lut_h).to(dev)

    # warm up with the measurement lut/threshold
    states, _, touts = step(states, fdev, lut, conf_thres)
    touts.mask.cpu()

    bytes_per_frame = host_batches[0][0].nbytes
    uploads = []  # timed CUDA events of every streamed upload

    def upload(i, streams):
        return parallel_device_put(host_batches[i % 2], streams, device=dev, timing=uploads if on_card else None)

    # steady state: a background thread uploads the next batch on copy
    # streams of its own while the main thread launches the current step
    def window(states, n_batches, streams):
        pool = ThreadPoolExecutor(max_workers=1)
        t0 = time.perf_counter()
        pending = None
        fut = pool.submit(upload, 0, streams)
        for i in range(n_batches):
            fdev = fut.result()
            fut = pool.submit(upload, i + 1, streams)
            states, _, touts = step(states, fdev, lut, conf_thres)
            pending = touts
        pending.mask.cpu()  # final sync
        pool.shutdown()
        return states, time.perf_counter() - t0

    # device-resident reference window (NO uploads: reuse the warmed batch).
    # Not the recorded metric: telemetry only, so a regressed streamed
    # number is attributable (transfer-bound vs compute regression).
    def device_window(states, n_batches):
        t0 = time.perf_counter()
        pending = None
        for _ in range(n_batches):
            states, _, touts = step(states, fdev, lut, conf_thres)
            pending = touts
        pending.mask.cpu()
        return states, time.perf_counter() - t0

    states, _ = device_window(states, 1)  # warm
    states, dt_dev = device_window(states, max(2, N_BATCHES))
    device_fps = B * max(2, N_BATCHES) / dt_dev

    # Upload stream sweep: one window per candidate, then alternate the two
    # best for the rest of the budget.
    stream_cands = [int(s) for s in os.environ.get("BENCH_STREAM_SWEEP", "4,8,16,2,1").split(",")]
    n_windows = int(os.environ.get("BENCH_WINDOWS", "8"))
    budget_s = float(os.environ.get("BENCH_BUDGET_S", "600"))
    patience = int(os.environ.get("BENCH_PATIENCE", "16"))  # windows
    results = []  # (dt, streams)
    t_meas0 = time.perf_counter()

    def run_one(states, streams):
        states, dt = window(states, N_BATCHES, streams)
        results.append((dt, streams))
        print(f"[bench] window {len(results)}: {B * N_BATCHES / dt:.1f} fps streams={streams}",
              file=sys.stderr, flush=True)
        return states

    for s in stream_cands:
        states = run_one(states, s)
    by_stream = {}
    for dt, s in results:
        by_stream.setdefault(s, []).append(dt)
    ranked = sorted(by_stream, key=lambda s: min(by_stream[s]))
    top2 = (ranked + ranked)[:2]
    i = 0
    while True:
        states = run_one(states, top2[i % 2])
        i += 1
        if len(results) < n_windows:
            continue
        t = time.perf_counter() - t_meas0
        if t >= 2 * budget_s or len(results) >= 400:
            break
        if t >= budget_s:
            # extend past the budget only while the best window is fresh
            # (improved within the last `patience` windows)
            times_so_far = [dt for dt, _ in results]
            best_at = times_so_far.index(min(times_so_far))
            if len(times_so_far) - 1 - best_at >= patience:
                break

    # a second device-resident window after the streamed ones: if it reads
    # like the first, a gap to the streamed windows is the streaming's, not
    # the host clock's drift over the run
    states, dt_dev2 = device_window(states, max(2, N_BATCHES))

    times = [dt for dt, _ in results]
    elapsed = min(times)  # best window (timeit-style)
    best_streams = results[times.index(elapsed)][1]
    by_stream = {}
    for dt, s in results:
        by_stream.setdefault(s, []).append(dt)
    ranked = sorted(by_stream, key=lambda s: min(by_stream[s]))

    frames_w = B * N_BATCHES
    fps = frames_w / elapsed
    fps_all = sorted(frames_w / dt for dt in times)

    def pctl(xs, q):
        return xs[min(len(xs) - 1, int(q * (len(xs) - 1) + 0.5))]

    gbps = sorted(upload_gbps(r) for r in uploads)
    gbps_by_chunks = {}  # a span over several chunks holds the staging memcpy of the later ones
    for r in uploads:
        gbps_by_chunks.setdefault(len(r[1]), []).append(upload_gbps(r))
    telemetry = {
        "card": card_line() if on_card else "cpu",
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "mode": mode,
        "batch": B,
        "batches_per_window": N_BATCHES,
        "windows": len(times),
        "best_fps": round(fps, 2),
        "p50_fps": round(pctl(fps_all, 0.5), 2),
        "p90_fps": round(pctl(fps_all, 0.9), 2),
        "min_fps": round(fps_all[0], 2),
        "device_resident_fps": round(device_fps, 2),
        "device_resident_fps_after": round(B * max(2, N_BATCHES) / dt_dev2, 2),
        "bytes_per_frame": int(bytes_per_frame),
        "upload_gbps_best": round(gbps[-1], 3) if gbps else None,
        "upload_gbps_p50": round(pctl(gbps, 0.5), 3) if gbps else None,
        "upload_gbps_p50_by_streams": {str(n): round(pctl(sorted(v), 0.5), 3) for n, v in sorted(gbps_by_chunks.items())},
        "uploads_timed": len(gbps),
        "best_streams": best_streams,
        "stream_best_fps": {str(s): round(frames_w / min(by_stream[s]), 1) for s in ranked},
        "conf_thres": conf_thres,
        "elapsed_s": round(time.perf_counter() - t_meas0, 1),
        "budget_s": budget_s,
    }
    line = {"metric": metric, "value": round(fps, 2), "unit": "frames/sec", "vs_baseline": None}
    print(json.dumps({"telemetry": telemetry}), flush=True)
    print(json.dumps(line))
    return telemetry, line


if __name__ == "__main__":
    main()
