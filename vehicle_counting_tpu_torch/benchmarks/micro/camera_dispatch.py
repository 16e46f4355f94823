"""The camera-sharded step on one card against every card, and how its
shards are dispatched.

    python -m vehicle_counting_tpu_torch.benchmarks.micro.camera_dispatch \
        [--cameras 4] [--batch 128] [--turns 2] [--device cuda|cpu]

The step alone at the main path's shapes: yolov5s bf16, `--cameras`
cameras of 4 tracked classes (padded with all-invalid cameras to a
multiple of the card count), B = 128 device-resident frames per camera
(random 720p frames, host-packed I420 as the pipeline uploads them; the
bench's load: a threshold that tracks ~30 detections a frame), the
tracker states fed back from call to call. Each variant is timed in
turns (ms per frame-round on the host clock, every card synchronised):

  one      `make_multicam_step(None, ...)` on cuda:0: every camera there;
  passes   `make_multicam_step(mesh, ...)` over every card: the package's
           dispatch, one host thread in three passes over the shards;
  threads  a host thread per card, each running the one-card step on its
           card's cameras (each camera's `detect_embed_core`, then the frame
           scan, on frame runners of its own) with its card current: the
           dispatch the passes replaced, kept here to measure it.

Beside each call, every card's busy window: from its first detector
launch to the end of its last work, in ms after the call's start, on the
card's clock (CUDA events). Prints one JSON line with the card's name and
power limit. On `--device cpu` (one CPU entry per "card") it checks the
paths and measures nothing of a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

VARIANTS = ("one", "passes", "threads")


def _sync(devices):
    import torch

    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


@contextlib.contextmanager
def _windows(on_card):
    """Records, per call, each card's first detector launch (the module's
    `detect_front` wrapped; the steps must be built inside the block) and
    yields `call(fn, devices) -> {card: [first launch, end] ms}`."""
    import torch

    from vehicle_counting_tpu_torch.parallel import cameras
    from vehicle_counting_tpu_torch.pipeline import step as step_mod

    firsts, lock, real = {}, threading.Lock(), step_mod.detect_front

    def detect(yolo_params, frames, *args, **kwargs):
        if on_card:
            with lock:
                if frames.device not in firsts:
                    firsts[frames.device] = torch.cuda.Event(enable_timing=True)
                    firsts[frames.device].record(torch.cuda.current_stream(frames.device))
        return real(yolo_params, frames, *args, **kwargs)

    def call(fn, devices):
        firsts.clear()
        starts, ends = {}, {}
        if on_card:
            for d in set(devices):
                starts[d] = torch.cuda.Event(enable_timing=True)
                starts[d].record(torch.cuda.current_stream(d))
        fn()
        if not on_card:
            return {}
        for d in set(devices):
            ends[d] = torch.cuda.Event(enable_timing=True)
            ends[d].record(torch.cuda.current_stream(d))
        _sync(devices)
        return {str(d): [round(starts[d].elapsed_time(firsts[d]), 3), round(starts[d].elapsed_time(ends[d]), 3)]
                for d in sorted(set(devices), key=str)}

    cameras.detect_front = step_mod.detect_front = detect
    cameras.make_multicam_step.cache_clear()
    try:
        yield call
    finally:
        cameras.detect_front = step_mod.detect_front = real
        cameras.make_multicam_step.cache_clear()


def measure(dev, mesh, n_cam: int = 4, b: int = 128, turns: int = 2, variants=VARIANTS):
    """{"ms_per_frame_round": {variant: [ms, ...]}, "busy_windows_ms":
    {variant: [{card: [first launch, end]}, ...]}, ...} for the step on
    `dev` alone and over `mesh` (module docstring), in turns."""
    import torch

    from vehicle_counting_tpu_torch.benchmarks.load import calibrate_from_det
    from vehicle_counting_tpu_torch.models.reid import cast_conv_weights, init_reid
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, cast_params, init_yolov5
    from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw, host_letterbox_yuv420
    from vehicle_counting_tpu_torch.parallel import cameras
    from vehicle_counting_tpu_torch.parallel.mesh import tree_to
    from vehicle_counting_tpu_torch.pipeline import step as step_mod
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, FrameInputs, frame_inputs, init_states
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams
    from vehicle_counting_tpu_torch.utils.device import on_device

    if mesh.size < 2:
        raise ValueError("one device: there is no mesh to compare with it")
    src_hw, on_card = (720, 1280), dev.type == "cuda"
    net = autoshape_hw(src_hw, 640)
    cfg = YoloConfig("yolov5s", 80)
    yp = cast_params(init_yolov5(torch.Generator().manual_seed(0), cfg, dev), torch.bfloat16)
    rp, rs = init_reid(torch.Generator().manual_seed(1), device=dev)
    rp = cast_conv_weights(rp, torch.bfloat16)
    hp = DeepSortParams(tracker=TrackerParams(feat_dtype="bfloat16"), num_classes=4)
    kw = dict(ycfg=cfg, hp=hp, image_size=net, src_hw=src_hw, iou_thres=0.45, max_det=300, dtype=torch.bfloat16,
              frames_format="letterboxed_yuv420")
    rng = np.random.default_rng(0)
    cams = [host_letterbox_yuv420(rng.integers(0, 255, (b,) + src_hw + (3,), dtype=np.uint8), net, content_only=True)
            for _ in range(2)]
    with torch.no_grad(), on_device(dev):
        det, _ = step_mod.detect_embed_core(yp, rp, rs, torch.from_numpy(cams[0]).to(dev),
                                            torch.ones(b, dtype=torch.bool, device=dev),
                                            torch.arange(80, dtype=torch.int32, device=dev), conf_thres=0.0, **kw)
    conf, lut, _ = calibrate_from_det(det, 30)
    del det
    lut = torch.from_numpy(lut).to(dev)
    kw["conf_thres"] = conf

    devices = mesh.devices
    total = n_cam + (-n_cam) % len(devices)
    n_local = total // len(devices)
    frames = np.zeros((total,) + cams[0].shape, np.uint8)
    valid = np.zeros((total, b), bool)
    for c in range(n_cam):
        frames[c], valid[c] = cams[c % 2], True

    def shard(i, d, x):
        return torch.from_numpy(x[i * n_local:(i + 1) * n_local]).to(d)

    def fresh(n, d):
        return cameras.regroup_states(init_states(cameras.camera_params(hp, n), d), (n, hp.num_classes))

    weights = {d: tree_to((yp, rp, rs, lut), d) for d in devices}
    inputs = {"one": (fresh(total, dev), torch.from_numpy(frames).to(dev), torch.from_numpy(valid).to(dev)),
              "passes": (tuple(fresh(n_local, d) for d in devices),
                         tuple(shard(i, d, frames) for i, d in enumerate(devices)),
                         tuple(shard(i, d, valid) for i, d in enumerate(devices)))}
    inputs["threads"] = tuple(list(x) for x in zip(*[(fresh(n_local, d), shard(i, d, frames), shard(i, d, valid))
                                                     for i, d in enumerate(devices)]))
    t = {v: [] for v in variants}
    windows = {v: [] for v in variants}
    with _windows(on_card) as call, torch.no_grad():
        steps = {"one": cameras.make_multicam_step(None, **kw), "passes": cameras.make_multicam_step(mesh, **kw)}

        def run_one():
            st, fr, va = inputs["one"]
            inputs["one"] = (steps["one"](yp, rp, rs, lut, st, fr, va)[0], fr, va)

        def run_passes():
            st, fr, va = inputs["passes"]
            inputs["passes"] = (steps["passes"](yp, rp, rs, lut, st, fr, va)[0], fr, va)

        hp_local = cameras.camera_params(hp, n_local)

        def local(slot, yp_d, rp_d, rs_d, lut_d, st, fr, va):
            """The one-card step on one card's cameras, on runners of slot
            `slot` (past the passes' slots)."""
            per_cam = []
            for c in range(fr.shape[0]):
                det, feats = step_mod.detect_embed_core(yp_d, rp_d, rs_d, fr[c], va[c], lut_d, **kw)
                per_cam.append(frame_inputs(feats, det["boxes"], det["scores"], det["classes"], det["valid"], hp))
            inp = FrameInputs(*(torch.cat(leaf, dim=1) for leaf in zip(*per_cam)))
            new, _ = step_mod.scan_frame_inputs(cameras.regroup_states(st, (n_local * hp.num_classes,)), inp,
                                                hp=hp_local, src_hw=src_hw, slot=slot)
            return cameras.regroup_states(new, (n_local, hp.num_classes))

        def run_threads():
            st, fr, va = inputs["threads"]

            def one(i, d):
                with on_device(d):
                    return local(len(devices) + i, *weights[d], st[i], fr[i], va[i])

            with ThreadPoolExecutor(max_workers=len(devices)) as pool:
                st[:] = [f.result() for f in [pool.submit(one, i, d) for i, d in enumerate(devices)]]

        runs = {"one": (run_one, [dev]), "passes": (run_passes, list(devices)),
                "threads": (run_threads, list(devices))}
        if "threads" in variants:  # their runners captured before the threads start
            for i, d in enumerate(devices):
                if step_mod.use_frame_graph(d):
                    with on_device(d):
                        step_mod.frame_runner(hp_local, src_hw, d, len(devices) + i)
        for v in variants:
            call(runs[v][0], runs[v][1])  # warm-up: the captures, cuDNN's plans, the weights on every card
        for _ in range(turns):
            for v in variants + variants[::-1]:
                fn, devs = runs[v]
                _sync(devices + (dev,))
                t0 = time.perf_counter()
                windows[v].append(call(fn, devs))
                _sync(devices + (dev,))
                t[v].append((time.perf_counter() - t0) * 1e3 / b)
    step_mod.free_frame_runners()
    best = {v: min(x) for v, x in t.items()}
    return {"cameras": n_cam, "padded_to": total, "b": b, "mesh": [str(d) for d in devices], "conf_thres": conf,
            "ms_per_frame_round": t, "one_over": {v: best["one"] / best[v] for v in variants if v != "one"},
            "busy_windows_ms": windows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cameras", type=int, default=4)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda: every card; cpu: two CPU entries, a functional check")
    args = ap.parse_args(argv)

    from vehicle_counting_tpu_torch.parallel.mesh import make_mesh
    from vehicle_counting_tpu_torch.utils.device import card_line, require_device

    dev = require_device(args.device)
    if dev.type == "cuda":
        import torch

        dev, mesh, card = torch.device("cuda", 0), make_mesh(None, ("cam",)), card_line()
    else:
        mesh, card = make_mesh(2, ("cam",), "cpu"), "cpu"
    res = measure(dev, mesh, args.cameras, args.batch, args.turns)
    print(json.dumps(dict(res, card=card)))
    return res


if __name__ == "__main__":
    main()
