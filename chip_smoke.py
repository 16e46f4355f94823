#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (vehicle_counting_tpu_torch).

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, each fatal on failure:
  build     compile the hand-written kernels (csrc/*.cu) with nvcc, one
            process per source, all at once;
  K1        crop gather kernel vs its plain version on the card, array-equal,
            at the main path's shapes (B=128 planar 384x640 u8 frames,
            128 crops incl. edge and clamp boxes);
  K2        association kernel (and its per-class entry K3) vs the plain
            version, bitwise, at C=4, K=64, max_age=30 (random, tie, empty);
  K4        batched assignment kernel vs its plain version, bitwise, on 300
            clamp-tie problems at S=64 (one launch), a [4, 64, 64] batch and
            S=256; alone and inside the batched transpose rule;
  K5        fused ReID stage-1 block vs its plain version: bf16 at N=128
            (the embed's launch) and N=3840 (128 frames x 30), with cuDNN's
            bf16 block timed beside them, batch invariance (bitwise), f32
            at N=3840; its ptxas registers and shared memory;
  embed     the ReID embed at the main path's shapes with K5 off and on;
  K6        layer-1 conv (3x3 s2, 32->64, SiLU) vs its plain version at
            [128, 192, 320, 32] bf16 and a small f32 shape;
  pipeline  the CLI main path on a synthetic 256-frame 1280x720 video:
            yolov5s random init, default config (detect_batch 128, bf16),
            a calibrated min_conf and a 4-class mapping; asserts the CSV and
            MP4 and that both of its kernels (K1, K2) were launched;
  switched  the CLI on the first 128 frames with FORCE_PALLAS_REID_BLOCK=1
            and the staged association forced: CSV and MP4 written, K1, K4
            and K5 launched; its track count beside the default run's;
  layer-1   K6's stand-alone path (no detector calls it, as in the JAX
            package): yolov5s layer 0 on 128 frames, then K6 as layer 1,
            held against the detector's own layer 1;
  parity    one f32 step on the card vs the same step on the CPU (plain
            versions): detections and track ids equal; then the same step
            on the card through the staged route (K4) vs the K2 route:
            track ids, mask and boxes equal.
Prints the card, a kernel JSON line, and last {"ok": true, "device": ...}.
Exits non-zero without printing a result when there is no CUDA device or
the package is missing.
"""

import collections
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
SRC_HW = (720, 1280)
N_FRAMES = 256
N_SWITCHED = 128
VARIANT = "yolov5s"
KERNELS = ("crops", "cascade", "assignment", "reid_block", "conv_s2")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def phase(name, card):
    print(f"\n== {name} == [{card}]", flush=True)


def cuda_ms(fn, n):
    """Mean ms per call over n calls after a warm-up, CUDA events."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def check_k1(dev):
    import torch

    from vehicle_counting_tpu_torch.ops import crops
    from vehicle_counting_tpu_torch.testing import crop_boxes

    rng = np.random.default_rng(SEED)
    b, h, w, d = 128, 384, 640, 128
    frames = torch.from_numpy(rng.integers(0, 256, (b, 3, h, w), dtype=np.uint8)).to(dev)
    boxes = torch.from_numpy(crop_boxes(rng, d, h, w)).to(dev)
    fidx = torch.from_numpy(rng.integers(0, b, d).astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(d) < 0.9).to(dev)
    args = (frames, fidx, boxes, valid)
    got = crops.gather_crops_batch(*args)
    torch.cuda.synchronize()
    want = crops.gather_crops_batch_plain(*args)
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"K1 kernel differs from its plain version: max |diff| {err}")
    # plain, kernel, kernel, plain
    t_plain = cuda_ms(lambda: crops.gather_crops_batch_plain(*args), 20)
    t_k = cuda_ms(lambda: crops.gather_crops_batch(*args), 50)
    t_k2 = cuda_ms(lambda: crops.gather_crops_batch(*args), 50)
    t_plain2 = cuda_ms(lambda: crops.gather_crops_batch_plain(*args), 20)
    print(f"K1 array-equal over {d} crops; kernel {t_k:.4f}/{t_k2:.4f} ms, plain {t_plain:.4f}/{t_plain2:.4f} ms")
    return {"max_abs_err": err, "ms": min(t_k, t_k2), "plain_ms": min(t_plain, t_plain2)}


def check_k2(dev):
    import torch

    from vehicle_counting_tpu_torch.ops import cascade
    from vehicle_counting_tpu_torch.testing import association_problem

    names = ["gated", "iou", "lvl_of", "tentative", "track_id", "iou_order", "det_valid", "det_order"]
    rng = np.random.default_rng(SEED + 1)
    n_cases, t_plain, err = 0, [], 0
    for kind in ("random", "ties", "empty"):
        for _ in range(8):
            pr = association_problem(rng, 4, 64, 30, kind)
            cpu = [torch.from_numpy(pr[n]) for n in names]
            gpu = [x.to(dev) for x in cpu]
            a = cascade.cascade_match_classparallel(*gpu, 0.2, 0.6, max_age=30)
            b = cascade.cascade_match_batched(*gpu, 0.2, 0.6, max_age=30)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = cascade.cascade_match_classparallel(*cpu, 0.2, 0.6, max_age=30)
            t_plain.append((time.perf_counter() - t0) * 1e3)
            for x, y, z in zip(a, b, want):
                z = z.to(torch.int64)
                for got in (x.cpu().to(torch.int64), y.cpu().to(torch.int64)):
                    err = max(err, int((got - z).abs().max()))
            if err:
                raise AssertionError(f"K2/K3 kernel differs from the plain version ({kind} case): max |diff| {err}")
            n_cases += 1
    pr = association_problem(np.random.default_rng(SEED + 2), 4, 64, 30, "random")
    gpu = [torch.from_numpy(pr[n]).to(dev) for n in names]
    t_k = cuda_ms(lambda: cascade.cascade_match_classparallel(*gpu, 0.2, 0.6, max_age=30), 50)
    print(f"K2/K3 bitwise-equal on {n_cases} [4, 64] problems; kernel {t_k:.4f} ms, "
          f"plain (host CPU) median {np.median(t_plain):.2f} ms")
    return {"max_abs_err": float(err), "ms": t_k, "plain_ms": float(np.median(t_plain))}


def check_k4(dev):
    import torch

    from vehicle_counting_tpu_torch.ops import assignment
    from vehicle_counting_tpu_torch.testing import clamp_tie_problems

    rng = np.random.default_rng(SEED + 4)
    err, n_ok = 0, 0
    for n, s, hi in ((300, 64, 40), (4, 64, 65), (2, 256, 257)):
        costs, nr, nc = (torch.from_numpy(a) for a in clamp_tie_problems(rng, n, s, hi))
        gpu = [t.to(dev) for t in (costs, nr, nc)]
        p = assignment.insert_rows_batched(gpu[0], gpu[1])
        r2c = assignment.solve_uniform_batched(*gpu)
        torch.cuda.synchronize()
        for got, want in ((p, assignment.insert_rows_batched(costs, nr)),
                          (r2c, assignment.solve_uniform_batched(costs, nr, nc))):
            err = max(err, int((got.cpu().long() - want.long()).abs().max()))
        if err:
            raise AssertionError(f"K4 kernel differs from its plain version on [{n}, {s}, {s}]: max |diff| {err}")
        n_ok += n
    # the main path's shape: C=4 classes, K=64 slots
    costs, nr, _ = (torch.from_numpy(a) for a in clamp_tie_problems(rng, 4, 64, 65))
    gpu = (costs.to(dev), nr.to(dev))
    t_k = cuda_ms(lambda: assignment.insert_rows_batched(*gpu), 50)
    t_plain = []
    for _ in range(3):
        t0 = time.perf_counter()
        assignment.insert_rows_plain(costs, nr)
        t_plain.append((time.perf_counter() - t0) * 1e3)
    print(f"K4 bitwise-equal on {n_ok} problems (insert and transpose rule); [4, 64, 64] kernel {t_k:.4f} ms, "
          f"plain (host CPU) median {np.median(t_plain):.2f} ms")
    return {"max_abs_err": float(err), "ms": t_k, "plain_ms": float(np.median(t_plain))}


def check_k5(dev):
    """bf16 rtol 1.6e-2 / atol 1e-2, f32 atol 1e-4: the tolerances of
    tests/test_torch_reid_block.py. bf16 at the embed's launch (N=128, a
    128-crop chunk) and at a 128-frame batch's crops (N=3840), each beside
    the plain version and, for information, cuDNN's bf16 block
    (models/reid.py::_basic_block, what the embed runs with K5 off); f32
    (parity mode) at N=3840."""
    import torch

    from vehicle_counting_tpu_torch import _build
    from vehicle_counting_tpu_torch.models.convert import reid_block64_from_jax, reid_params_from_jax
    from vehicle_counting_tpu_torch.models.reid import _basic_block, cast_conv_weights
    from vehicle_counting_tpu_torch.ops import reid_block
    from vehicle_counting_tpu_torch.testing import reid_block_params

    fn, ptxas = None, {}
    for ln in _build.BUILD_LOGS.get("reid_block", "").splitlines():
        if "Compiling entry function" in ln:
            fn = "bf16" if "reid_block_bf16" in ln else "f32"
        elif fn and ("Used" in ln or "spill" in ln or "wgmma" in ln):
            ptxas.setdefault(fn, []).append(ln.split("ptxas info    :")[-1].strip())
    smem = _build.load("reid_block").vct_reid_block64_smem
    for fn in ("bf16", "f32"):
        print(f"K5 {fn} ptxas: {ptxas.get(fn, '(cached: no report)')}; dynamic smem per block "
              f"{smem(int(fn == 'bf16'))} B")
    torch.backends.cudnn.allow_tf32 = False  # the plain version's f32 convs
    rng = np.random.default_rng(SEED + 5)
    p, s = reid_block_params(rng)
    ops = reid_block64_from_jax(p, s, dev)
    wts = (ops["w1"], ops["w2"], ops["a1"], ops["b1"], ops["a2"], ops["b2"])
    pb, sb = reid_params_from_jax(p, s, dev)
    pb = cast_conv_weights(pb, torch.bfloat16)
    x32 = torch.from_numpy(np.maximum(rng.standard_normal((3840, 64, 25, 25)), 0).astype(np.float32)).to(dev)
    bf16_tol, res = dict(rtol=1.6e-2, atol=1e-2), {}
    for n, reps in ((128, 50), (3840, 5)):
        x = x32[:n].to(torch.bfloat16)
        got = reid_block.reid_block64(x, *wts).float()
        want = reid_block.reid_block64_plain(x, *wts).float()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, **bf16_tol)
        xf = x.float()  # the embed hands its blocks f32 activations
        t_plain = cuda_ms(lambda: reid_block.reid_block64_plain(x, *wts), reps)
        t_k = cuda_ms(lambda: reid_block.reid_block64(x, *wts), reps)
        t_k2 = cuda_ms(lambda: reid_block.reid_block64(x, *wts), reps)
        t_plain2 = cuda_ms(lambda: reid_block.reid_block64_plain(x, *wts), reps)
        t_cudnn = cuda_ms(lambda: _basic_block(pb, sb, xf, 1, torch.bfloat16), reps)
        dev_k = device_events(lambda: reid_block.reid_block64(x, *wts))
        dev_k5 = sum(ms for name, ms in dev_k if "reid_block_bf16" in name)
        dev_plain = sum(ms for _, ms in device_events(lambda: reid_block.reid_block64_plain(x, *wts)))
        print(f"K5 bfloat16 N={n}: max |diff| {err:.3e} ({bf16_tol}); kernel {t_k:.4f}/{t_k2:.4f} ms, "
              f"plain {t_plain:.4f}/{t_plain2:.4f} ms; cuDNN bf16 block (information) {t_cudnn:.4f} ms; "
              f"device time of one call (torch.profiler): K5 {dev_k5:.4f} ms + the wrapper's other ops "
              f"{sum(ms for _, ms in dev_k) - dev_k5:.4f} ms, plain {dev_plain:.4f} ms")
        res[n] = {"max_abs_err": err, "ms": min(t_k, t_k2), "plain_ms": min(t_plain, t_plain2), "cudnn_bf16_ms": t_cudnn,
                  "device_ms": dev_k5, "plain_device_ms": dev_plain}
    # N=1, and N=133 where some blocks take two crops; no atomics, no state
    # across crops: a crop's output does not depend on the launch
    for n in (1, 133):
        x = x32[:n].to(torch.bfloat16)
        got = reid_block.reid_block64(x, *wts)
        torch.testing.assert_close(got.float(), reid_block.reid_block64_plain(x, *wts).float(), **bf16_tol)
    if not torch.equal(got[:4], reid_block.reid_block64(x[:4].contiguous(), *wts)):
        raise AssertionError("K5 bf16: the first 4 crops of an N=133 launch differ from an N=4 launch")
    print("K5 bfloat16 N=1 and N=133 within tolerance; batch-invariant: crops 0-3 of N=133 == N=4, bitwise")
    args = (x32, *wts)
    got = reid_block.reid_block64(*args)
    want = reid_block.reid_block64_plain(*args)
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    t_plain = cuda_ms(lambda: reid_block.reid_block64_plain(*args), 5)
    t_k = cuda_ms(lambda: reid_block.reid_block64(*args), 5)
    t_k2 = cuda_ms(lambda: reid_block.reid_block64(*args), 5)
    t_plain2 = cuda_ms(lambda: reid_block.reid_block64_plain(*args), 5)
    print(f"K5 float32 N=3840 (parity mode, CUDA cores): max |diff| {err:.3e} (atol 1e-4); "
          f"kernel {t_k:.4f}/{t_k2:.4f} ms, plain {t_plain:.4f}/{t_plain2:.4f} ms")
    return {**res[128], "n": 128, "n3840": res[3840],
            "f32": {"max_abs_err": err, "ms": min(t_k, t_k2), "plain_ms": min(t_plain, t_plain2), "n": 3840}}


def embed_ab(dev, n_frames=128, per_frame=30):
    """The ReID embed at the main path's shapes (bf16, chunks of
    DeepSortParams.max_embed crops, per_frame crops for each of n_frames
    frames) with K5 off and on, in turns (off, on, on, off), CUDA events;
    then one profiled pass of each for the card's busy time. Returns the
    best ms/frame of each."""
    import torch

    from vehicle_counting_tpu_torch.models import reid
    from vehicle_counting_tpu_torch.ops import reid_block
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams

    chunk = DeepSortParams._field_defaults["max_embed"]
    rp, rs = reid.init_reid(torch.Generator().manual_seed(1), device=dev)
    rp = reid.cast_conv_weights(rp, torch.bfloat16)
    crops = torch.from_numpy(np.random.default_rng(SEED + 7).standard_normal(
        (n_frames * per_frame, 50, 50, 3)).astype(np.float32)).to(dev)

    def embed():
        with torch.no_grad():
            for i in range(0, crops.shape[0], chunk):
                reid.reid_forward(rp, rs, crops[i : i + chunk], dtype=torch.bfloat16)

    old, t = reid.FORCE_REID_BLOCK_KERNEL, {False: [], True: []}
    try:
        for on in (False, True, True, False) * 2:  # the host's clock wanders: 4 turns each
            reid.FORCE_REID_BLOCK_KERNEL = on
            reid_block.reid_block64.launches = 0
            t[on].append(cuda_ms(embed, 5) / n_frames)
            if bool(reid_block.reid_block64.launches) != on:
                raise AssertionError(f"embed A/B: K5 {'on' if on else 'off'}, {reid_block.reid_block64.launches} launches")
        print(f"embed ms/frame ({n_frames} frames x {per_frame} crops, chunks of {chunk}, bf16): "
              f"K5 off {[round(v, 4) for v in t[False]]}, K5 on {[round(v, 4) for v in t[True]]}")
        for on in (False, True):  # how much of that wall time the card is busy
            reid.FORCE_REID_BLOCK_KERNEL = on
            ev = device_events(embed)
            k5 = sum(ms for name, ms in ev if "reid_block_bf16" in name)
            total = sum(ms for _, ms in ev) / n_frames
            print(f"embed K5 {'on' if on else 'off'}: device busy {total:.4f} ms/frame "
                  f"({100 * total / min(t[on]):.1f} % of the best wall time; torch.profiler), "
                  f"K5 kernel {k5 / n_frames:.4f} ms/frame, {len(ev) / n_frames:.2f} device ops/frame")
    finally:
        reid.FORCE_REID_BLOCK_KERNEL = old
    return {"off": min(t[False]), "on": min(t[True])}


def device_events(fn):
    """(name, ms) of each kernel and copy that one call of fn runs on the
    card (torch.profiler); a warm-up call first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events() if e.device_type == DeviceType.CUDA]


def check_k6(dev):
    """bf16 rtol 1.6e-2 / atol 1e-2, f32 1e-5: the tolerances of
    tests/test_torch_conv_s2.py."""
    import torch

    from vehicle_counting_tpu_torch.models.convert import conv1_s2_from_jax
    from vehicle_counting_tpu_torch.ops import conv_s2
    from vehicle_counting_tpu_torch.testing import conv1_s2_inputs

    torch.backends.cudnn.allow_tf32 = False  # the plain version's f32 conv
    rng = np.random.default_rng(SEED + 6)
    res = {}
    for shape, dt, tol in (((128, 192, 320, 32), torch.bfloat16, dict(rtol=1.6e-2, atol=1e-2)),
                           ((2, 64, 128, 32), torch.float32, dict(rtol=1e-5, atol=1e-5))):
        x, p = conv1_s2_inputs(rng, shape)
        w, b = conv1_s2_from_jax(p, dev)
        xt = torch.from_numpy(x).to(dev).to(dt)
        got = conv_s2.conv1_s2_silu(xt, w, b).float()
        want = conv_s2.conv1_s2_silu_plain(xt, w, b).float()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, **tol)
        n = 5 if dt == torch.bfloat16 else 20
        t_plain = cuda_ms(lambda: conv_s2.conv1_s2_silu_plain(xt, w, b), n)
        t_k = cuda_ms(lambda: conv_s2.conv1_s2_silu(xt, w, b), n)
        t_k2 = cuda_ms(lambda: conv_s2.conv1_s2_silu(xt, w, b), n)
        t_plain2 = cuda_ms(lambda: conv_s2.conv1_s2_silu_plain(xt, w, b), n)
        name = str(dt).split(".")[-1]
        print(f"K6 {name} {list(shape)}: max |diff| {err:.3e} ({tol}); kernel {t_k:.4f}/{t_k2:.4f} ms, "
              f"plain {t_plain:.4f}/{t_plain2:.4f} ms")
        res[name] = {"max_abs_err": err, "ms": min(t_k, t_k2), "plain_ms": min(t_plain, t_plain2)}
    return res


def write_video(tmp, n_frames=N_FRAMES, name="cam_smoke"):
    """n_frames of 1280x720: a fixed textured background with coloured
    boxes driving across (the same frames for every n_frames), and the
    zone file the CLI needs."""
    import cv2

    rng = np.random.default_rng(SEED + 3)
    h, w = SRC_HW
    bg = cv2.resize(rng.integers(0, 256, (h // 8, w // 8, 3), dtype=np.uint8), (w, h))
    cars = [(rng.integers(0, h - 120), rng.uniform(-9, 9), rng.integers(40, 160), rng.integers(30, 120),
             tuple(int(c) for c in rng.integers(0, 256, 3))) for _ in range(24)]
    path = os.path.join(tmp, f"{name}.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (w, h))
    for t in range(n_frames):
        img = bg.copy()
        for i, (y, vx, bw, bh, color) in enumerate(cars):
            x = int((i * 53 + vx * t) % (w - bw))
            cv2.rectangle(img, (x, int(y)), (x + int(bw), int(y) + int(bh)), color, -1)
        writer.write(img)
    writer.release()
    zones = os.path.join(tmp, "zones")
    os.makedirs(zones, exist_ok=True)
    with open(os.path.join(zones, f"{name}.json"), "w") as f:
        json.dump({"shapes": [
            {"label": "zone", "points": [[100, 100], [1180, 100], [1180, 620], [100, 620]]},
            {"label": "direction01", "points": [[100, 360], [1180, 360]]},
            {"label": "direction02", "points": [[1180, 360], [100, 360]]},
        ]}, f)
    return path, zones


def first_batch(path, n):
    """The first n decoded RGB frames [n, H, W, 3] of the video, as the
    pipeline's reader yields them."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while len(frames) < n:
        ok, bgr = cap.read()
        if not ok:
            raise AssertionError(f"{path}: {len(frames)} frames readable, {n} needed")
        frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(frames)


def calibrate(dev, path):
    """(min_conf, mapping) like bench.py: one bf16 step at conf 0 with the
    identity class map; track the 4 dominant classes and set the threshold
    so frame 0 keeps ~30 of their detections."""
    import torch

    from vehicle_counting_tpu_torch.models.reid import cast_conv_weights, init_reid
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, cast_params, init_yolov5
    from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw, host_letterbox_yuv420
    from vehicle_counting_tpu_torch.pipeline.step import detect_embed_core
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams

    net = autoshape_hw(SRC_HW, 640)
    cfg = YoloConfig(VARIANT, 80)
    yp = cast_params(init_yolov5(torch.Generator().manual_seed(0), cfg, dev), torch.bfloat16)
    rp, rs = init_reid(torch.Generator().manual_seed(1), device=dev)
    yuv = torch.from_numpy(host_letterbox_yuv420(first_batch(path, 8), net, content_only=True)).to(dev)
    hp = DeepSortParams(tracker=TrackerParams(), num_classes=80)
    with torch.no_grad():
        det, _ = detect_embed_core(
            yp, cast_conv_weights(rp, torch.bfloat16), rs, yuv, torch.ones(8, dtype=torch.bool, device=dev),
            torch.arange(80, dtype=torch.int32, device=dev), ycfg=cfg, hp=hp, image_size=net, src_hw=SRC_HW,
            conf_thres=0.0, iou_thres=0.45, max_det=300, dtype=torch.bfloat16)
    scores, classes, ok = (det[k][0].cpu().numpy() for k in ("scores", "classes", "valid"))
    top4 = [c for c, _ in collections.Counter(classes[ok].tolist()).most_common(4)]
    pool = np.sort(scores[ok & np.isin(classes, top4)])
    conf = float(pool[-min(30, pool.size)])
    return conf, {int(c): i for i, c in enumerate(top4)}


def run_pipeline(dev, tmp, path, zones, conf, mapping, n_frames=N_FRAMES, out="out"):
    """The CLI main path; returns (frames/s, the kernel counts of that run,
    the CSV's rows)."""
    import torch

    from vehicle_counting_tpu_torch import run
    from vehicle_counting_tpu_torch.ops import assignment, cascade, crops, reid_block

    out_dir = os.path.join(tmp, out)
    args = run.parser.parse_args([
        "--input_path", path, "--output_path", out_dir, "--device", str(dev),
        "--mapping", json.dumps(mapping),
    ])
    config, cam_config = run.load_configs(args)  # the packaged defaults
    config.min_conf = conf
    cam_config.zone_path = zones
    counters = {
        "crops": [crops.gather_crops_batch],
        "cascade": [cascade.cascade_match_classparallel, cascade.cascade_match_batched],
        "assignment": [assignment.insert_rows_batched],
        "reid_block": [reid_block.reid_block64],
    }
    for fns in counters.values():
        for fn in fns:
            fn.launches = 0
    t0 = time.perf_counter()
    results = run.main(args, config, cam_config)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: sum(fn.launches for fn in fns) for name, fns in counters.items()}
    (res,) = results
    if not res.get("csv"):
        raise AssertionError(f"pipeline failed: {res.get('error')}")
    import pandas as pd

    df = pd.read_csv(res["csv"])
    mp4 = os.path.join(out_dir, os.path.basename(path))
    if not (os.path.getsize(res["csv"]) > 0 and os.path.getsize(mp4) > 0):
        raise AssertionError("pipeline wrote no CSV/MP4")
    if res["frames"] != n_frames:
        raise AssertionError(f"pipeline processed {res['frames']} of {n_frames} frames")
    print(f"pipeline: {res['frames']} frames, {res['fps']:.2f} frames/s (CLI wall {wall:.2f} s incl. "
          f"model init and the MP4 pass), {len(df)} CSV rows, {df.track_id.nunique() if len(df) else 0} "
          f"tracks in the zone, counts {res['counts']}, launches {launches}")
    return res["fps"], launches, df


def run_switched(dev, tmp, conf, mapping):
    """The CLI on the first N_SWITCHED frames with the fused ReID block on
    (the environment switch both packages read) and the staged association
    forced. Returns (launches, CSV rows)."""
    from vehicle_counting_tpu_torch.tracking import tracker

    path, zones = write_video(tmp, N_SWITCHED, "cam_switched")
    old_env, old_force = os.environ.get("FORCE_PALLAS_REID_BLOCK"), tracker.FORCE_CASCADE_KERNEL
    os.environ["FORCE_PALLAS_REID_BLOCK"] = "1"
    tracker.FORCE_CASCADE_KERNEL = False
    try:
        _, launches, df = run_pipeline(dev, tmp, path, zones, conf, mapping, N_SWITCHED, "out_switched")
    finally:
        tracker.FORCE_CASCADE_KERNEL = old_force
        if old_env is None:
            os.environ.pop("FORCE_PALLAS_REID_BLOCK")
        else:
            os.environ["FORCE_PALLAS_REID_BLOCK"] = old_env
    for name in ("crops", "assignment", "reid_block"):
        if launches[name] <= 0:
            raise AssertionError(f"the switched path never launched the {name} kernel")
    if launches["cascade"]:
        raise AssertionError("the staged route was forced, yet the fused cascade kernel ran")
    return launches, df


def run_layer1_path(dev, path):
    """K6's stand-alone path (the detector does not call it, as in the JAX
    package): the first 128 frames through the pixel path and yolov5s
    layer 0 (bf16), then layer 1 as K6 on those activations, the main
    path's [128, 192, 320, 32]; held against the detector's own layer 1
    (cuDNN bf16, which rounds the conv sum, the bias add and SiLU each to
    bf16: up to 4 bf16 ulps, so rtol 3.2e-2, atol 2e-2). Returns K6's
    launches in that run."""
    import torch

    from vehicle_counting_tpu_torch.models.layers import conv_block_nchw
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, cast_params, init_yolov5
    from vehicle_counting_tpu_torch.ops import conv_s2, true_div
    from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw, host_letterbox_yuv420, yuv420_content_to_full, yuv420_to_rgb_u8_planar
    from vehicle_counting_tpu_torch.ops.reid_block import hwio

    net = autoshape_hw(SRC_HW, 640)
    yp = cast_params(init_yolov5(torch.Generator().manual_seed(0), YoloConfig(VARIANT, 80), dev), torch.bfloat16)
    yuv = torch.from_numpy(host_letterbox_yuv420(first_batch(path, 128), net, content_only=True)).to(dev)
    conv_s2.conv1_s2_silu.launches = 0
    with torch.no_grad():
        rgb = yuv420_to_rgb_u8_planar(yuv420_content_to_full(yuv, SRC_HW, net))
        x0 = conv_block_nchw(yp["0"], true_div(rgb.to(torch.float32), 255.0).to(torch.bfloat16), stride=2, padding=2)
        got = conv_s2.conv1_s2_silu(x0.permute(0, 2, 3, 1).contiguous(), hwio(yp["1"]["w"]), yp["1"]["b"])
        torch.cuda.synchronize()
        launches = conv_s2.conv1_s2_silu.launches
        want = conv_block_nchw(yp["1"], x0, stride=2).permute(0, 2, 3, 1)
    err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=3.2e-2, atol=2e-2)
    print(f"layer-1 path: K6 on yolov5s layer 0's output {list(x0.permute(0, 2, 3, 1).shape)} bf16, "
          f"{launches} launch(es); max |diff| vs the detector's layer 1 {err:.3e}")
    if launches <= 0:
        raise AssertionError("the layer-1 path never launched the K6 kernel")
    return launches


def check_parity(dev, path):
    """One f32 step (B=16, yolov5s, K=64) on the card vs the CPU; the
    threshold sits in a gap of the CPU scores so neither side is near it.
    Then the card's step through the staged route (K4) vs the K2 route,
    and both routes' tracker time per frame on the step's detections.
    Returns that timing."""
    import torch

    from vehicle_counting_tpu_torch.ops import assignment
    from vehicle_counting_tpu_torch.pipeline.step import detect_embed_core, tracker_scan
    from vehicle_counting_tpu_torch.tracking import tracker
    from vehicle_counting_tpu_torch.models.reid import init_reid
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, decode_predictions, init_yolov5, yolov5_forward_nchw
    from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw, host_letterbox_yuv420, yuv420_content_to_full, yuv420_to_rgb_u8_planar
    from vehicle_counting_tpu_torch.pipeline.step import pipeline_batch_step
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, init_states
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    b = 16
    net = autoshape_hw(SRC_HW, 640)
    cfg = YoloConfig(VARIANT, 80)
    yp = init_yolov5(torch.Generator().manual_seed(0), cfg)
    rp, rs = init_reid(torch.Generator().manual_seed(1))
    yuv = torch.from_numpy(host_letterbox_yuv420(first_batch(path, b), net, content_only=True))
    with torch.no_grad():
        rgb = yuv420_to_rgb_u8_planar(yuv420_content_to_full(yuv, SRC_HW, net)).float() / 255.0
        heads = [h.permute(0, 2, 3, 1) for h in yolov5_forward_nchw(yp, rgb)]
        dec = decode_predictions(heads, cfg)
    s_all, c_all = dec["scores"].numpy().ravel(), dec["classes"].numpy().ravel()
    s = np.sort(np.unique(s_all))[::-1]
    n = 20 * b
    gaps = s[n // 3 : 3 * n] - s[n // 3 + 1 : 3 * n + 1]
    i = n // 3 + int(np.argmax(gaps))
    conf = float((s[i] + s[i + 1]) / 2)
    top4 = [c for c, _ in collections.Counter(c_all[s_all > conf].tolist()).most_common(4)]
    lut = np.full(80, -1, np.int32)
    lut[top4] = np.arange(len(top4))
    hp = DeepSortParams(tracker=TrackerParams(), num_classes=4)
    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, d) for v in tree]
        return tree.to(d)

    def step(d):
        with torch.no_grad():
            _, det, tout = pipeline_batch_step(
                to(yp, d), to(rp, d), to(rs, d), init_states(hp, d), yuv.to(d), torch.ones(b, dtype=torch.bool, device=d),
                torch.from_numpy(lut).to(d), ycfg=cfg, hp=hp, image_size=net, src_hw=SRC_HW,
                conf_thres=conf, iou_thres=0.45, max_det=300, dtype=torch.float32)
        return det, tout

    outs = {}
    for d in ("cpu", dev):
        det, tout = step(d)
        outs[str(d)] = ({k: v.cpu() for k, v in det.items()}, [x.cpu() for x in tout])
    (dc, tc), (dg, tg) = outs["cpu"], outs[str(dev)]
    gap = float(s[i] - s[i + 1])
    if not torch.equal(dc["valid"], dg["valid"]) or not torch.equal(dc["classes"], dg["classes"]):
        raise AssertionError("parity: detections differ between card and CPU")
    box_err = float((dc["boxes"] - dg["boxes"]).abs().max())
    if not (torch.equal(tc[3], tg[3]) and torch.equal(tc[1], tg[1])):
        raise AssertionError("parity: track ids/mask differ between card and CPU")
    print(f"parity: f32 B={b} card == CPU: {int(dc['valid'].sum())} detections (threshold gap {gap:.2e}), "
          f"{int(tc[3].sum())} track outputs, ids equal, max det box diff {box_err:.2e} px, "
          f"track boxes equal: {torch.equal(tc[0], tg[0])}")

    # the same step on the card through the staged route (K4 per stage)
    old = tracker.FORCE_CASCADE_KERNEL
    tracker.FORCE_CASCADE_KERNEL = False
    try:
        assignment.insert_rows_batched.launches = 0
        det_s, tout_s = step(dev)
        torch.cuda.synchronize()
        k4 = assignment.insert_rows_batched.launches
    finally:
        tracker.FORCE_CASCADE_KERNEL = old
    if k4 <= 0:
        raise AssertionError("staged route: the assignment kernel was never launched")
    ts = [x.cpu() for x in tout_s]
    for name, i in (("boxes", 0), ("ids", 1), ("mask", 3)):
        if not torch.equal(ts[i], tg[i]):
            raise AssertionError(f"staged route (K4) and K2 route differ on the card: track {name}")
    print(f"staged vs fused on the card: track ids, mask and boxes equal ({int(ts[3].sum())} track outputs, "
          f"{k4} K4 launches for {b} frames)")

    # tracker time per frame, K2 route vs staged route, in turns, on the
    # step's detections and features
    with torch.no_grad():
        det_s, feats = detect_embed_core(
            to(yp, dev), to(rp, dev), to(rs, dev), yuv.to(dev), torch.ones(b, dtype=torch.bool, device=dev),
            torch.from_numpy(lut).to(dev), ycfg=cfg, hp=hp, image_size=net, src_hw=SRC_HW,
            conf_thres=conf, iou_thres=0.45, max_det=300, dtype=torch.float32)

    def scan_ms(staged):
        tracker.FORCE_CASCADE_KERNEL = False if staged else old
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                tracker_scan(init_states(hp, dev), det_s, feats, hp=hp, src_hw=SRC_HW)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / b
        finally:
            tracker.FORCE_CASCADE_KERNEL = old

    scan_ms(False), scan_ms(True)  # warm-up
    t = {"k2": [], "staged": []}
    for staged in (False, True, True, False):
        t["staged" if staged else "k2"].append(scan_ms(staged))
    print(f"tracker ms/frame (B={b}, f32, host clock): K2 route {t['k2']}, staged route {t['staged']}")
    return t


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the card", file=sys.stderr)
        return 2
    try:
        from vehicle_counting_tpu_torch import _build  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is not importable from {os.getcwd()}: {e}", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    phase("build", card)
    t0 = time.perf_counter()
    _build.load_all(KERNELS)
    for name in KERNELS:
        log = _build.BUILD_LOGS.get(name, "(cached)").splitlines()
        print(f"built {name}: {[ln.strip() for ln in log if 'registers' in ln or 'spill' in ln][-4:]}")
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")

    phase("K1 crop gather", card)
    k1 = check_k1(dev)
    phase("K2/K3 association", card)
    k2 = check_k2(dev)
    phase("K4 batched assignment", card)
    k4 = check_k4(dev)
    phase("K5 fused ReID stage-1 block", card)
    k5 = check_k5(dev)
    phase("embed A/B: ReID embed with K5 off and on", card)
    emb = embed_ab(dev)
    phase("K6 layer-1 conv", card)
    k6 = check_k6(dev)

    with tempfile.TemporaryDirectory() as tmp:
        path, zones = write_video(tmp)
        phase("calibration", card)
        conf, mapping = calibrate(dev, path)
        print(f"min_conf {conf:.6f}, mapping {mapping}")
        phase("pipeline", card)
        fps, launches, df = run_pipeline(dev, tmp, path, zones, conf, mapping)
        for name in ("crops", "cascade"):
            if launches[name] <= 0:
                raise AssertionError(f"the main path never launched the {name} kernel")
        phase("switched pipeline: fused ReID block + staged association", card)
        launches_sw, df_sw = run_switched(dev, tmp, conf, mapping)
        n_default = df[df.frame_id < N_SWITCHED].track_id.nunique() if len(df) else 0
        n_switched = df_sw.track_id.nunique() if len(df_sw) else 0
        print(f"tracks in the zone over the first {N_SWITCHED} frames: switched run {n_switched}, "
              f"default run {n_default} (not asserted equal: K5 rounds each block's output to bf16)")
        phase("layer-1 path (K6, stand-alone)", card)
        launches_k6 = run_layer1_path(dev, path)
        phase("parity", card)
        scan = check_parity(dev, path)

    kernels = [
        dict(name="crop_gather", route="cuda", source="vehicle_counting_tpu_torch/csrc/crops.cu",
             replaces="vehicle_counting_tpu/ops/pallas/crops.py:240", launches=launches["crops"], **k1),
        dict(name="cascade_match", route="cuda", source="vehicle_counting_tpu_torch/csrc/cascade.cu",
             replaces="vehicle_counting_tpu/ops/pallas/cascade.py:887", launches=launches["cascade"], **k2),
        dict(name="insert_rows", route="cuda", source="vehicle_counting_tpu_torch/csrc/assignment.cu",
             replaces="vehicle_counting_tpu/ops/pallas/assignment.py:179", launches=launches_sw["assignment"],
             path="switched", **k4),
        dict(name="reid_block64", route="cuda", source="vehicle_counting_tpu_torch/csrc/reid_block.cu",
             replaces="vehicle_counting_tpu/ops/pallas/reid_block.py:139", launches=launches_sw["reid_block"],
             path="switched", **k5),
        dict(name="conv1_s2_silu", route="cuda", source="vehicle_counting_tpu_torch/csrc/conv_s2.cu",
             replaces="vehicle_counting_tpu/ops/pallas/conv_s2.py:181", launches=launches_k6,
             path="layer-1 stand-alone", **k6["bfloat16"], f32=k6["float32"]),
    ]
    print(f"pipeline frames/s: {fps:.2f} [{card}]")
    print(f"embed ms/frame, bf16: K5 off {emb['off']:.4f}, K5 on {emb['on']:.4f} [{card}]")
    print(f"tracker ms/frame, f32 B=16: K2 route min {min(scan['k2']):.4f}, staged route min "
          f"{min(scan['staged']):.4f} [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
