#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (vehicle_counting_tpu_torch).

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, each fatal on failure:
  build     compile the hand-written kernels (csrc/*.cu) with nvcc;
  K1        crop gather kernel vs its plain version on the card, array-equal,
            at the main path's shapes (B=128 planar 384x640 u8 frames,
            128 crops incl. edge and clamp boxes);
  K2        association kernel (and its per-class entry K3) vs the plain
            version, bitwise, at C=4, K=64, max_age=30 (random, tie, empty);
  pipeline  the CLI main path on a synthetic 256-frame 1280x720 video:
            yolov5s random init, default config (detect_batch 128, bf16),
            a calibrated min_conf and a 4-class mapping; asserts the CSV and
            MP4 and that both kernels were launched by that run;
  parity    one f32 step on the card vs the same step on the CPU (plain
            versions): detections and track ids equal.
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
VARIANT = "yolov5s"


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


def write_video(tmp):
    """256 frames of 1280x720: a fixed textured background with coloured
    boxes driving across, and the zone file the CLI needs."""
    import cv2

    rng = np.random.default_rng(SEED + 3)
    h, w = SRC_HW
    bg = cv2.resize(rng.integers(0, 256, (h // 8, w // 8, 3), dtype=np.uint8), (w, h))
    cars = [(rng.integers(0, h - 120), rng.uniform(-9, 9), rng.integers(40, 160), rng.integers(30, 120),
             tuple(int(c) for c in rng.integers(0, 256, 3))) for _ in range(24)]
    path = os.path.join(tmp, "cam_smoke.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (w, h))
    for t in range(N_FRAMES):
        img = bg.copy()
        for i, (y, vx, bw, bh, color) in enumerate(cars):
            x = int((i * 53 + vx * t) % (w - bw))
            cv2.rectangle(img, (x, int(y)), (x + int(bw), int(y) + int(bh)), color, -1)
        writer.write(img)
    writer.release()
    zones = os.path.join(tmp, "zones")
    os.makedirs(zones)
    with open(os.path.join(zones, "cam_smoke.json"), "w") as f:
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


def run_pipeline(dev, tmp, path, zones, conf, mapping):
    """The CLI main path; returns frames/s and the counters of that run."""
    import torch

    from vehicle_counting_tpu_torch import run
    from vehicle_counting_tpu_torch.ops import cascade, crops

    out_dir = os.path.join(tmp, "out")
    args = run.parser.parse_args([
        "--input_path", path, "--output_path", out_dir, "--device", str(dev),
        "--mapping", json.dumps(mapping),
    ])
    config, cam_config = run.load_configs(args)  # the packaged defaults
    config.min_conf = conf
    cam_config.zone_path = zones
    crops.gather_crops_batch.launches = 0
    cascade.cascade_match_classparallel.launches = 0
    cascade.cascade_match_batched.launches = 0
    t0 = time.perf_counter()
    results = run.main(args, config, cam_config)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {
        "crops": crops.gather_crops_batch.launches,
        "cascade": cascade.cascade_match_classparallel.launches + cascade.cascade_match_batched.launches,
    }
    (res,) = results
    if not res.get("csv"):
        raise AssertionError(f"pipeline failed: {res.get('error')}")
    import pandas as pd

    df = pd.read_csv(res["csv"])
    mp4 = os.path.join(out_dir, "cam_smoke.mp4")
    if not (os.path.getsize(res["csv"]) > 0 and os.path.getsize(mp4) > 0):
        raise AssertionError("pipeline wrote no CSV/MP4")
    if res["frames"] != N_FRAMES:
        raise AssertionError(f"pipeline processed {res['frames']} of {N_FRAMES} frames")
    print(f"pipeline: {res['frames']} frames, {res['fps']:.2f} frames/s (CLI wall {wall:.2f} s incl. "
          f"model init and the MP4 pass), {len(df)} CSV rows, {df.track_id.nunique() if len(df) else 0} "
          f"tracks in the zone, counts {res['counts']}, launches {launches}")
    return res["fps"], launches


def check_parity(dev, path):
    """One f32 step (B=16, yolov5s, K=64) on the card vs the CPU; the
    threshold sits in a gap of the CPU scores so neither side is near it."""
    import torch

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

    outs = {}
    for d in ("cpu", dev):
        with torch.no_grad():
            _, det, tout = pipeline_batch_step(
                to(yp, d), to(rp, d), to(rs, d), init_states(hp, d), yuv.to(d), torch.ones(b, dtype=torch.bool, device=d),
                torch.from_numpy(lut).to(d), ycfg=cfg, hp=hp, image_size=net, src_hw=SRC_HW,
                conf_thres=conf, iou_thres=0.45, max_det=300, dtype=torch.float32)
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
    for name in ("crops", "cascade"):
        _build.load(name)
        print(f"built {name}: {_build.BUILD_LOGS.get(name, '(cached)').splitlines()[-1:]}")
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")

    phase("K1 crop gather", card)
    k1 = check_k1(dev)
    phase("K2/K3 association", card)
    k2 = check_k2(dev)

    with tempfile.TemporaryDirectory() as tmp:
        path, zones = write_video(tmp)
        phase("calibration", card)
        conf, mapping = calibrate(dev, path)
        print(f"min_conf {conf:.6f}, mapping {mapping}")
        phase("pipeline", card)
        fps, launches = run_pipeline(dev, tmp, path, zones, conf, mapping)
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"the main path never launched the {name} kernel")
        phase("parity", card)
        check_parity(dev, path)

    kernels = [
        dict(name="crop_gather", route="cuda", source="vehicle_counting_tpu_torch/csrc/crops.cu",
             replaces="vehicle_counting_tpu/ops/pallas/crops.py:240", launches=launches["crops"], **k1),
        dict(name="cascade_match", route="cuda", source="vehicle_counting_tpu_torch/csrc/cascade.cu",
             replaces="vehicle_counting_tpu/ops/pallas/cascade.py:887", launches=launches["cascade"], **k2),
    ]
    print(f"pipeline frames/s: {fps:.2f} [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
