"""Re-runnable end-to-end smoke repro: the port's CLI on a synthetic video + checks.

Port of `vehicle_counting_tpu/tools/e2e_smoke.py`. Reproducible evidence
(not a pytest) that the full CLI surface — video decode, fused
detect+track step on the card (`--device cpu` for a functional check; it
raises without a card otherwise), counting, CSV write, annotated-MP4
second pass — works end to end. Mirrors the reference's driving surface
(the reference `run.py:6-48`: weight/input_path/output_path flags into
CountingPipeline).

    python -m vehicle_counting_tpu_torch.tools.e2e_smoke [--out DIR] [--frames 48]
        [--size 1280x720] [--detect_only] [--keep] [--fast] [--device cuda|cpu]

Generates a synthetic video (moving bright boxes on static noise) plus a
labelme-style zone annotation, invokes `python -m
vehicle_counting_tpu_torch.run` in a subprocess from the repo root (zone_path
is cwd-relative there), then asserts:
  * the counting CSV exists and parses with the exact 10-column schema;
  * the annotated MP4 exists with EXACTLY the source frame count;
  * row/count stats are printed for the record.
Exit status 0 = pass. Weights are random-init unless --weight is given or
the repo root's ./.cache holds the checkpoint (the CLI runs there), so
box contents are meaningless — the checks are structural (schema, frame
counts, pipeline health), which is what a no-egress environment can pin.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
CSV_SCHEMA = [
    "track_id", "frame_id", "box", "color", "label", "direction",
    "fpoint", "lpoint", "fframe", "lframe",
]


def make_video(path: str, n_frames: int, w: int, h: int, fps: float = 20.0) -> None:
    """Moving bright rectangles over a fixed noise background."""
    import cv2

    rng = np.random.default_rng(1702)
    bg = rng.integers(0, 80, size=(h, w, 3), dtype=np.uint8)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    assert writer.isOpened(), f"cv2 VideoWriter failed for {path}"
    for t in range(n_frames):
        img = bg.copy()
        for j, (speed, y, bw, bh) in enumerate(
            [(9, 0.3, 90, 60), (7, 0.55, 120, 80), (5, 0.75, 70, 50)]
        ):
            x = (30 + t * speed + j * w // 3) % max(w - bw, 1)
            yy = int(h * y)
            color = [(255, 255, 255), (40, 220, 240), (220, 160, 40)][j]
            cv2.rectangle(img, (x, yy), (x + bw, yy + bh), color, -1)
        writer.write(img)
    writer.release()


def make_zone(path: str, w: int, h: int) -> None:
    """Zone covering most of the frame + two opposite direction rays."""
    mx, my = w // 8, h // 8
    zone = {
        "shapes": [
            {"label": "zone",
             "points": [[mx, my], [w - mx, my], [w - mx, h - my], [mx, h - my]]},
            {"label": "direction01", "points": [[mx, h // 2], [w - mx, h // 2]]},
            {"label": "direction02", "points": [[w - mx, h // 2], [mx, h // 2]]},
        ]
    }
    with open(path, "w") as f:
        json.dump(zone, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="work dir (default: mkdtemp)")
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--size", default="1280x720", help="WxH of the source video")
    ap.add_argument("--weight", default=None, help="optional real checkpoint")
    ap.add_argument("--detect_only", action="store_true",
                    help="also exercise the detection-only CSV path")
    ap.add_argument("--keep", action="store_true", help="keep the work dir")
    ap.add_argument("--fast", action="store_true",
                    help="small model/batch config (CPU-feasible smoke)")
    ap.add_argument("--device", default="cuda", help="torch device of the run ('cpu' for a functional check)")
    args = ap.parse_args(argv)

    from vehicle_counting_tpu_torch.utils.device import require_device

    require_device(args.device)  # no card and no --device cpu: raise here, not in the subprocess

    w, h = (int(v) for v in args.size.split("x"))
    work = args.out or tempfile.mkdtemp(prefix="vct_e2e_smoke_")
    os.makedirs(work, exist_ok=True)
    cam = "cam_s1"
    video = os.path.join(work, f"{cam}.mp4")
    zones = os.path.join(work, "zones")
    out_dir = os.path.join(work, "out")
    os.makedirs(zones, exist_ok=True)
    make_video(video, args.frames, w, h)
    make_zone(os.path.join(zones, f"{cam}.json"), w, h)

    # cam_config override pointing zone_path at the generated zones
    cam_cfg = os.path.join(work, "cam_configs.yaml")
    with open(cam_cfg, "w") as f:
        f.write(
            "settings:\n"
            f"  zone_path: {zones!r}\n"
            "  checkpoint: null\n"
            "  cam:\n"
            "    default:\n"
            "      tracking_config:\n"
            "        MAX_DIST: 0.2\n"
            "        MIN_CONFIDENCE: 0.25\n"
            "        NMS_MAX_OVERLAP: 0.5\n"
            "        MAX_IOU_DISTANCE: 0.6\n"
            "        MAX_AGE: 30\n"
            "        N_INIT: 3\n"
            "        NN_BUDGET: 60\n"
        )

    cmd = [
        sys.executable, "-m", "vehicle_counting_tpu_torch.run",
        "--input_path", video, "--output_path", out_dir,
        "--cam_config", cam_cfg, "--mapping", "coco", "--device", args.device,
    ]
    if args.fast:
        cfg = os.path.join(work, "configs.yaml")
        with open(cfg, "w") as f:
            f.write(
                "settings:\n"
                "  model_name: 'yolov5n'\n"
                "  min_iou: 0.45\n  min_conf: 0.25\n  max_det: 64\n"
                "  image_size: [320, 320]\n  keep_ratio: True\n"
                "  detect_batch: 8\n  compute_dtype: 'float32'\n"
                "  max_tracks_per_class: 32\n  max_dets_per_class: 32\n"
                "  thin_upload: true\n"
            )
        cmd += ["--config", cfg]
    if args.weight:
        cmd += ["--weight", args.weight]
    if args.detect_only:
        cmd += ["--detect_only"]
    print(f"[e2e_smoke] running: {' '.join(cmd)}", flush=True)
    env = dict(os.environ, PYTHONPATH=REPO_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(cmd, cwd=REPO_ROOT, env=env, text=True, capture_output=True)
    sys.stdout.write(proc.stdout[-4000:])
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        print(f"[e2e_smoke] FAIL: the CLI exited rc={proc.returncode}")
        return 1

    failures = []
    csv_path = os.path.join(out_dir, f"{cam}.csv")
    if not os.path.exists(csv_path):
        failures.append(f"missing CSV {csv_path}")
    else:
        import pandas as pd

        df = pd.read_csv(csv_path)
        if args.detect_only:
            print(f"[e2e_smoke] detect-only CSV rows: {len(df)}")
        elif list(df.columns) != CSV_SCHEMA:
            failures.append(f"CSV schema mismatch: {list(df.columns)}")
        else:
            print(f"[e2e_smoke] counting CSV rows: {len(df)} "
                  f"(tracks: {df.track_id.nunique() if len(df) else 0})")

    if not args.detect_only:
        mp4 = os.path.join(out_dir, f"{cam}.mp4")
        if not os.path.exists(mp4):
            failures.append(f"missing annotated MP4 {mp4}")
        else:
            import cv2

            cap = cv2.VideoCapture(mp4)
            got = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            cap.release()
            print(f"[e2e_smoke] annotated MP4 frames: {got} (want {args.frames})")
            if got != args.frames:
                failures.append(f"MP4 frame count {got} != {args.frames}")

    if not args.keep and not args.out:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    if failures:
        print("[e2e_smoke] FAIL:\n  " + "\n  ".join(failures))
        return 1
    print("[e2e_smoke] PASS")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
