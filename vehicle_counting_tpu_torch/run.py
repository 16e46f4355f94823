"""Vehicle counting CLI on PyTorch + CUDA, with the reference run.py's flags.

    python -m vehicle_counting_tpu_torch.run --input_path <video-or-dir> \
        --output_path <dir> [--mapping coco|'{"2": 1, ...}'] [--debug] [--no_visualize] \
        [--detect_only] [--device cuda|cpu] [--profile [DIR]] [--check_numerics]

--detect_only writes {cam}_detections.csv per video (no tracking; score it
with `python -m vehicle_counting_tpu_torch.evaluation`). --weight takes an
ultralytics yolov5 v6.0 `.pt` (or an `.npz` state dict); the ReID
checkpoint is `checkpoint:` in cam_configs.yaml. Without them the detector
and ReID weights are random-init from fixed seeds: nothing is downloaded.
--multicam and --frame_parallel, whose paths the port does not have yet,
raise instead of being ignored.
"""

from __future__ import annotations

import argparse
import json
import os

parser = argparse.ArgumentParser(description="Perform Counting vehicles (PyTorch + CUDA)")
parser.add_argument("--weight", type=str, default=None, help="yolov5 checkpoint (.pt / .npz); random init without it")
parser.add_argument("--input_path", type=str, required=True, help="video file or directory")
parser.add_argument("--output_path", type=str, required=True, help="directory for CSV/MP4 outputs")
parser.add_argument("--gpus", type=str, default="0", help="accepted for parity with the reference; use --device")
parser.add_argument("--device", type=str, default="cuda", help="torch device ('cuda', 'cuda:1', 'cpu')")
parser.add_argument("--debug", action="store_true", help="print per-stage timing per video")
parser.add_argument("--mapping", default=None,
                    help="'coco' for the COCO->vehicle mapping, or a JSON object {detector class: tracked class}")
parser.add_argument("--config", type=str, default=None, help="path to configs.yaml override")
parser.add_argument("--cam_config", type=str, default=None, help="path to cam_configs.yaml override")
parser.add_argument("--no_visualize", action="store_true", help="skip the annotated-MP4 second pass")
parser.add_argument("--profile", nargs="?", const="vct_trace", default=None, metavar="DIR",
                    help="torch.profiler Chrome trace of the batch loop into DIR (default ./vct_trace); one event per "
                         "host op and device kernel, ~160 MB per 128-frame batch and the run several times slower: profile a "
                         "short clip, then "
                         "python -m vehicle_counting_tpu_torch.tools.profile_summary DIR")
parser.add_argument("--check_numerics", action="store_true",
                    help="raise at the first non-finite detection or tracker state (one extra sync per batch)")
parser.add_argument("--detect_only", action="store_true",
                    help="detection-only pass: per-frame detections CSV, no tracking")
# paths of the reference package that are not ported yet: they raise
parser.add_argument("--multicam", action="store_true", help="not yet ported")
parser.add_argument("--frame_parallel", action="store_true", help="not yet ported")

_NOT_PORTED = ("multicam", "frame_parallel")


def _mapping_dict(mapping):
    from vehicle_counting_tpu_torch.models.detector import COCO_VEHICLE_MAPPING

    if mapping is None:
        return None
    if mapping == "coco":
        return COCO_VEHICLE_MAPPING
    return {int(k): int(v) for k, v in json.loads(mapping).items()}


def main(args, config, cam_config):
    from vehicle_counting_tpu_torch.pipeline import CountingPipeline

    if getattr(args, "multicam", False) and args.detect_only:
        raise SystemExit(
            "--multicam is incompatible with --detect_only (camera sharding "
            "drives the full detect+track step). For multi-device detection "
            "use --frame_parallel instead."
        )
    for flag in _NOT_PORTED:
        if getattr(args, flag, None):
            raise SystemExit(f"--{flag} is not yet ported to vehicle_counting_tpu_torch")
    args.mapping_dict = _mapping_dict(args.mapping)
    print(config)
    pipeline = CountingPipeline(args, config, cam_config)
    if args.detect_only:
        results = [pipeline.run_video_detect_only(p) for p in pipeline.all_video_paths]
        for r in results:
            print(f"{r['csv']}: {r['frames']} frames @ {r['fps']:.1f} fps")
        return results
    results = pipeline.run(visualize=not args.no_visualize)
    for r in results:
        if r.get("csv"):
            print(f"{r['csv']}: {r['frames']} frames @ {r['fps']:.1f} fps; counts={r['counts']}")
        else:
            print(f"FAILED {r.get('video')}: {r.get('error')}")
    return results


def load_configs(args):
    """(config, cam_config) from the flags, ./configs/*.yaml, or the defaults."""
    from vehicle_counting_tpu_torch.configs import Config, default_cam_config, default_config

    def pick(path, name, default):
        if path:
            return Config(path)
        local = os.path.join("configs", name)
        return Config(local) if os.path.exists(local) else default()

    return (pick(args.config, "configs.yaml", default_config),
            pick(args.cam_config, "cam_configs.yaml", default_cam_config))


if __name__ == "__main__":
    cli_args = parser.parse_args()
    main(cli_args, *load_configs(cli_args))
