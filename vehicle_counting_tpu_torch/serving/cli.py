"""Export, smoke-test and verify serving artifacts.

Port of `vehicle_counting_tpu/serving/cli.py`, with `--device` (the card
unless `--device cpu`), and `--config` and `--mapping` as `run.py` takes
them (a configs.yaml; the detector-to-tracked class map).

    # a self-contained artifact (weights bundled) for 720p at yolov5s
    python -m vehicle_counting_tpu_torch.serving.cli export --out art \
        [--weight yolov5s.pt|.npz] [--reid_checkpoint ckpt.t7] [--config configs.yaml] [--mapping coco|JSON] \
        [--batch 128] [--src_hw 720 1280] [--detect_only] [--no_bundle] [--device cuda|cpu]

    # load it and run random batches through the exported step
    python -m vehicle_counting_tpu_torch.serving.cli smoke --artifact art

    # fresh-process check: rebuild the live step from the artifact's own
    # config and weights, run chained seeded batches through both, require
    # array-equality, report both paths' time per batch (run it in another
    # process than the export: that is the deployment contract)
    python -m vehicle_counting_tpu_torch.serving.cli verify --artifact art

The detector's weights resolve as in `run.py`: --weight, else
./.cache/<variant>.pt, else one fetch of the COCO checkpoint into it, else
random init from seed 0; the export bundles whichever was resolved. Without
a ReID checkpoint the ReID weights are random-init from seed 1. Each
command prints one JSON line; `verify` exits non-zero on any mismatch.
"""

from __future__ import annotations

import argparse
import json
import time
import types


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _build_pipeline(args):
    """CountingPipeline as a param / config factory (no video is opened)."""
    from vehicle_counting_tpu_torch.configs import Config, default_cam_config, default_config
    from vehicle_counting_tpu_torch.pipeline import CountingPipeline
    from vehicle_counting_tpu_torch.run import _mapping_dict

    config = Config(args.config) if args.config else default_config()
    if args.variant:
        config.model_name = args.variant
    if args.image_size:
        config.image_size = [args.image_size, args.image_size]
    if args.batch:
        config.detect_batch = args.batch
    ns = types.SimpleNamespace(
        input_path="__no_videos__", output_path=args.out, weight=args.weight, mapping_dict=_mapping_dict(args.mapping),
        debug=False, profile=None, check_numerics=False, device=args.device,
    )
    return CountingPipeline(ns, config=config, cam_config=default_cam_config())


def cmd_export(args) -> str:
    import numpy as np

    from vehicle_counting_tpu_torch.serving.artifact import export_detect_step, export_pipeline_step, save_artifact

    pipe = _build_pipeline(args)
    if args.reid_checkpoint:
        from vehicle_counting_tpu_torch.models.reid import cast_conv_weights, load_reid_weights

        reid_params, pipe.reid_stats = load_reid_weights(args.reid_checkpoint, pipe.device)
        pipe.reid_params = cast_conv_weights(reid_params, pipe.dtype)

    src_hw = (args.src_hw[0], args.src_hw[1])
    net_hw = pipe.net_hw(src_hw)
    batch = args.batch or pipe.batch_size
    hp = pipe._cam_params("default")
    kw = dict(ycfg=pipe.ycfg, batch=batch, image_size=net_hw, src_hw=src_hw, conf_thres=pipe.conf_thres,
              iou_thres=pipe.iou_thres, max_det=pipe.max_det, dtype=pipe.dtype, platforms=args.platforms or None)
    t0 = time.perf_counter()
    exported = {"detect_step": export_detect_step(pipe.yolo_params, **kw)}
    if not args.detect_only:
        exported["pipeline_step"] = export_pipeline_step(
            pipe.yolo_params, pipe.reid_params, pipe.reid_stats, hp=hp, frames_format=args.frames_format, **kw)
    weights = None
    if not args.no_bundle:
        weights = {"yolo": pipe.yolo_params, "reid": pipe.reid_params, "reid_stats": pipe.reid_stats}
    save_artifact(
        args.out,
        exported=exported,
        ycfg=pipe.ycfg,
        hp=hp,
        config={
            "batch": batch,
            "src_hw": list(src_hw),
            "image_size": list(net_hw),
            "conf_thres": pipe.conf_thres,
            "iou_thres": pipe.iou_thres,
            "max_det": pipe.max_det,
            "dtype": str(pipe.dtype).replace("torch.", ""),
            "frames_format": args.frames_format,
        },
        class_lut=np.asarray(pipe.class_lut.cpu()),
        weights=weights,
    )
    dt = time.perf_counter() - t0
    print(f"[serving] exported {sorted(exported)} to {args.out} in {dt:.1f}s "
          f"(batch={batch}, src_hw={src_hw}, net_hw={net_hw}, device={pipe.device})")
    return args.out


def _random_frames(rng, cfg, frames_format, device):
    import torch

    from vehicle_counting_tpu_torch.serving.artifact import serving_frames_shape

    fshape = serving_frames_shape(frames_format, cfg["batch"], tuple(cfg["src_hw"]), tuple(cfg["image_size"]))
    return torch.from_numpy(rng.integers(0, 255, fshape, dtype="uint8")).to(device)


def cmd_smoke(args) -> None:
    import numpy as np
    import torch

    from vehicle_counting_tpu_torch.parallel.mesh import tree_to
    from vehicle_counting_tpu_torch.serving.artifact import ServingArtifact
    from vehicle_counting_tpu_torch.utils.device import card_line

    art = ServingArtifact.load(args.artifact)
    cfg = art.manifest["config"]
    dev = art.device
    print(f"[serving] loaded {art.function_names} "
          f"(platforms={art.manifest['functions'][art.function_names[0]]['platforms']})")
    rng = np.random.default_rng(0)
    b = cfg["batch"]
    card = card_line() if dev.type == "cuda" else None
    with torch.no_grad():
        if "pipeline_step" in art.function_names:
            step = art.bound_pipeline_step()
            states = art.init_states()
            frames = _random_frames(rng, cfg, cfg["frames_format"], dev)
            valid = torch.ones((b,), dtype=torch.bool, device=dev)
            t0 = time.perf_counter()
            for _ in range(args.batches):
                states, det, touts = step(states, frames, valid)
            _sync(dev)
            dt = time.perf_counter() - t0
            print(json.dumps({
                "smoke": "pipeline_step", "batches": args.batches, "frames": args.batches * b, "wall_s": dt,
                "fps": args.batches * b / dt, "tracks_last_batch": int(touts.mask.sum()),
                "dets_last_batch": int(det["valid"].sum()), "card": card,
            }))
        else:
            w = tree_to(art.load_weights()["yolo"], dev)
            frames = _random_frames(rng, cfg, "letterboxed_yuv420", dev)
            t0 = time.perf_counter()
            for _ in range(args.batches):
                det = art.detect_step(w, frames)
            _sync(dev)
            dt = time.perf_counter() - t0
            print(json.dumps({
                "smoke": "detect_step", "batches": args.batches, "frames": args.batches * b, "wall_s": dt,
                "fps": args.batches * b / dt, "dets_last_batch": int(det["valid"].sum()), "card": card,
            }))


def _counted():
    """The kernel wrappers a pipeline step can launch, by kernel."""
    from vehicle_counting_tpu_torch.ops import assignment, cascade, crops, reid_block, reid_epilogue, track_frame

    return {"K1": crops.gather_crops_batch, "K2": cascade.cascade_match_classparallel,
            "K3": cascade.cascade_match_batched, "K4": assignment.match_stage_batched, "K5": reid_block.reid_block64,
            "K8": reid_epilogue.reid_epilogue, "K9": track_frame.track_frame_pre, "K10": track_frame.track_frame_post}


def cmd_verify(args) -> None:
    """Fresh-process artifact validation against the live step.

    Loads the artifact (its kernel libraries registered from its own
    `kernels/`), rebuilds the LIVE `pipeline_batch_step` from the
    manifest's static config and the bundled weights, then runs
    `--batches` chained seeded batches through both, requiring
    array-equality of every output (det, track outputs, final states), and
    times each path (a first pass with the frame graph's capture, then a
    steady pass of the same chain; one synchronise per pass). Reports the
    card, the directory each kernel library was loaded from and the
    kernels the artifact's passes launched.
    """
    import os

    import numpy as np
    import torch

    from vehicle_counting_tpu_torch import _build
    from vehicle_counting_tpu_torch.parallel.mesh import tree_to
    from vehicle_counting_tpu_torch.pipeline.step import pipeline_batch_step
    from vehicle_counting_tpu_torch.serving.artifact import ServingArtifact
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerState
    from vehicle_counting_tpu_torch.utils.device import card_line

    art = ServingArtifact.load(args.artifact)
    if "pipeline_step" not in art.function_names or "weights_file" not in art.manifest:
        raise SystemExit("verify needs a pipeline_step artifact with bundled weights "
                         f"(this one has {art.function_names}); re-export without --detect_only/--no_bundle")
    cfg = art.manifest["config"]
    dev = art.device
    w = tree_to(art.load_weights(), dev)
    lut = art.class_lut()
    kw = dict(ycfg=art.ycfg, hp=art.hp, image_size=tuple(cfg["image_size"]), src_hw=tuple(cfg["src_hw"]),
              conf_thres=cfg["conf_thres"], iou_thres=cfg["iou_thres"], max_det=cfg["max_det"],
              dtype=getattr(torch, cfg["dtype"]), frames_format=cfg["frames_format"])
    b = cfg["batch"]
    rng = np.random.default_rng(args.seed)
    batches = [_random_frames(rng, cfg, cfg["frames_format"], dev) for _ in range(args.batches)]
    valid = torch.ones((b,), dtype=torch.bool, device=dev)

    def live(states, frames):
        return pipeline_batch_step(w["yolo"], w["reid"], w["reid_stats"], states, frames, valid, lut, **kw)

    art_step = art.jitted("pipeline_step")

    def exported(states, frames):
        return art_step(w["yolo"], w["reid"], w["reid_stats"], states, frames, valid, lut)

    def run_chain(step):
        states, outs = art.init_states(), []
        _sync(dev)
        t0 = time.perf_counter()
        for fr in batches:
            states, det, touts = step(states, fr)
            outs.append((det, touts))
        _sync(dev)
        first_pass_s = time.perf_counter() - t0
        # on the card the state is the frame runner's own: the next chain moves it on
        final = TrackerState(*(x.clone() for x in states))
        states = art.init_states()
        _sync(dev)
        t0 = time.perf_counter()
        for fr in batches:
            states, _, _ = step(states, fr)
        _sync(dev)
        return final, outs, first_pass_s, time.perf_counter() - t0

    with torch.no_grad():
        s_live, o_live, c_live, t_live = run_chain(live)
        counted = _counted()
        for fn in counted.values():
            fn.launches = 0
        s_art, o_art, c_art, t_art = run_chain(exported)
        launches = {k: fn.launches for k, fn in counted.items()}

    def arrays(det, touts):
        return [det[k] for k in sorted(det)] + list(touts)

    mismatches = 0
    for (dl, tl), (da, ta) in zip(o_live, o_art):
        mismatches += sum(not torch.equal(x, y) for x, y in zip(arrays(dl, tl), arrays(da, ta)))
    mismatches += sum(not torch.equal(x, y) for x, y in zip(s_live, s_art))
    n = args.batches
    report = {
        "verify": "pipeline_step",
        "backend": dev.type,
        "card": card_line() if dev.type == "cuda" else None,
        "kernel_modes": art.manifest.get("kernel_modes", {}),
        "kernels_from": {k: os.path.dirname(_build.library_path(k)) for k in art.manifest["kernels"]},
        "launches": launches,
        "batches": n,
        "batch": b,
        "bit_exact": mismatches == 0,
        "mismatched_arrays": mismatches,
        "live_first_pass_s": c_live,
        "artifact_first_pass_s": c_art,
        "live_ms_per_batch": 1e3 * t_live / n,
        "artifact_ms_per_batch": 1e3 * t_art / n,
        "live_ms_per_frame": 1e3 * t_live / n / b,
        "artifact_ms_per_frame": 1e3 * t_art / n / b,
    }
    print(json.dumps(report))
    if mismatches:
        raise SystemExit(f"artifact outputs diverge from the live step ({mismatches} arrays)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="vct-serving")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("export", help="build a serving artifact directory")
    pe.add_argument("--out", required=True)
    pe.add_argument("--weight", default=None, help=".pt/.npz detector checkpoint")
    pe.add_argument("--reid_checkpoint", default=None, help="ckpt.t7/.npz ReID weights")
    pe.add_argument("--variant", default=None, help="yolov5n/s/m/l/x (default: config)")
    pe.add_argument("--batch", type=int, default=None)
    pe.add_argument("--image_size", type=int, default=None,
                    help="detector size (max dim; AutoShape geometry applies)")
    pe.add_argument("--src_hw", type=int, nargs=2, default=[720, 1280])
    pe.add_argument("--frames_format", default="letterboxed_yuv420",
                    choices=["raw_rgb", "letterboxed_rgb", "letterboxed_yuv420"])
    pe.add_argument("--detect_only", action="store_true")
    pe.add_argument("--no_bundle", action="store_true", help="skip bundling weights into the artifact")
    pe.add_argument("--platforms", nargs="*", default=None,
                    help="export platforms: the device's type only (default: --device's)")
    pe.add_argument("--config", default=None, help="configs.yaml override (default: the packaged one)")
    pe.add_argument("--mapping", default=None,
                    help="'coco' or a JSON object {detector class: tracked class}, as run.py takes (default: "
                         "COCO's vehicles for an 80-class detector)")
    pe.add_argument("--device", default="cuda", help="torch device to build and export on ('cuda', 'cpu')")
    pe.set_defaults(fn=cmd_export)

    ps = sub.add_parser("smoke", help="load an artifact and run random batches")
    ps.add_argument("--artifact", required=True)
    ps.add_argument("--batches", type=int, default=3)
    ps.set_defaults(fn=cmd_smoke)

    pv = sub.add_parser(
        "verify",
        help="fresh-process check: the exported step array-equal to the live step rebuilt from the "
             "artifact's config+weights, with timings")
    pv.add_argument("--artifact", required=True)
    pv.add_argument("--batches", type=int, default=8)
    pv.add_argument("--seed", type=int, default=0)
    pv.set_defaults(fn=cmd_verify)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
