"""End-to-end counting pipeline (reference: modules/__init__.py).

Port of `vehicle_counting_tpu/pipeline/__init__.py::CountingPipeline`
(`__init__`, `run_video`, `run_video_detect_only`). Per video: decode frame
batches on the host, letterbox + pack I420 (or, with `thin_upload: false`,
nothing: the raw frames) and upload one batch ahead in a worker thread,
run the fused detect+track step (`pipeline/step.py`) on the device, read
back the small [B, C, K] track outputs one batch behind, then zone
filtering, direction assignment, CSV and the annotated MP4 on the host
(this package's `counting/` and `data/` modules). With `frame_parallel`
in the config and more than one device in the mesh, each batch's frames
are split over the devices for detection and embedding
(`parallel/frames.py`); on one device that is a no-op, as in the JAX
package.

Artifacts: {output}/{cam}.csv with the reference's 10-column schema and
{output}/{cam}.mp4; zone annotation at {zone_path}/{cam}.json. The
detect-only pass writes {output}/{cam}_detections.csv instead
(frame_id,x1,y1,x2,y2,score,label).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from vehicle_counting_tpu_torch.configs import Config, default_cam_config, default_config
from vehicle_counting_tpu_torch.counting import VehicleCounter, count_directions
from vehicle_counting_tpu_torch.counting.visualize import visualize_merged
from vehicle_counting_tpu_torch.data.video import VideoReader, VideoWriter, list_videos
from vehicle_counting_tpu_torch.models.detector import (
    COCO_VEHICLE_MAPPING,
    VEHICLE_CLASS_NAMES,
    class_lut,
)
from vehicle_counting_tpu_torch.utils.device import on_device, require_device
from vehicle_counting_tpu_torch.utils.profiling import StageTimer, trace
from vehicle_counting_tpu_torch.utils.transfer import parallel_device_put


def prefetch(fetch, prep):
    """One-batch-ahead prefetch: runs prep(fetch()) for the NEXT batch in a
    worker thread while the caller consumes the current one. `fetch`
    returns the next raw batch or None at the end of the stream."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=1)

    def produce():
        batch = fetch()
        return None if batch is None else prep(batch)

    try:
        fut = pool.submit(produce)
        while True:
            got = fut.result()
            if got is None:
                return
            fut = pool.submit(produce)
            yield got
    finally:
        pool.shutdown()


def check_step_finite(det, states, frame_id) -> None:
    """--check_numerics: raise at the first non-finite box or score among
    the step's valid detections, or Kalman mean or covariance in the
    tracker state it leaves (the track boxes read back are integer pixels,
    which hide a NaN). One device->host sync per batch."""
    valid = det["valid"]
    for name in ("boxes", "scores"):
        if not bool(torch.isfinite(det[name][valid]).all()):
            raise FloatingPointError(f"non-finite detection {name} in batch at frame {frame_id}")
    for name in ("mean", "cov"):
        if not bool(torch.isfinite(getattr(states, name)).all()):
            raise FloatingPointError(f"non-finite tracker {name} after the batch at frame {frame_id}")


def upload_shards(host: np.ndarray, mesh) -> tuple:
    """A host batch split into the mesh's equal shards along axis 0, each
    uploaded straight to its own device (no device holds the whole batch)."""
    n = len(host) // mesh.size
    return tuple(parallel_device_put(host[i * n:(i + 1) * n], device=d) for i, d in enumerate(mesh.devices))


class CountingPipeline:
    """Mirror of the reference CountingPipeline surface, on one torch device
    (or, with `frame_parallel`, the front on every device of `mesh`)."""

    def __init__(self, args, config: Optional[Config] = None, cam_config: Optional[Config] = None, mesh=None):
        from vehicle_counting_tpu_torch.models.reid import cast_conv_weights, init_reid, load_reid_weights
        from vehicle_counting_tpu_torch.models.yolo import cast_params, config_for_params, init_yolov5
        from vehicle_counting_tpu_torch.models.yolo import default_config as yolo_default_config

        self.config = config or default_config()
        self.cam_config = cam_config or default_cam_config()
        self.args = args
        self.video_path = args.input_path
        self.saved_path = args.output_path
        self.zone_path = self.cam_config.zone_path
        os.makedirs(self.saved_path or ".", exist_ok=True)
        self.device = require_device(getattr(args, "device", None))

        self.dtype = torch.float32 if self.config.compute_dtype == "float32" else torch.bfloat16
        if self.dtype == torch.float32 and self.device.type == "cuda":
            # f32 means f32: cuDNN convs default to TF32 on the card
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False

        # ---- detector: --weight, else ./.cache/<variant>.pt, else the COCO
        # checkpoint fetched into it, else random init from a seed (the
        # JAX package's order, networks/yolo.py:14-17)
        weight = getattr(args, "weight", None)
        variant = self.config.model_name or "yolov5s"
        if not weight:
            from vehicle_counting_tpu_torch.utils.download import get_model_weights

            weight = get_model_weights(variant)
        if weight:
            from vehicle_counting_tpu_torch.models.convert import load_yolov5_weights

            yolo_params = load_yolov5_weights(weight, self.device)
            self.ycfg = config_for_params(variant, yolo_params)
            nc = self.ycfg.num_classes
        else:
            nc = 80
            print("[pipeline] no weights available; using a random-init detector (seed 0)")
            self.ycfg = yolo_default_config(variant, nc)
            yolo_params = init_yolov5(torch.Generator().manual_seed(0), self.ycfg, self.device)
        self.yolo_params = cast_params(yolo_params, self.dtype)

        # ---- class mapping -------------------------------------------------
        mapping: Optional[Dict[int, int]] = getattr(args, "mapping_dict", None)
        if mapping is None and nc > 8:
            mapping = COCO_VEHICLE_MAPPING  # the reference CLI's dict (run.py:38-46)
        if mapping:
            self.class_names = list(VEHICLE_CLASS_NAMES)[: max(mapping.values()) + 1]
        else:
            self.class_names = [str(i) for i in range(nc)]
        self.class_lut = torch.from_numpy(class_lut(nc, mapping)).to(self.device)
        self.num_classes = len(self.class_names)

        # ---- ReID ----------------------------------------------------------
        ckpt = self.cam_config.checkpoint or self.config.reid_checkpoint
        if ckpt and os.path.exists(ckpt):
            reid_params, self.reid_stats = load_reid_weights(ckpt, self.device)
        else:
            reid_params, self.reid_stats = init_reid(torch.Generator().manual_seed(1), device=self.device)
        self.reid_params = cast_conv_weights(reid_params, self.dtype)

        # ---- shapes / thresholds ------------------------------------------
        image_size = self.config.image_size or [640, 640]
        self.image_size = (int(image_size[0]), int(image_size[1]))
        self.square_letterbox = bool(getattr(self.config, "square_letterbox", None))
        self.conf_thres = float(self.config.min_conf or 0.25)
        self.iou_thres = float(self.config.min_iou or 0.45)
        self.max_det = int(self.config.max_det) if (self.config.max_det or 0) > 0 else 300
        self.batch_size = int(self.config.detect_batch or 8)
        self.capacity = int(self.config.max_tracks_per_class or 64)
        self.all_video_paths = list_videos(self.video_path)
        # ---- observability --------------------------------------------------
        self.debug = bool(getattr(args, "debug", False))
        profile = getattr(args, "profile", None)
        self.profile_dir = None if not profile else (profile if isinstance(profile, str) else "vct_trace")
        self.last_trace = None  # path of the most recent --profile trace
        self.check_numerics = bool(getattr(args, "check_numerics", False))
        self.last_timer = None
        self.frames_done = 0  # valid frames drained so far in the current video
        self.mesh = mesh  # frame_parallel's devices (parallel/mesh.py); None: every device of this one's type

    @staticmethod
    def get_cam_name(path: str) -> str:
        return os.path.basename(path)[:-4]  # modules/__init__.py:23-26

    def net_hw(self, src_hw):
        """Detector input shape for a video's source shape (AutoShape rule,
        to the detector's largest stride)."""
        from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw

        if self.square_letterbox:
            return self.image_size
        return autoshape_hw(src_hw, self.image_size, stride=max(self.ycfg.strides))

    def _cam_params(self, cam_name: str):
        from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams
        from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams

        cams = self.cam_config.cam or {}
        cfg = cams.get(cam_name) or cams.get("default")
        tc = (cfg or {}).get("tracking_config", {})
        tracker = TrackerParams(
            capacity=self.capacity,
            feat_dim=512,
            budget=int(tc.get("NN_BUDGET", 60)),
            pending_cap=8,
            max_dist=float(tc.get("MAX_DIST", 0.2)),
            max_iou_distance=float(tc.get("MAX_IOU_DISTANCE", 0.6)),
            max_age=int(tc.get("MAX_AGE", 30)),
            n_init=int(tc.get("N_INIT", 3)),
            feat_dtype="float32" if self.dtype == torch.float32 else "bfloat16",
        )
        return DeepSortParams(
            tracker=tracker,
            num_classes=self.num_classes,
            min_confidence=float(tc.get("MIN_CONFIDENCE", 0.25)),
            nms_max_overlap=float(tc.get("NMS_MAX_OVERLAP", 0.5)),
        )

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        return parallel_device_put(host, device=self.device)

    def _frame_parallel_mesh(self):
        """The mesh `frame_parallel` splits a batch over, or None where it
        is a no-op: not asked for, one device, or a batch the device count
        does not divide (said so, as the JAX package does)."""
        if not self.config.frame_parallel:
            return None
        from vehicle_counting_tpu_torch.parallel.mesh import make_mesh

        mesh = self.mesh or make_mesh(None, ("frame",), self.device.type)
        if mesh.size > 1 and self.batch_size % mesh.size == 0:
            return mesh
        if mesh.size > 1:
            print(f"[pipeline] frame_parallel skipped: detect_batch {self.batch_size} not divisible by "
                  f"{mesh.size} devices")
        return None

    def run_video(self, video_path: str, visualize: bool = True) -> Dict:
        """Process one video; returns {'csv', 'counts', 'fps', 'frames'}.
        The pipeline's device is the current CUDA device throughout (the
        kernel wrappers launch on the current device)."""
        with on_device(self.device):
            return self._run_video(video_path, visualize)

    def _run_video(self, video_path: str, visualize: bool) -> Dict:
        from vehicle_counting_tpu_torch.ops.letterbox import content_upload_exact, host_letterbox_yuv420
        from vehicle_counting_tpu_torch.pipeline import step as step_mod
        from vehicle_counting_tpu_torch.tracking.deepsort import init_states

        # thin upload (default): host letterbox + I420; thin_upload: false
        # uploads the raw frames and letterboxes them on the device
        thin = self.config.thin_upload
        thin = True if thin is None else bool(thin)
        cam_name = self.get_cam_name(video_path)
        reader = VideoReader(video_path, batch_size=self.batch_size)
        info = reader.video_info
        src_hw = (info["height"], info["width"])
        hp = self._cam_params(cam_name)
        counter = VehicleCounter(self.class_names, os.path.join(self.zone_path, cam_name + ".json"))

        timer = StageTimer()
        self.last_timer = timer
        rows = {"frames": [], "tracks": [], "labels": [], "boxes": []}
        num_frames = 0
        self.frames_done = 0
        t_start = time.perf_counter()
        net_hw = self.net_hw(src_hw)
        # ship only the letterbox content rows when that is bit-exact
        content_only = content_upload_exact(src_hw, net_hw)
        frames_format = "letterboxed_yuv420" if thin else "raw_rgb"
        kw = dict(ycfg=self.ycfg, hp=hp, image_size=net_hw, src_hw=src_hw, conf_thres=self.conf_thres,
                  iou_thres=self.iou_thres, max_det=self.max_det, dtype=self.dtype, frames_format=frames_format)
        # frame-parallel: the front split by frame over the mesh, the
        # tracker (its state, its frame runner) on the mesh's first device
        mesh = self._frame_parallel_mesh()
        if mesh is not None:
            from vehicle_counting_tpu_torch.parallel.frames import make_framedp_step

            fp_step = make_framedp_step(mesh, **kw)
            track_dev = mesh.devices[0]
        else:
            fp_step, track_dev = None, self.device
        states = init_states(hp, track_dev)
        it = reader.batches()

        def fetch():
            with timer.stage("decode"):
                return next(it, None)

        def prep(batch):
            frames, frame_ids, valid = batch
            if thin:
                with timer.stage("letterbox"):
                    frames = host_letterbox_yuv420(frames, net_hw, content_only=content_only)
            with timer.stage("upload"):
                if mesh is not None:
                    fdev, vdev = upload_shards(frames, mesh), upload_shards(valid, mesh)
                else:
                    fdev, vdev = self._upload(frames), self._upload(valid)
            return fdev, vdev, frame_ids, valid

        def drain(pending):
            nonlocal num_frames
            touts, frame_ids, valid = pending
            with timer.stage("readback"):
                mask = touts.mask.cpu().numpy()  # [B, C, K]
                ids = touts.ids.cpu().numpy()
                boxes = touts.boxes.cpu().numpy()
            num_frames += int(valid.sum())
            self.frames_done = num_frames  # progress, readable from another thread
            b, c, k = np.nonzero(mask)
            if b.size:
                rows["frames"].extend(np.asarray(frame_ids)[b].tolist())
                rows["tracks"].extend(ids[b, c, k].tolist())
                rows["labels"].extend(c.tolist())
                rows["boxes"].extend(boxes[b, c, k])

        if step_mod.use_frame_graph(track_dev):
            # capture the tracker's frame step now: before the upload worker
            # starts and outside a --profile trace
            step_mod.frame_runner(hp, src_hw, track_dev)
        profile_ctx = trace(self.profile_dir) if self.profile_dir else contextlib.nullcontext({})
        pending = None
        try:
            with profile_ctx as traced:
                for fdev, vdev, frame_ids, valid in prefetch(fetch, prep):
                    with timer.stage("dispatch"):
                        if fp_step is not None:
                            states, det, touts = fp_step(self.yolo_params, self.reid_params, self.reid_stats,
                                                         self.class_lut, states, fdev, vdev)
                        else:
                            states, det, touts = step_mod.pipeline_batch_step(
                                self.yolo_params, self.reid_params, self.reid_stats, states,
                                fdev, vdev, self.class_lut, **kw)
                    if self.check_numerics:
                        check_step_finite(det, states, frame_ids[0])
                    if pending is not None:
                        drain(pending)
                    pending = (touts, frame_ids, valid)
                if pending is not None:
                    drain(pending)
        finally:
            # this camera's captured step, its static state and its pool
            step_mod.free_frame_runner(hp, src_hw, track_dev)
        if self.profile_dir:
            self.last_trace = traced["path"]
            print(f"[profile] torch.profiler trace written to {self.last_trace}")

        elapsed = time.perf_counter() - t_start
        fps = num_frames / elapsed if elapsed > 0 else 0.0

        csv_path = os.path.join(self.saved_path, cam_name + ".csv")
        with timer.stage("count"):
            counter.run(rows["frames"], rows["tracks"], rows["labels"],
                        np.asarray(rows["boxes"]) if rows["boxes"] else np.zeros((0, 4)),
                        output_path=csv_path)
        counts = {}
        import pandas as pd

        df = pd.read_csv(csv_path)
        if len(df):
            counts = {k: v.tolist() for k, v in count_directions(df, self.num_classes).items()}
        if visualize:
            with timer.stage("visualize"):
                reader.reinitialize_stream()
                writer = VideoWriter(info, os.path.join(self.saved_path, cam_name + ".mp4"))
                visualize_merged(reader, csv_path, counter.directions, counter.polygons,
                                 self.num_classes, writer)
                writer.release()
        reader.release()
        if self.debug:
            print(f"[debug] {cam_name} per-stage timing:\n{timer.summary()}")
            print(f"[debug] {cam_name} spans (total, mean, count, self):\n{timer.spans()}")
        return {"csv": csv_path, "counts": counts, "fps": fps, "frames": num_frames}

    def run_video_detect_only(self, video_path: str) -> Dict:
        """The detection-only pass (BASELINE config 1): per-frame detections
        CSV {output}/{cam}_detections.csv, columns frame_id, x1, y1, x2, y2,
        score, label, one row per mapped detection in source pixels, frames
        in order and each frame's detections in score order. Same overlap
        as `run_video` (the worker letterboxes + uploads one batch ahead,
        the readback lags one batch) on the same thin-upload I420 pixel
        path. With `frame_parallel`, each device of the mesh detects its
        shard of the batch with its own copy of the weights, and the
        shards are joined in frame order. Returns {'csv', 'frames', 'fps'}."""
        with on_device(self.device):
            return self._run_video_detect_only(video_path)

    def _run_video_detect_only(self, video_path: str) -> Dict:
        import pandas as pd

        from vehicle_counting_tpu_torch.ops.letterbox import content_upload_exact, host_letterbox_yuv420
        from vehicle_counting_tpu_torch.pipeline.step import detect_only_step

        cam_name = self.get_cam_name(video_path)
        reader = VideoReader(video_path, batch_size=self.batch_size)
        info = reader.video_info
        src_hw = (info["height"], info["width"])
        net_hw = self.net_hw(src_hw)
        content_only = content_upload_exact(src_hw, net_hw)
        lut = self.class_lut.cpu().numpy()
        cols = ("frame_id", "x1", "y1", "x2", "y2", "score", "label")
        parts = []
        num_frames = 0
        self.frames_done = 0
        t0 = time.perf_counter()
        it = reader.batches()
        detect = functools.partial(
            detect_only_step, ycfg=self.ycfg, image_size=net_hw, src_hw=src_hw, conf_thres=self.conf_thres,
            iou_thres=self.iou_thres, max_det=self.max_det, dtype=self.dtype, content_only=content_only)
        mesh = self._frame_parallel_mesh()
        if mesh is not None:
            from vehicle_counting_tpu_torch.parallel.mesh import tree_to

            weights = {d: tree_to(self.yolo_params, d) for d in mesh.devices}

        def prep(batch):
            frames, frame_ids, valid = batch
            yuv = host_letterbox_yuv420(frames, net_hw, content_only=content_only)
            return (upload_shards(yuv, mesh) if mesh is not None else self._upload(yuv)), frame_ids, valid

        def drain(pending_):
            nonlocal num_frames
            out, frame_ids, valid = pending_
            boxes, scores = out["boxes"].cpu().numpy(), out["scores"].cpu().numpy()
            classes, ok = out["classes"].cpu().numpy(), out["valid"].cpu().numpy()
            num_frames += int(valid.sum())
            self.frames_done = num_frames
            # row-major nonzero: frames in order, detections in slot order
            b, i = np.nonzero(ok & np.asarray(valid, bool)[:, None])
            cl = classes[b, i]
            mapped = np.where(cl < len(lut), lut[np.clip(cl, 0, len(lut) - 1)], -1)
            keep = mapped >= 0
            b, i = b[keep], i[keep]
            parts.append(pd.DataFrame({
                "frame_id": np.asarray(frame_ids)[b].astype(np.int64),
                "x1": boxes[b, i, 0].astype(np.float64), "y1": boxes[b, i, 1].astype(np.float64),
                "x2": boxes[b, i, 2].astype(np.float64), "y2": boxes[b, i, 3].astype(np.float64),
                "score": scores[b, i].astype(np.float64), "label": mapped[keep].astype(np.int64),
            }, columns=cols))

        pending = None
        with torch.no_grad():
            for ydev, frame_ids, valid in prefetch(lambda: next(it, None), prep):
                if mesh is not None:
                    shards = [detect(weights[d], y) for d, y in zip(mesh.devices, ydev)]
                    out = {k: torch.cat([o[k].to(mesh.devices[0]) for o in shards]) for k in shards[0]}
                else:
                    out = detect(self.yolo_params, ydev)
                if pending is not None:
                    drain(pending)
                pending = (out, frame_ids, valid)
            if pending is not None:
                drain(pending)
        elapsed = time.perf_counter() - t0
        csv_path = os.path.join(self.saved_path, cam_name + "_detections.csv")
        df = pd.concat(parts, ignore_index=True) if parts else pd.DataFrame({c: [] for c in cols})
        df.to_csv(csv_path, index=False)
        reader.release()
        return {"csv": csv_path, "frames": num_frames, "fps": num_frames / elapsed if elapsed > 0 else 0.0}

    def run(self, visualize: bool = True) -> List[Dict]:
        results = []
        for video_path in self.all_video_paths:
            try:
                results.append(self.run_video(video_path, visualize=visualize))
            except Exception as e:  # per-video isolation (modules/__init__.py:29)
                print(f"[pipeline] ERROR on {video_path}: {e!r}")
                results.append({"csv": None, "error": str(e), "video": video_path})
        return results
