"""Concurrent multi-camera counting over a device mesh.

Port of `vehicle_counting_tpu/pipeline/multicam.py`. The reference counts
a directory of videos one by one (modules/__init__.py:29); here all
cameras of a group step together: one step per round carries B frames of
every camera, the cameras sharded over the mesh's 'cam' axis
(`parallel/cameras.py::make_multicam_step`: on each card the front per
camera, one frame scan for its cameras' classes). Without a mesh it is
every visible card for a `device` of "cuda", that card alone for
"cuda:k", and the CPU for "cpu". Each group's camera count is padded to a
multiple of the mesh size with cameras whose frames are all invalid, and
each shard's frames are uploaded straight to its card. The host keeps one
reader and one counter per camera; a camera that runs out of frames
rides along with its frames marked invalid until the group's longest
video ends.

Cameras in one group share the frame geometry and the DeepSORT
hyper-parameters (one step, one captured frame graph). `run` splits the
videos into groups by (geometry, the camera's `tracking_config`), in path
order, so every camera keeps its own cam_configs.yaml parameters, and runs
one loop per group with the serial loop's overlap: the worker thread
decodes, letterboxes and uploads the next round while the cards run this
one, and the readback (every shard's outputs) lags one round.

Artifacts are the serial pipeline's: {output}/{cam}.csv and, with
visualize, {output}/{cam}.mp4. Faults are isolated per video at open
time, per camera at output (a missing zone file fails that camera alone)
and per group in the loop. Every result has the same keys: csv (None on
error), counts ({} on error), camera, video, error (None on success),
frames (the camera's frames) and fps (the group's camera-frames per second
of loop time, 0.0 on error).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from vehicle_counting_tpu_torch.counting import VehicleCounter, count_directions
from vehicle_counting_tpu_torch.counting.visualize import visualize_merged
from vehicle_counting_tpu_torch.data.video import VideoReader, VideoWriter
from vehicle_counting_tpu_torch.pipeline import CountingPipeline, prefetch, upload_shards
from vehicle_counting_tpu_torch.utils.device import on_device
from vehicle_counting_tpu_torch.utils.profiling import StageTimer
from vehicle_counting_tpu_torch.utils.transfer import parallel_device_put


def _failed(camera: str, video: str, error: Exception) -> Dict:
    return {"csv": None, "counts": {}, "camera": camera, "video": video, "error": str(error),
            "frames": 0, "fps": 0.0}


class MultiCamCountingPipeline:
    """Camera-concurrent variant of CountingPipeline (same artifacts), its
    cameras sharded over `mesh` (`parallel/mesh.py::DeviceMesh`; None:
    see the module docstring)."""

    def __init__(self, args, config=None, cam_config=None, mesh=None):
        # all of CountingPipeline's construction: device, models, class map, shapes
        self.base = CountingPipeline(args, config, cam_config)
        self.mesh = mesh

    def _camera_mesh(self):
        """The mesh the cameras are sharded over: the one given, else every
        visible card for a device of "cuda" (JAX's `make_mesh(None,
        ("cam",))`), the one card of "cuda:k", or the CPU."""
        from vehicle_counting_tpu_torch.parallel.mesh import DeviceMesh, make_mesh

        if self.mesh is not None:
            return self.mesh
        dev = self.base.device
        if dev.type == "cuda" and dev.index is None:
            return make_mesh(None, ("cam",), "cuda")
        return DeviceMesh((dev,), ("cam",))

    def run(self, visualize: bool = False) -> List[Dict]:
        """Group the videos by (geometry, tracking params) and run each
        group's loop; results come back in path order."""
        base = self.base
        paths = base.all_video_paths
        results: List[Dict] = [None] * len(paths)
        readers, groups = {}, {}
        for i, path in enumerate(paths):
            cam = base.get_cam_name(path)
            try:
                readers[i] = VideoReader(path, batch_size=base.batch_size)
            except Exception as e:  # per-video isolation at open time
                print(f"[multicam] ERROR opening {path}: {e!r}")
                results[i] = _failed(cam, path, e)
                continue
            info = readers[i].video_info
            groups.setdefault(((info["height"], info["width"]), base._cam_params(cam)), []).append(i)
        for (src_hw, hp), idxs in groups.items():
            try:
                group = self._run_group([readers[i] for i in idxs], hp, src_hw, visualize)
            except Exception as e:  # group-level isolation: the other groups still run
                print(f"[multicam] ERROR in the group of {[paths[i] for i in idxs]}: {e!r}")
                group = [_failed(base.get_cam_name(paths[i]), paths[i], e) for i in idxs]
            finally:
                for i in idxs:
                    readers[i].release()
            for i, res in zip(idxs, group):
                results[i] = res
        return results

    def _run_group(self, readers: List[VideoReader], hp, src_hw: Tuple[int, int], visualize: bool) -> List[Dict]:
        mesh = self._camera_mesh()
        with on_device(mesh.devices[0]):  # the kernel wrappers launch on the current device
            return self._run_group_on_mesh(readers, hp, src_hw, visualize, mesh)

    def _run_group_on_mesh(self, readers, hp, src_hw, visualize, mesh) -> List[Dict]:
        from vehicle_counting_tpu_torch.ops.letterbox import content_rows, content_upload_exact, host_letterbox_yuv420
        from vehicle_counting_tpu_torch.parallel.cameras import camera_params, join_shards, make_multicam_step
        from vehicle_counting_tpu_torch.parallel.cameras import regroup_states
        from vehicle_counting_tpu_torch.pipeline import step as step_mod
        from vehicle_counting_tpu_torch.tracking.deepsort import init_states

        base = self.base
        n_cam, b = len(readers), base.batch_size
        cams = [base.get_cam_name(r.video_path) for r in readers]
        # padded to a multiple of the mesh size: the padded cameras' frames stay invalid
        total = n_cam + (-n_cam) % mesh.size
        n_local = total // mesh.size
        hp_local = camera_params(hp, n_local)
        states = [regroup_states(init_states(hp_local, d), (n_local, hp.num_classes)) for d in mesh.devices]
        states = states[0] if mesh.size == 1 else tuple(states)

        # a camera whose zone file fails still rides through the loop and fails alone at output
        counters, counter_errors = [], []
        for cam in cams:
            try:
                counters.append(VehicleCounter(base.class_names, os.path.join(base.zone_path, cam + ".json")))
                counter_errors.append(None)
            except Exception as e:
                counters.append(None)
                counter_errors.append(e)

        # the serial loop's upload policy: host letterbox + I420 (content
        # rows where that is bit-exact), or the raw frames with thin_upload: false
        thin = base.config.thin_upload
        thin = True if thin is None else bool(thin)
        net_hw = base.net_hw(src_hw)
        content_only = thin and content_upload_exact(src_hw, net_hw)
        if thin:
            rows_up = content_rows(src_hw, net_hw)[1] if content_only else net_hw[0]
            frame_shape = (total, b, rows_up * 3 // 2, net_hw[1])
            frames_format = "letterboxed_yuv420"
        else:
            frame_shape = (total, b) + tuple(src_hw) + (3,)
            frames_format = "raw_rgb"
        step = make_multicam_step(
            mesh, ycfg=base.ycfg, hp=hp, image_size=net_hw, src_hw=src_hw, conf_thres=base.conf_thres,
            iou_thres=base.iou_thres, max_det=base.max_det, dtype=base.dtype, frames_format=frames_format,
        )

        timer = StageTimer()
        iters = [r.batches() for r in readers]
        done = [False] * n_cam
        rows = [{"frames": [], "tracks": [], "labels": [], "boxes": []} for _ in range(n_cam)]
        n_frames = np.zeros(n_cam, np.int64)

        def fetch():
            """Every camera's next batch, letterboxed: (frames, ids, valid)
            with an exhausted camera's frames left invalid; None at the end."""
            frames = np.zeros(frame_shape, np.uint8)
            ids = np.zeros((total, b), np.int64)
            valid = np.zeros((total, b), bool)
            for i, it in enumerate(iters):
                if done[i]:
                    continue
                with timer.stage("decode"):
                    got = next(it, None)
                if got is None:
                    done[i] = True
                    continue
                f, ids[i], valid[i] = got
                if thin:
                    with timer.stage("letterbox"):
                        f = host_letterbox_yuv420(f, net_hw, content_only=content_only)
                frames[i] = f
            return (frames, ids, valid) if valid.any() else None

        def prep(batch):
            frames, ids, valid = batch
            with timer.stage("upload"):
                if mesh.size == 1:
                    return (parallel_device_put(frames, device=mesh.devices[0]),
                            parallel_device_put(valid, device=mesh.devices[0]), ids, valid)
                # each shard's cameras straight to its card
                return upload_shards(frames, mesh), upload_shards(valid, mesh), ids, valid

        def drain(pending):
            touts, ids, valid = pending
            with timer.stage("readback"):
                touts = join_shards(touts, "cpu")
                mask = touts.mask.numpy()  # [N_cam (padded), B, C, K]
                tids = touts.ids.numpy()
                boxes = touts.boxes.numpy()
            n_frames[:] += valid[:n_cam].sum(1)
            for i in range(n_cam):
                bb, c, k = np.nonzero(mask[i])
                if bb.size:
                    rows[i]["frames"].extend(ids[i, bb].tolist())
                    rows[i]["tracks"].extend(tids[i, bb, c, k].tolist())
                    rows[i]["labels"].extend(c.tolist())
                    rows[i]["boxes"].extend(boxes[i, bb, c, k])

        for i, d in enumerate(mesh.devices):
            if step_mod.use_frame_graph(d):
                # capture each shard's frame step (n_local x C classes) before the upload worker starts
                with on_device(d):
                    step_mod.frame_runner(hp_local, src_hw, d, i)
        t_start = time.perf_counter()
        pending = None
        try:
            with torch.no_grad():
                for fdev, vdev, ids, valid in prefetch(fetch, prep):
                    with timer.stage("dispatch"):
                        states, touts = step(base.yolo_params, base.reid_params, base.reid_stats, base.class_lut,
                                             states, fdev, vdev)
                    if pending is not None:
                        drain(pending)
                    pending = (touts, ids, valid)
                if pending is not None:
                    drain(pending)
        finally:
            # this group's captured steps, their static states and pools
            for i, d in enumerate(mesh.devices):
                step_mod.free_frame_runner(hp_local, src_hw, d, i)
        elapsed = time.perf_counter() - t_start
        fps = float(n_frames.sum()) / elapsed if elapsed > 0 else 0.0
        if base.debug:
            print(f"[debug] group {cams} per-stage timing:\n{timer.summary()}")
            print(f"[debug] group {cams} spans (total, mean, count, self):\n{timer.spans()}")

        import pandas as pd

        results = []
        for i, cam in enumerate(cams):
            try:  # per-camera isolation at output, as the serial loop's per video
                if counter_errors[i] is not None:
                    raise counter_errors[i]
                csv_path = os.path.join(base.saved_path, cam + ".csv")
                counters[i].run(rows[i]["frames"], rows[i]["tracks"], rows[i]["labels"],
                                np.asarray(rows[i]["boxes"]) if rows[i]["boxes"] else np.zeros((0, 4)),
                                output_path=csv_path)
                df = pd.read_csv(csv_path)
                counts = ({k: v.tolist() for k, v in count_directions(df, base.num_classes).items()}
                          if len(df) else {})
                if visualize:
                    readers[i].reinitialize_stream()
                    writer = VideoWriter(readers[i].video_info, os.path.join(base.saved_path, cam + ".mp4"))
                    visualize_merged(readers[i], csv_path, counters[i].directions, counters[i].polygons,
                                     base.num_classes, writer)
                    writer.release()
                results.append({"csv": csv_path, "counts": counts, "camera": cam, "video": readers[i].video_path,
                                "error": None, "frames": int(n_frames[i]), "fps": fps})
            except Exception as e:
                print(f"[multicam] ERROR on camera {cam}: {e!r}")
                results.append(_failed(cam, readers[i].video_path, e))
        return results
