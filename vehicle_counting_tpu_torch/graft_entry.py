"""Entry points of the port: a one-card detect step, and a dry run over a mesh.

Counterpart of the root `__graft_entry__.py` (which stays the JAX
package's):

  * `entry(device="cuda")` returns (fn, example_args) for the flagship
    step, YOLOv5s detection on 720p frames at AutoShape's 384x640, bf16,
    on the card;
  * `dryrun_multichip(n, device_type="cuda")` runs the root file's three
    multi-device parts over an n-device mesh (`parallel/mesh.py::make_mesh`:
    n cards, or n entries of the CPU device) and holds each against its
    serial counterpart:
      1. the data-parallel ReID `train_step` (batch split by device, the
         whole batch's BN statistics and loss) against the one-device step;
      2. the camera-sharded detect+track step (`parallel/cameras.py`) at
         the production `TrackerParams` (capacity 64, budget 60, max_age
         30, 4 classes), n cameras sharded over the n devices, against each
         camera's serial `pipeline_batch_step` on its own device of the
         mesh;
      3. the YOLOv5s detect step on 720p frames split by frame, one frame
         per device, against the serial step on the first device.
Torch has no virtual devices: the CPU mesh repeats the CPU device, so
`dryrun_multichip(n, "cpu")` checks the code paths and a card machine the
devices.
"""

from __future__ import annotations

import numpy as np
import torch

from vehicle_counting_tpu_torch.utils.device import on_device, require_device

SRC_HW, NET_HW = (720, 1280), (384, 640)  # AutoShape's stride-aligned minimal pad for 720p at 640


def _detect_kw(cfg):
    return dict(cfg=cfg, image_size=NET_HW, src_hw=SRC_HW, conf_thres=0.25, iou_thres=0.45, max_det=300,
                dtype=torch.bfloat16)


def entry(device="cuda"):
    """(fn, example_args): the YOLOv5s-640 detection step (letterbox ->
    CSPDarknet/SPPF/PANet -> anchor decode -> class-aware NMS -> coordinate
    restore), bf16 compute, random init from seed 0, on `device`."""
    from vehicle_counting_tpu_torch.models.detector import detect_step
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, cast_params, init_yolov5

    dev = require_device(device)
    cfg = YoloConfig(variant="yolov5s", num_classes=80)
    params = cast_params(init_yolov5(torch.Generator().manual_seed(0), cfg, dev), torch.bfloat16)
    frames = torch.zeros((1,) + SRC_HW + (3,), dtype=torch.uint8, device=dev)

    def fn(params, frames):
        with on_device(frames.device), torch.no_grad():
            return detect_step(params, frames, **_detect_kw(cfg))

    return fn, (params, frames)


def _close(name, got, want, rtol, atol):
    if not torch.allclose(got.cpu(), want.cpu(), rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: max |diff| {float((got.cpu() - want.cpu()).abs().max())} past rtol {rtol} / "
                             f"atol {atol}")


def dp_train_check(mesh, dtype=torch.float32):
    """One ReID `train_step` with the batch split over `mesh` against the
    same step on the mesh's first device alone, from the same init, data
    and dropout draws. In f64 every leaf must agree to 1e-9 of the
    gradient's size; in f32 the loss to rel 1e-4 and the first param leaf
    to rtol 1e-4 / atol 1e-5 (the JAX DP test's checks: f32 summation order
    moves the gradients themselves by up to ~3 % of their size). Returns
    the losses and the worst param difference."""
    from vehicle_counting_tpu_torch.train import reid_train as rt

    d0, seed = mesh.devices[0], 0
    cfg = rt.ReidTrainConfig(num_classes=16, batch_size=2 * mesh.size, lr=0.05)  # 2 crops per device
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(cfg.batch_size, 50, 50, 3)).astype(np.float32)
    labels = rng.integers(0, cfg.num_classes, cfg.batch_size).astype(np.int32)

    def step(m):
        params, stats, opt, ost = rt.create_train_state(torch.Generator().manual_seed(seed), cfg, 10, d0)
        if dtype != torch.float32:
            params, stats, ost = rt.cast_train_state(params, stats, opt, dtype)
        params, stats, ost, metrics = rt.train_step(params, stats, ost, images, labels,
                                                    torch.Generator(device=d0).manual_seed(seed + 1), opt=opt, mesh=m)
        return float(metrics["loss"]), [t.detach() for t in rt._flatten(params)], [t.detach() for t in ost.trace()]

    (l1, p1, t1), (ln, pn, tn) = step(None), step(mesh)
    worst = max(float((a - b).detach().abs().max()) for a, b in zip(pn, p1))
    if dtype == torch.float64:
        for i, (a, b, t) in enumerate(zip(pn + tn, p1 + t1, t1 + t1)):
            _close(f"f64 leaf {i}", a, b, 0.0, 1e-9 * max(float(t.abs().max()), 1e-3))
    else:
        if abs(ln - l1) > 1e-4 * abs(l1):
            raise AssertionError(f"data-parallel loss {ln} != one device's {l1}")
        _close("the first param leaf", pn[0], p1[0], 1e-4, 1e-5)
    return {"devices": [str(d) for d in mesh.devices], "dtype": str(dtype), "loss_one_device": l1,
            "loss_data_parallel": ln, "worst_param_diff": worst}


def multicam_check(mesh):
    """The camera-sharded detect+track step for mesh.size cameras sharded
    over the mesh (camera i on device i) at the production tracker shapes,
    against each camera's serial step on its own device of the mesh (f32,
    TF32 off): track ids, mask and boxes equal. Each camera shows one
    random image b times and every detection passes the thresholds, so
    tracks confirm."""
    from vehicle_counting_tpu_torch.models.reid import init_reid
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, init_yolov5
    from vehicle_counting_tpu_torch.parallel.cameras import camera_params, join_shards, multicam_batch_step
    from vehicle_counting_tpu_torch.parallel.cameras import regroup_states
    from vehicle_counting_tpu_torch.parallel.mesh import tree_to
    from vehicle_counting_tpu_torch.pipeline.step import pipeline_batch_step
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, init_states
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams

    d0, n_cam, b, hw = mesh.devices[0], mesh.size, 4, (96, 96)
    if d0.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    ycfg = YoloConfig(variant="yolov5n", num_classes=80)
    yp = init_yolov5(torch.Generator().manual_seed(2), ycfg)
    rp, rs = init_reid(torch.Generator().manual_seed(3))
    hp = DeepSortParams(tracker=TrackerParams(), num_classes=4, min_confidence=0.0)  # capacity 64, budget 60, max_age 30
    lut = torch.arange(80, dtype=torch.int32) % 4  # every detector class onto the 4 tracked ones: tracks to hold
    kw = dict(ycfg=ycfg, hp=hp, image_size=hw, src_hw=hw, conf_thres=0.0, max_det=16, dtype=torch.float32,
              frames_format="raw_rgb")
    still = np.random.default_rng(2).integers(0, 255, (n_cam, 1) + hw + (3,), np.uint8)
    frames = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(still, (n_cam, b) + hw + (3,))))
    valid = torch.ones((n_cam, b), dtype=torch.bool)
    with on_device(d0), torch.no_grad():
        states = regroup_states(init_states(camera_params(hp, n_cam), d0), (n_cam, hp.num_classes))
        w0 = tree_to((yp, rp, rs, lut), d0)
        # the initial state and the frames split over the mesh, camera i to device i
        _, touts = multicam_batch_step(mesh, *w0[:3], states, frames, valid, w0[3], **kw)
        touts = join_shards(touts, "cpu")
    detections = 0
    for c, dev in enumerate(mesh.devices):
        with on_device(dev), torch.no_grad():
            w = tree_to((yp, rp, rs, lut), dev)
            _, det, want = pipeline_batch_step(w[0], w[1], w[2], init_states(hp, dev), frames[c].to(dev),
                                               valid[c].to(dev), w[3], **kw)
        detections += int(det["valid"].sum())
        for name in ("ids", "mask", "boxes"):
            if not torch.equal(getattr(touts, name)[c].cpu(), getattr(want, name).cpu()):
                raise AssertionError(f"camera {c}: the multi-camera step's track {name} differ from its serial step "
                                     f"on {dev}")
    return {"cameras": n_cam, "devices": [str(d) for d in mesh.devices], "detections": detections,
            "tracks": int(touts.mask.sum()), "capacity": hp.tracker.capacity, "budget": hp.tracker.budget,
            "max_age": hp.tracker.max_age}


def framedp_detect_check(mesh):
    """The YOLOv5s-640 detect step on mesh.size 720p frames split by frame
    (frame i on device i, its own copy of the weights) against the serial
    step on the first device, frame by frame (the same batch extent, so
    bitwise at bf16 on cards of one model) and on the whole batch (the
    discrete outputs, reported)."""
    from vehicle_counting_tpu_torch.models.detector import detect_step
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, cast_params, init_yolov5
    from vehicle_counting_tpu_torch.parallel.mesh import tree_to

    cfg = YoloConfig(variant="yolov5s", num_classes=80)
    params = cast_params(init_yolov5(torch.Generator().manual_seed(4), cfg), torch.bfloat16)
    frames = torch.from_numpy(np.random.default_rng(4).integers(0, 255, (mesh.size,) + SRC_HW + (3,), np.uint8))
    d0 = mesh.devices[0]
    shards = []
    for i, dev in enumerate(mesh.devices):
        with on_device(dev), torch.no_grad():
            shards.append(detect_step(tree_to(params, dev), frames[i:i + 1].to(dev), **_detect_kw(cfg)))
    with on_device(d0), torch.no_grad():
        p0 = tree_to(params, d0)
        serial = [detect_step(p0, frames[i:i + 1].to(d0), **_detect_kw(cfg)) for i in range(mesh.size)]
        whole = detect_step(p0, frames.to(d0), **_detect_kw(cfg))
    for i, (got, want) in enumerate(zip(shards, serial)):
        for k in want:
            if not torch.equal(got[k].cpu(), want[k].cpu()):
                raise AssertionError(f"frame {i}: the detect step's {k} on {mesh.devices[i]} differs from {d0}")
    joined = {k: torch.cat([s[k].cpu() for s in shards]) for k in whole}
    if joined["boxes"].shape != (mesh.size, 300, 4):
        raise AssertionError(f"joined boxes {tuple(joined['boxes'].shape)}")
    return {"frames": mesh.size, "detections": int(joined["valid"].sum()),
            "valid_equal_to_whole_batch": bool(torch.equal(joined["valid"], whole["valid"].cpu()))}


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> dict:
    """The three multi-device paths over an n-device mesh, each held
    against its serial counterpart; prints one line per part and returns
    their results."""
    from vehicle_counting_tpu_torch.parallel.mesh import make_mesh

    if device_type == "cuda":
        require_device("cuda")
    out = {}
    mesh = make_mesh(n_devices, ("data",), device_type)
    out["dp_train"] = dp_train_check(mesh)
    out["dp_train_f64"] = dp_train_check(mesh, dtype=torch.float64)
    print(f"[dryrun] dp train step ok on {n_devices} devices: loss={out['dp_train']['loss_data_parallel']:.3f} "
          f"(one device {out['dp_train']['loss_one_device']:.3f})")
    out["multicam"] = multicam_check(make_mesh(n_devices, ("cam",), device_type))
    print(f"[dryrun] camera-parallel step ok: {n_devices} cameras against their serial steps on {n_devices} devices "
          f"(capacity={out['multicam']['capacity']}, budget={out['multicam']['budget']}, "
          f"max_age={out['multicam']['max_age']})")
    out["detect"] = framedp_detect_check(make_mesh(n_devices, ("frame",), device_type))
    print(f"[dryrun] flagship yolov5s-640 detect step ok: {n_devices} frames data-parallel over {n_devices} devices")
    return out


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8, sys.argv[2] if len(sys.argv) > 2 else "cuda")
