"""PyTorch port, `parallel/mesh.py`: meshes, and the camera fleet across
processes (the JAX package's tests/test_multihost.py).

Two real processes join one gloo process group through
`initialize_multihost`; each runs its own cameras through the port's
`multicam_batch_step` on the CPU, with no collective on the data path,
checks them against the single-process oracle (the serial
`pipeline_batch_step` camera by camera), then gathers every rank's outputs
(`host_local_to_global`), checks the other rank's cameras against the
oracle too, and `global_to_host_local` of the gathered outputs against its
own. The worker is this file, run as a script.
"""

import os
import sys

import pytest
import torch

from vehicle_counting_tpu_torch.parallel.mesh import DeviceMesh, make_mesh

N_LOCAL = 2  # cameras per process


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_camera_fleet():
    import subprocess

    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), f"localhost:{port}", "2", str(pid)],
                              cwd=repo, env=env, text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"MULTIHOST OK pid={pid} local_cams={N_LOCAL} global_cams={2 * N_LOCAL} ranks=2" in out


def test_make_mesh_on_the_cpu_repeats_the_device():
    mesh = make_mesh(4, ("frame",), "cpu")
    assert mesh.devices == (torch.device("cpu"),) * 4 and mesh.shape == {"frame": 4} and mesh.size == 4
    assert make_mesh(None, ("frame",), "cpu").size == 1
    assert hash(mesh) == hash(make_mesh(4, ("frame",), "cpu"))
    assert DeviceMesh(["cuda:0", "cuda:0"], ("frame",)).devices == (torch.device("cuda", 0),) * 2


@pytest.mark.parametrize("n", [None, 1, 3])
def test_make_mesh_never_shrinks_or_falls_back(n, monkeypatch):
    """Fewer cards than asked for (here none at all) raises: no smaller
    mesh, no CPU mesh in its place."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0 if n is None else n - 1)
    with pytest.raises(ValueError, match="CUDA device"):
        make_mesh(n, ("frame",))
    with pytest.raises(ValueError, match="at least one device"):
        make_mesh(0, ("frame",), "cpu")


def _worker(coordinator: str, num_processes: int, pid: int) -> None:
    import numpy as np

    from vehicle_counting_tpu_torch.models.reid import init_reid
    from vehicle_counting_tpu_torch.models.yolo import YoloConfig, init_yolov5
    from vehicle_counting_tpu_torch.ops.letterbox import host_letterbox_yuv420
    from vehicle_counting_tpu_torch.parallel.cameras import camera_params, multicam_batch_step, regroup_states
    from vehicle_counting_tpu_torch.parallel.mesh import (
        global_to_host_local,
        host_local_to_global,
        initialize_multihost,
        make_global_mesh,
    )
    from vehicle_counting_tpu_torch.pipeline.step import pipeline_batch_step
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, init_states
    from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams

    import torch.distributed as dist

    torch.set_num_threads(1)
    initialize_multihost(coordinator, num_processes, pid, device="cpu")
    initialize_multihost(coordinator, num_processes, pid, device="cpu")  # idempotent
    try:
        initialize_multihost(coordinator, num_processes, 1 - pid, device="cpu")
        raise AssertionError("joining again as another rank did not raise")
    except RuntimeError:
        pass
    mesh = make_global_mesh(("cam",))
    assert mesh.devices == (torch.device("cpu"),) * num_processes

    # the same seeded weights in every process; the tiny detector admits
    # everything above a near-zero threshold, 2 tracked classes
    ycfg = YoloConfig("yolov5n", 80)
    yp = init_yolov5(torch.Generator().manual_seed(2), ycfg)
    rp, rs = init_reid(torch.Generator().manual_seed(3))
    hp = DeepSortParams(tracker=TrackerParams(capacity=8, budget=4, max_age=4, n_init=2), num_classes=2,
                        min_confidence=0.0, max_embed=16)
    b, src, net = 2, (72, 128), (96, 128)
    kw = dict(ycfg=ycfg, hp=hp, image_size=net, src_hw=src, conf_thres=0.02, iou_thres=0.45, max_det=8,
              dtype=torch.float32, frames_format="letterboxed_yuv420")
    lut = torch.arange(80, dtype=torch.int32) % 2

    def cam_frames(g):  # camera g's frames, seeded by its GLOBAL id
        rgb = np.random.default_rng(100 + g).integers(0, 255, (b,) + src + (3,), np.uint8)
        return torch.from_numpy(host_letterbox_yuv420(rgb, net, content_only=True))

    def oracle(g):
        with torch.no_grad():
            _, _, out = pipeline_batch_step(yp, rp, rs, init_states(hp), cam_frames(g), torch.ones(b, dtype=torch.bool),
                                            lut, **kw)
        return out

    # this process's cameras, no collective on the data path
    mine = [pid * N_LOCAL + c for c in range(N_LOCAL)]
    states = regroup_states(init_states(camera_params(hp, N_LOCAL)), (N_LOCAL, hp.num_classes))
    with torch.no_grad():
        _, touts = multicam_batch_step(None, yp, rp, rs, states, torch.stack([cam_frames(g) for g in mine]),
                                       torch.ones((N_LOCAL, b), dtype=torch.bool), lut, **kw)
    for c, g in enumerate(mine):
        want = oracle(g)
        for name in ("mask", "ids", "boxes"):
            assert torch.equal(getattr(touts, name)[c], getattr(want, name)), (g, name)

    # readback: every rank's cameras, in rank order; and back again
    total = 0
    for name in ("mask", "ids", "boxes"):
        local = getattr(touts, name)
        full = host_local_to_global(mesh, ("cam",), local)
        assert full.shape[0] == N_LOCAL * num_processes and full.dtype == local.dtype
        assert torch.equal(global_to_host_local(full), local), name
        for g in range(full.shape[0]):
            assert torch.equal(full[g], getattr(oracle(g), name)), (g, name)
        if name == "mask":
            total = int(full.sum())
    assert total > 0  # tracked detections, not an all-empty comparison
    dist.barrier()
    dist.destroy_process_group()
    print(f"MULTIHOST OK pid={pid} local_cams={N_LOCAL} global_cams={N_LOCAL * num_processes} "
          f"ranks={num_processes}", flush=True)


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
