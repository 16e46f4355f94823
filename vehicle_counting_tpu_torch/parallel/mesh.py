"""Device meshes, and the camera fleet across processes.

Port of `vehicle_counting_tpu/parallel/mesh.py`. A JAX `Mesh` is an array
of devices with axis names that `shard_map` splits arrays over; PyTorch
has no such object, so a `DeviceMesh` is the ordered list of
`torch.device`s a step places its shards on, with its one axis name. The
frame-parallel step (`parallel/frames.py`) runs shard i on
`mesh.devices[i]`.

Torch has nothing like JAX's virtual CPU devices, so a CPU mesh of n
entries repeats the one CPU device n times (the CPU tests shard over
that), and a mesh may repeat a card (two shards on one card). A mesh
never shrinks to the devices it finds and never falls back to the CPU.

Across processes (`initialize_multihost`): each process drives one
device and its own cameras (`parallel/cameras.py::multicam_batch_step`)
with no collective on the data path, as in the JAX package; the
collectives of `host_local_to_global` serve checks and readback only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class DeviceMesh:
    """An ordered tuple of devices along one named axis. Hashable, so a
    step builder can be memoized on it."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("cam",)

    def __post_init__(self):
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if len(self.axis_names) != 1:
            raise ValueError(f"a mesh has one axis here, got {self.axis_names}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: self.size}


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("cam",),
              device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over the first n cards (default: every visible card), or
    over n entries of the CPU device (default 1). Raises when fewer cards
    are visible than asked for, or none at all."""
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, asked for {n_devices}")
    if device_type == "cuda":
        have = torch.cuda.device_count()
        n = have if n_devices is None else n_devices
        if have < max(n, 1):
            raise ValueError(f"requested {n_devices if n_devices is not None else 'every'} CUDA device(s), have {have}")
        devices = [torch.device("cuda", i) for i in range(n)]
    elif device_type == "cpu":
        devices = [torch.device("cpu")] * (1 if n_devices is None else n_devices)
    else:
        raise ValueError(f"unknown device type {device_type!r}")
    return DeviceMesh(tuple(devices), tuple(axis_names))


def tree_to(tree, device):
    """A dict / list / tuple tree of tensors on `device` (a tensor already
    there is returned as is)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device)


def weight_replicas():
    """`weights_on(device, trees)`: the tuple of weight trees `trees` copied
    to `device`, copied at the first call with these tree objects and
    reused while the caller passes the same objects (a weight changed in
    place is not copied again). One copy per device, however often a mesh
    repeats it. A step that places shards on devices keeps one."""
    replicas = {}  # device -> (the caller's weight trees, their copies on the device)

    def weights_on(device, trees):
        hit = replicas.get(device)
        if hit is None or any(a is not b for a, b in zip(hit[0], trees)):
            hit = replicas[device] = (trees, tuple(tree_to(t, device) for t in trees))
        return hit[1]

    return weights_on


# ---------------------------------------------------------------------------
# multi-host scale-out
# ---------------------------------------------------------------------------

def initialize_multihost(coordinator_address: str, num_processes: int, process_id: int,
                         device="cuda") -> None:
    """Join this process to the process group at `coordinator_address`
    ("host:port") as rank `process_id` of `num_processes`: NCCL when the
    process drives a card (`device`, made current), gloo on the CPU.
    Idempotent per process; joining again with another rank or size
    raises."""
    import torch.distributed as dist

    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes, process_id):
            raise RuntimeError(f"this process is rank {dist.get_rank()} of {dist.get_world_size()} already, "
                               f"not {process_id} of {num_processes}")
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device '{dev}' requested but no CUDA device is available")
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def local_device() -> torch.device:
    """The device this process drives in its process group."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_global_mesh(axis_names: Sequence[str] = ("cam",)) -> DeviceMesh:
    """1-D mesh with one entry per rank, in rank order: the device each
    process drives (a collective: every rank calls it)."""
    import torch.distributed as dist

    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, str(local_device()))
    return DeviceMesh(tuple(torch.device(n) for n in names), tuple(axis_names))


def host_local_to_global(mesh: DeviceMesh, spec, local_array: torch.Tensor) -> torch.Tensor:
    """Every rank's `local_array` joined along the sharded axis (the first entry
    of `spec` that is not None, as in a PartitionSpec), in rank order, on
    this rank's device: an `all_gather`, so every rank calls it with
    equal local shapes."""
    import torch.distributed as dist

    world = dist.get_world_size()
    if mesh.size != world:
        raise ValueError(f"the mesh has {mesh.size} entries, the process group {world} ranks")
    axis = next((i for i, name in enumerate(spec) if name is not None), 0)
    x = local_array.to(local_device()).contiguous()
    wire = x.view(torch.uint8) if x.dtype == torch.bool else x
    parts = [torch.empty_like(wire) for _ in range(world)]
    dist.all_gather(parts, wire)
    out = torch.cat(parts, dim=axis)
    return out.view(torch.bool) if x.dtype == torch.bool else out


def global_to_host_local(global_array: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's rows of a tensor joined by `host_local_to_global`."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    n = global_array.shape[axis] // world
    return global_array.narrow(axis, rank * n, n)
