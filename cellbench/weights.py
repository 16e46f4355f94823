"""Seeded weights and frames, made on the device in a few large draws.

The detector's and the ReID network's conv weights are He-normal with zero
biases and BatchNorm at identity (folded, for the detector), drawn from one
`torch.Generator` on the run's device: one normal draw for every weight,
then the frame pool (`frame_pool`). The same tensors go to the
reference and, cast to the compute dtype, to the program.
"""

from __future__ import annotations

import math

import torch

from cellbench.reference import reid as reid_ref
from cellbench.reference import yolo as yolo_ref


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _reid_shapes(rcfg):
    c0 = rcfg["stem_channels"]
    tree = {"stem": (c0, 3, 3)}
    for name, cin, cout, _, down in reid_ref.block_names(rcfg):
        tree[name] = {"conv1": (cout, cin, 3), "conv2": (cout, cout, 3)}
        if down:
            tree[name]["down"] = (cout, cin, 1)
    return tree


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def draw(cfg, g: torch.Generator, device):
    """(yolo weights, reid params, reid stats), all f32 on `device`."""
    tree = {"yolo": yolo_ref.conv_shapes(cfg), "reid": _reid_shapes(cfg["reid"])}
    leaves = list(_leaves(tree))
    sizes = [co * ci * k * k for _, (co, ci, k) in leaves]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    zeros = lambda n: torch.zeros(n, device=device)  # noqa: E731
    ones = lambda n: torch.ones(n, device=device)  # noqa: E731
    for (path, (co, ci, k)), part in zip(leaves, torch.split(flat, sizes)):
        w = (part * math.sqrt(2.0 / (ci * k * k))).reshape(co, ci, k, k)
        _put(tree, path, {"w": w, "b": zeros(co)})
    yolo = tree["yolo"]
    params, stats = {}, {}
    for name, leaf in tree["reid"].items():
        if name == "stem":
            c = leaf["w"].shape[0]
            params[name] = {"w": leaf["w"], "b": leaf["b"], "bn": {"scale": ones(c), "bias": zeros(c)}}
            stats[name] = {"mean": zeros(c), "var": ones(c)}
            continue
        c = leaf["conv1"]["w"].shape[0]
        bn = lambda: {"scale": ones(c), "bias": zeros(c)}  # noqa: E731
        st = lambda: {"mean": zeros(c), "var": ones(c)}  # noqa: E731
        params[name] = {"conv1": {"w": leaf["conv1"]["w"]}, "bn1": bn(), "conv2": {"w": leaf["conv2"]["w"]},
                        "bn2": bn()}
        stats[name] = {"bn1": st(), "bn2": st()}
        if "down" in leaf:
            params[name]["down"] = {"w": leaf["down"]["w"], "bn": bn()}
            stats[name]["down"] = st()
    return yolo, params, stats


def frame_pool(cfg, traffic, g: torch.Generator, device) -> torch.Tensor:
    """[P, H, W, 3] uint8 frames in host memory, drawn on the device as the
    mix's `frames` says: "still_scene" (the one kind), one uniform random scene with every
    pixel of every frame moved by a uniform integer in [-jitter, jitter] (a
    fixed camera on a scene that holds still, so detections persist from
    frame to frame)."""
    h, w = cfg["source_hw"]
    n = cfg["frame_pool"]
    j = traffic["frames"]["jitter"]
    base = torch.randint(0, 256, (1, h, w, 3), dtype=torch.int16, generator=g, device=device)
    frames = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for i in range(0, n, 32):
        m = min(32, n - i)
        jit = torch.randint(-j, j + 1, (m, h, w, 3), dtype=torch.int16, generator=g, device=device)
        frames[i:i + m] = (base + jit).clamp(0, 255).to(torch.uint8)
    return frames.cpu()
