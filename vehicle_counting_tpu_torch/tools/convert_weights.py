#!/usr/bin/env python
"""Convert torch checkpoints to torch-free .npz weight files.

    python -m vehicle_counting_tpu_torch.tools.convert_weights \
        --kind yolov5 --input yolov5s.pt --output yolov5s.npz
    python -m vehicle_counting_tpu_torch.tools.convert_weights \
        --kind reid --input ckpt.t7 --output reid.npz

Port of `vehicle_counting_tpu/tools/convert_weights.py`. The output .npz
stores the checkpoint's STATE DICT (torch parameter names, float32) —
exactly what `run --weight yolov5s.npz` / the cam-config `checkpoint:` key
accept: the port's models/convert.py::load_yolov5_weights and
models/reid.py::load_reid_weights read state-dict .npz directly (BN folding
/ name mapping happen at load, same as for a .pt), and so do the JAX
package's loaders. Both loaders run on the dict before it is written.

_flatten_to_npz / load_npz_pytree below are the lower-level tree dump
utilities over dict / list / tuple trees of tensors or arrays (e.g. a
trainer's (params, stats)), keyed as the JAX package keys them: the path
of dict keys and sequence indices joined by "/", dict keys sorted.
"""

from __future__ import annotations

import argparse

import numpy as np


def _paths(tree, prefix=()):
    """(path, leaf) pairs in flatten order: dict keys sorted, depth first."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _numpy(leaf) -> np.ndarray:
    return leaf.detach().cpu().numpy() if hasattr(leaf, "detach") else np.asarray(leaf)


def _flatten_to_npz(tree, output: str) -> int:
    arrays = {key: _numpy(leaf) for key, leaf in _paths(tree)}
    np.savez(output, **arrays)
    return len(arrays)


def load_npz_pytree(path: str, like):
    """Restore an npz produced by _flatten_to_npz into the structure of
    `like`; a leaf comes back as a tensor where `like` holds a tensor (on
    its device), else as an array."""
    data = np.load(path)

    def rebuild(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k], prefix + (str(k),)) for k in tree}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, prefix + (str(i),)) for i, v in enumerate(tree))
        a = data["/".join(prefix)]
        if hasattr(tree, "detach"):
            import torch

            return torch.from_numpy(np.ascontiguousarray(a)).to(tree.device)
        return a

    return rebuild(like)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--kind", choices=["yolov5", "reid"], required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)

    from vehicle_counting_tpu_torch.models.convert import extract_state_dict, load_torch_checkpoint

    sd = extract_state_dict(load_torch_checkpoint(args.input))
    # validate the conversion end-to-end before writing: the same loaders
    # run will use must accept the dict
    if args.kind == "yolov5":
        from vehicle_counting_tpu_torch.models.convert import yolov5_state_dict_to_pytree

        yolov5_state_dict_to_pytree(sd)
    else:
        from vehicle_counting_tpu_torch.models.reid import reid_state_dict_to_pytree

        reid_state_dict_to_pytree(sd)
    np.savez(args.output, **sd)
    print(f"wrote {len(sd)} arrays to {args.output}")


if __name__ == "__main__":
    main()
