"""ReID appearance CNN (DeepSORT's model), inference in PyTorch.

Port of `vehicle_counting_tpu/models/reid.py` (inference path of
`reid_forward`, reid=True): conv3x3(+bias)+BN+ReLU+maxpool(3,2,1) stem,
4 stages of 2 residual BasicBlocks (64->64, 64->128/s2, 128->256/s2,
256->512/s2), 4x4 average pool and an L2-normalised 512-d embedding.
BatchNorm stays explicit (running stats, f32), as in the reference. The
TPU-only odd->even spatial pad (`_conv3_even`) is not carried over: it was
a bitwise-neutral layout trick for the TPU.

Params and stats are plain dicts (OIHW conv weights), carried across from
the JAX pytrees by `models/convert.py::reid_params_from_jax` or loaded
from the reference's `ckpt.t7` by `load_reid_weights`.

The two stage-1 blocks (64 channels at 25x25) can run as one fused kernel
each (K5, `ops/reid_block.py`), off by default as in the JAX package and
switched by `FORCE_REID_BLOCK_KERNEL` or the environment variable
`FORCE_PALLAS_REID_BLOCK` (`_reid_block_on`).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from vehicle_counting_tpu_torch.ops.reid_block import fold_bn, hwio, reid_block64

EMBED_DIM = 512
BN_EPS = 1e-5
STAGES = ((64, 64, False), (64, 128, True), (128, 256, True), (256, 512, True))


def _he(gen, k, cin, cout, device):
    w = torch.randn((cout, cin, k, k), generator=gen, dtype=torch.float32)
    return (w * math.sqrt(2.0 / (k * k * cin))).to(device)


def _bn_init(c, device):
    return ({"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)},
            {"mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)})


def init_reid(gen: torch.Generator, device=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Random-init (params, batch_stats) of the embedding network (the
    reference's classifier head serves training only, which is not ported)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    bn_p, bn_s = _bn_init(64, device)
    params["stem"] = {"w": _he(gen, 3, 3, 64, device), "b": torch.zeros(64, device=device), "bn": bn_p}
    stats["stem"] = bn_s
    for si, (cin, cout, ds) in enumerate(STAGES):
        for bi in range(2):
            name = f"layer{si + 1}_{bi}"
            b_cin = cin if bi == 0 else cout
            bn1_p, bn1_s = _bn_init(cout, device)
            bn2_p, bn2_s = _bn_init(cout, device)
            p = {"conv1": {"w": _he(gen, 3, b_cin, cout, device)}, "bn1": bn1_p,
                 "conv2": {"w": _he(gen, 3, cout, cout, device)}, "bn2": bn2_p}
            s = {"bn1": bn1_s, "bn2": bn2_s}
            if (ds and bi == 0) or b_cin != cout:
                dbn_p, dbn_s = _bn_init(cout, device)
                p["down"] = {"w": _he(gen, 1, b_cin, cout, device), "bn": dbn_p}
                s["down"] = dbn_s
            params[name] = p
            stats[name] = s
    return params, stats


def _bn(x, p, s):
    """Inference BatchNorm on NCHW f32: (x - mean) * rsqrt(var + eps) * scale + bias."""
    inv = torch.rsqrt(s["var"] + BN_EPS)
    shape = (1, -1, 1, 1)
    return (x - s["mean"].view(shape)) * inv.view(shape) * p["scale"].view(shape) + p["bias"].view(shape)


def _conv(x, w, stride, padding, dtype):
    """Conv in the compute dtype (f32 accumulation inside cuDNN); f32 out."""
    return F.conv2d(x.to(dtype), w.to(dtype), stride=stride, padding=padding).float()


def _basic_block(p, s, x, stride: int, dtype):
    y = torch.relu(_bn(_conv(x, p["conv1"]["w"], stride, 1, dtype), p["bn1"], s["bn1"]))
    y = _bn(_conv(y, p["conv2"]["w"], 1, 1, dtype), p["bn2"], s["bn2"])
    if "down" in p:
        x = _bn(_conv(x, p["down"]["w"], stride, 0, dtype), p["down"]["bn"], s["down"])
    return torch.relu(x + y)


# Counterpart of the JAX `models/reid.py::FORCE_PALLAS_REID_BLOCK`. None:
# auto = OFF, as in the JAX package; True: run the fused stage-1 block
# (K5); False: never. The environment variable FORCE_PALLAS_REID_BLOCK
# (=1 on, =0 off) drives both packages.
FORCE_REID_BLOCK_KERNEL = None


def _reid_block_on() -> bool:
    """The JAX `_reid_block_mode` decision: fused stage-1 block or not."""
    env = os.environ.get("FORCE_PALLAS_REID_BLOCK")
    if FORCE_REID_BLOCK_KERNEL is False or env == "0":
        return False
    return FORCE_REID_BLOCK_KERNEL is True or env == "1"


def _block_fused(p, s, x, dtype):
    """Stage-1 block through K5 (BN folded), f32 out like `_basic_block`."""
    a1, b1 = fold_bn(p["bn1"]["scale"], p["bn1"]["bias"], s["bn1"]["mean"], s["bn1"]["var"], BN_EPS)
    a2, b2 = fold_bn(p["bn2"]["scale"], p["bn2"]["bias"], s["bn2"]["mean"], s["bn2"]["var"], BN_EPS)
    return reid_block64(x.to(dtype), hwio(p["conv1"]["w"]), hwio(p["conv2"]["w"]), a1, b1, a2, b2).float()


def reid_forward_nchw(params, stats, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """x [N, 3, 50, 50] normalised crops -> L2-normalised [N, 512] f32."""
    y = _conv(x, params["stem"]["w"], 1, 1, dtype) + params["stem"]["b"].view(1, -1, 1, 1)
    y = F.max_pool2d(torch.relu(_bn(y, params["stem"]["bn"], stats["stem"])), 3, 2, 1)
    fused = _reid_block_on()
    for si, (_, _, ds) in enumerate(STAGES):
        for bi in range(2):
            name = f"layer{si + 1}_{bi}"
            stride = 2 if (ds and bi == 0) else 1
            # the JAX conditions: stride 1, no downsample, 64 x 25 x 25, and
            # bf16 on the card (the CPU runs the plain version at any dtype)
            if (fused and stride == 1 and "down" not in params[name]
                    and tuple(y.shape[1:]) == (64, 25, 25)
                    and (dtype == torch.bfloat16 or y.device.type == "cpu")):
                y = _block_fused(params[name], stats[name], y, dtype)
                continue
            y = _basic_block(params[name], stats[name], y, stride, dtype)
    emb = F.avg_pool2d(y, 4, 1).flatten(1)  # 50x50 input -> 4x4 -> 1x1
    return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True), min=1e-12)


def reid_forward(params, stats, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """JAX layout: x [N, 50, 50, 3] normalised crops -> [N, 512] embeddings."""
    return reid_forward_nchw(params, stats, x.permute(0, 3, 1, 2), dtype)


# ---------------------------------------------------------------------------
# torch .t7 conversion (name-mapped, BN kept explicit)
# ---------------------------------------------------------------------------

def reid_state_dict_to_params(sd, device=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Map the reference's `net_dict` names onto (params, batch_stats).

    Torch layout: conv.0/conv.1 stem; layer{1..4}.{0,1}.conv1/bn1/conv2/bn2
    (+ .downsample.0/.1); classifier.0 (linear), .1 (bn1d), .4 (linear).
    Conv weights stay OIHW; dense weights are stored [in, out] as in the
    JAX package (the classifier serves training only and is carried for
    completeness).
    """
    import numpy as np

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(device)

    def bn(prefix):
        return (
            {"scale": t(sd[f"{prefix}.weight"]), "bias": t(sd[f"{prefix}.bias"])},
            {"mean": t(sd[f"{prefix}.running_mean"]), "var": t(sd[f"{prefix}.running_var"])},
        )

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    bn_p, bn_s = bn("conv.1")
    params["stem"] = {"w": t(sd["conv.0.weight"]), "b": t(sd["conv.0.bias"]), "bn": bn_p}
    stats["stem"] = bn_s

    for si in range(4):
        for bi in range(2):
            name = f"layer{si + 1}_{bi}"
            tbase = f"layer{si + 1}.{bi}"
            bn1_p, bn1_s = bn(f"{tbase}.bn1")
            bn2_p, bn2_s = bn(f"{tbase}.bn2")
            p = {
                "conv1": {"w": t(sd[f"{tbase}.conv1.weight"])},
                "bn1": bn1_p,
                "conv2": {"w": t(sd[f"{tbase}.conv2.weight"])},
                "bn2": bn2_p,
            }
            s = {"bn1": bn1_s, "bn2": bn2_s}
            if f"{tbase}.downsample.0.weight" in sd:
                dbn_p, dbn_s = bn(f"{tbase}.downsample.1")
                p["down"] = {"w": t(sd[f"{tbase}.downsample.0.weight"]), "bn": dbn_p}
                s["down"] = dbn_s
            params[name] = p
            stats[name] = s

    if "classifier.0.weight" in sd:
        cbn_p, cbn_s = bn("classifier.1")
        params["fc1"] = {
            "w": t(np.transpose(sd["classifier.0.weight"])),
            "b": t(sd["classifier.0.bias"]),
            "bn": cbn_p,
        }
        stats["fc1"] = cbn_s
        params["fc2"] = {
            "w": t(np.transpose(sd["classifier.4.weight"])),
            "b": t(sd["classifier.4.bias"]),
        }
    return params, stats


def load_reid_weights(path: str, device=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load the reference `ckpt.t7` (or an .npz) into (params, stats)."""
    if path.endswith(".npz"):
        import numpy as np

        data = np.load(path)
        sd = {k: data[k] for k in data.files}
    else:
        from vehicle_counting_tpu_torch.models.convert import (
            extract_state_dict,
            load_torch_checkpoint,
        )

        sd = extract_state_dict(load_torch_checkpoint(path))
    return reid_state_dict_to_params(sd, device)


def cast_conv_weights(params, dtype: torch.dtype):
    """Conv weights (4-D "w" leaves) in the compute dtype, once; BN vectors,
    biases and dense weights stay f32."""
    if isinstance(params, dict):
        return {k: (v.to(dtype) if k == "w" and torch.is_tensor(v) and v.dim() == 4
                    else cast_conv_weights(v, dtype)) for k, v in params.items()}
    return params
