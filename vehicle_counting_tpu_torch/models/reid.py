"""ReID appearance CNN (DeepSORT's model) in PyTorch, inference and training.

Port of `vehicle_counting_tpu/models/reid.py`: conv3x3(+bias)+BN+ReLU+
maxpool(3,2,1) stem, 4 stages of 2 residual BasicBlocks (64->64,
64->128/s2, 128->256/s2, 256->512/s2), 4x4 average pool, then either an
L2-normalised 512-d embedding (`reid_embed`, the tracker's inference
path) or the 512->256->num_classes classifier head with BN1d and dropout
that training uses (`reid_forward`, JAX's call, over `reid_apply`, which
also takes a data-parallel batch's shards).
BatchNorm stays explicit (running stats, f32), as in the reference: at
inference each convolution's BN, shortcut and ReLU run as one epilogue
(K8, `ops/reid_epilogue.py`; the eager op chain on the CPU); in
training it normalises with the batch statistics, over every shard of a
data-parallel batch (`reid_apply` on a list of shards). The TPU-only
odd->even spatial pad (`_conv3_even`) is not carried over: it was a
bitwise-neutral layout trick for the TPU.

Params and stats are plain dicts (OIHW conv weights), carried across from
the JAX pytrees by `models/convert.py::reid_params_from_jax` or loaded
from the reference's `ckpt.t7` by `load_reid_weights`.

The two stage-1 blocks (64 channels at 25x25) can run as one fused kernel
each (K5, `ops/reid_block.py`), off by default as in the JAX package and
switched by the module's `FORCE_PALLAS_REID_BLOCK` or the environment
variable of the same name (`_reid_block_on`).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from vehicle_counting_tpu_torch.ops.reid_block import fold_bn, hwio, reid_block64
from vehicle_counting_tpu_torch.ops.reid_epilogue import bn_inv, reid_epilogue
from vehicle_counting_tpu_torch.ops.weight_cache import cached
from vehicle_counting_tpu_torch.utils.device import on_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
EMBED_DIM = 512
BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention: new = (1 - m) * old + m * batch
STAGES = ((64, 64, False), (64, 128, True), (128, 256, True), (256, 512, True))


def _he(gen, k, cin, cout, device):
    w = torch.randn((cout, cin, k, k), generator=gen, dtype=torch.float32)
    return (w * math.sqrt(2.0 / (k * k * cin))).to(device)


def _bn_init(c, device):
    return ({"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)},
            {"mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)})


def init_reid(gen: torch.Generator, num_classes: int = 751, device=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Random-init (params, batch_stats), as the JAX `init_reid`: He-normal
    convs, BN at identity, and the classifier head (fc1 512->256 + BN1d,
    fc2 256->num_classes, normal / sqrt(fan_in)) drawn after the trunk, so
    the embedding's weights do not depend on num_classes."""
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
    fc1_w = torch.randn((EMBED_DIM, 256), generator=gen, dtype=torch.float32) / math.sqrt(EMBED_DIM)
    fc2_w = torch.randn((256, num_classes), generator=gen, dtype=torch.float32) / math.sqrt(256.0)
    bn_p, stats["fc1"] = _bn_init(256, device)
    params["fc1"] = {"w": fc1_w.to(device), "b": torch.zeros(256, device=device), "bn": bn_p}
    params["fc2"] = {"w": fc2_w.to(device), "b": torch.zeros(num_classes, device=device)}
    return params, stats


def _conv(x, w, stride, padding, dtype):
    """Conv in the compute dtype (f32 accumulation inside cuDNN), output in
    it: the BN epilogue reads it as it comes. On the card, a channels-last
    input (the embed's crops, and every activation after them) takes its
    weight channels-last from `_conv_weight`: cuDNN runs both in that
    layout, and `F.conv2d` would otherwise copy an OIHW weight into it on
    every call."""
    if x.dtype != dtype:
        x = x.to(dtype)
    if x.is_cuda and not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last):
        return F.conv2d(x, _conv_weight(w, dtype), stride=stride, padding=padding)
    return F.conv2d(x, w.to(dtype), stride=stride, padding=padding)


def _conv_weight(w: torch.Tensor, dtype) -> torch.Tensor:
    """The OIHW weight `w` in `dtype` and channels-last memory order, the
    same values, kept per weight tensor (and its in-place version)."""
    return cached(("conv_nhwc", dtype), (w,), lambda: w.to(dtype).contiguous(memory_format=torch.channels_last))


def _bn_epilogue(raw, p, s, dtype, *, f32, feeds_conv, pre_bias=None, residual=None, relu=False):
    """Inference BN (running stats, f32) on a convolution's output `raw`,
    then the optional shortcut and ReLU, in one K8 epilogue
    (`ops/reid_epilogue.py`; the eager chain on CPU tensors). Returns (the
    f32 result or None unless `f32`, the next convolution's input in
    `dtype` or None unless `feeds_conv`); in f32 one result serves both."""
    args = (raw, s["mean"], bn_inv(s["var"], BN_EPS), p["scale"], p["bias"], pre_bias, residual, relu)
    if dtype == torch.float32:
        y, _ = reid_epilogue(*args)
        return y, y
    return reid_epilogue(*args, f32=f32, lo=dtype if feeds_conv else None)


def _block(p, s, x, x_in, stride: int, dtype, *, f32=True, feeds_conv=True):
    """One BasicBlock, relu(bn2(conv2(relu(bn1(conv1(x))))) + shortcut(x)):
    x the f32 input (what the identity shortcut reads; None where the block
    has a downsample), x_in the same in `dtype` (what the convolutions
    read). Returns what `_bn_epilogue` returns for the block's output."""
    _, h = _bn_epilogue(_conv(x_in, p["conv1"]["w"], stride, 1, dtype), p["bn1"], s["bn1"], dtype,
                        f32=False, feeds_conv=True, relu=True)
    if "down" in p:
        x, _ = _bn_epilogue(_conv(x_in, p["down"]["w"], stride, 0, dtype), p["down"]["bn"], s["down"], dtype,
                            f32=True, feeds_conv=False)
    return _bn_epilogue(_conv(h, p["conv2"]["w"], 1, 1, dtype), p["bn2"], s["bn2"], dtype,
                        f32=f32, feeds_conv=feeds_conv, residual=x, relu=True)


# The JAX package's switch under its own name, so that a line written for
# `vehicle_counting_tpu.models.reid` works here unchanged. None: auto = OFF,
# as in the JAX package; True: run the fused stage-1 block (K5, its plain
# version on CPU tensors); False: never, whatever the environment says. The
# environment variable FORCE_PALLAS_REID_BLOCK (=1 on, =0 off) drives both
# packages.
FORCE_PALLAS_REID_BLOCK = None


def _reid_block_on() -> bool:
    """The JAX `_reid_block_mode` decision: fused stage-1 block or not."""
    env = os.environ.get("FORCE_PALLAS_REID_BLOCK")
    if FORCE_PALLAS_REID_BLOCK is False or env == "0":
        return False
    return FORCE_PALLAS_REID_BLOCK is True or env == "1"


def _hwio_of(w: torch.Tensor) -> torch.Tensor:
    """The OIHW parameter `w` as K5's HWIO, kept per parameter (and its
    in-place version), so that K5's wrapper sees the same tensor on every
    call and finds its packed weights cached."""
    return cached("hwio", (w,), lambda: hwio(w))


def _block_fused(p, s, x):
    """Stage-1 block through K5 (BN folded) on x in the compute dtype; out in it."""
    a1, b1 = fold_bn(p["bn1"]["scale"], p["bn1"]["bias"], s["bn1"]["mean"], s["bn1"]["var"], BN_EPS)
    a2, b2 = fold_bn(p["bn2"]["scale"], p["bn2"]["bias"], s["bn2"]["mean"], s["bn2"]["var"], BN_EPS)
    w1, w2 = _hwio_of(p["conv1"]["w"]), _hwio_of(p["conv2"]["w"])
    return reid_block64(x, w1, w2, a1, b1, a2, b2)


def _trunk(params, stats, x: torch.Tensor, dtype, parity: bool) -> torch.Tensor:
    """Inference trunk: x [N, 3, 50, 50] -> the pooled [N, 512] f32, before
    normalisation. Each convolution's output goes through one BN epilogue
    (K8 on the card), which writes only what later ops read: the f32
    activation where a shortcut or a pool reads it, the copy in `dtype`
    where a convolution does."""
    st = params["stem"]
    y, _ = _bn_epilogue(_conv(x, st["w"], 1, 1, dtype), st["bn"], stats["stem"], dtype, f32=True,
                        feeds_conv=False, pre_bias=st["b"], relu=True)
    y = F.max_pool2d(y, 3, 2, 1)
    y_in = y.to(dtype)
    fused = _reid_block_on()
    names = [f"layer{si + 1}_{bi}" for si in range(len(STAGES)) for bi in range(2)]
    for i, name in enumerate(names):
        p, s, nxt = params[name], stats[name], names[i + 1] if i + 1 < len(names) else None
        stride = 2 if (STAGES[i // 2][2] and i % 2 == 0) else 1
        # the JAX conditions: stride 1, no downsample, 64 x 25 x 25, and
        # bf16 on the card (the CPU runs the plain version at any dtype;
        # `parity` also takes K5's f32 mode on the card, as JAX's
        # interpret mode does for the trainer's evaluation)
        if (fused and stride == 1 and "down" not in p and tuple(y_in.shape[1:]) == (64, 25, 25)
                and (dtype == torch.bfloat16 or parity or y_in.device.type == "cpu")):
            y, y_in = None, _block_fused(p, s, y_in)  # its f32 is y_in.float(), made where read
            continue
        if y is None and "down" not in p:
            y = y_in.float()
        # the f32 output is read by the next block's identity shortcut, or by the pool after the last
        y, y_in = _block(p, s, y, y_in, stride, dtype, f32=nxt is None or "down" not in params[nxt],
                         feeds_conv=nxt is not None)
    return F.avg_pool2d(y_in.float() if y is None else y, 4, 1).flatten(1)  # 50x50 input -> 4x4 -> 1x1


def _l2_normalise(emb: torch.Tensor) -> torch.Tensor:
    return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True), min=1e-12)


def reid_forward_nchw(params, stats, x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """x [N, 3, 50, 50] normalised crops -> L2-normalised [N, 512] f32."""
    return _l2_normalise(_trunk(params, stats, x, dtype, parity=False))


def reid_embed(params, stats, crops: torch.Tensor, dtype=None) -> torch.Tensor:
    """The JAX `reid_embed`: crops [N, 50, 50, 3] normalised -> L2-normalised
    [N, 512] f32 embeddings, the convolutions in `dtype` (None: f32). The
    embed of the tracker's step."""
    return reid_forward_nchw(params, stats, crops.permute(0, 3, 1, 2), torch.float32 if dtype is None else dtype)


def reid_forward(params, stats, x, *, train: bool = False, reid: bool = True, dropout_key=None, dtype=None):
    """The JAX call and contract: x [B, 50, 50, 3] normalised crops ->
    (out, new_stats), out the [B, 512] embeddings (reid=True) or the
    [B, num_classes] logits (reid=False); train=True uses the batch
    statistics and returns the updated running stats. `dropout_key` is a
    torch.Generator (the JAX PRNG key's place) that draws the head's
    dropout mask in training. `dtype` is the convolutions' compute dtype at
    inference (None: f32); training runs in f32, as the JAX trainer calls
    it, and takes no other. See `reid_apply`."""
    if train and dtype not in (None, torch.float32):
        raise ValueError(f"reid_forward trains in f32; dtype={dtype} is taken at inference only")
    return reid_apply(params, stats, x, train=train, reid=reid, dropout=dropout_key, dtype=dtype)


# ---------------------------------------------------------------------------
# the JAX `reid_forward` contract: training mode, the classifier head, shards
# ---------------------------------------------------------------------------

def dropout_keep(gen: torch.Generator, shape, device) -> torch.Tensor:
    """The dropout's keep mask, p = 0.5 (the JAX `jax.random.bernoulli`
    draw). A module-level function, so a test can replace it with the
    values JAX draws from the same key."""
    return torch.rand(shape, generator=gen, device=device) < 0.5


def _each(fn, *cols):
    """fn over the shards, each with its device made current."""
    out = []
    for args in zip(*cols):
        with on_device(args[0].device):
            out.append(fn(*args))
    return out


def _sum_on(parts, device):
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def _bn_train(ys, ps, s, axes):
    """Train-mode BatchNorm over the shards `ys` of one batch, written out
    as the JAX `_bn`: normalise with the batch mean and the biased batch
    variance over `axes` (two passes: the mean, then the mean of squared
    deviations, each summed over every shard on the first shard's device
    and sent back), and update the running stats with momentum 0.1 and the
    unbiased variance. Returns (shards, new running stats)."""
    d0 = ys[0].device
    shape = (1, -1, 1, 1) if len(axes) == 3 else (1, -1)
    n = sum(y.numel() for y in ys) / ys[0].shape[1]
    count = torch.full((), n, dtype=ys[0].dtype, device=d0)
    mean = _sum_on(_each(lambda y: y.sum(axes), ys), d0) / count
    means = [mean.to(y.device).view(shape) for y in ys]
    var = _sum_on(_each(lambda y, m: torch.square(y - m).sum(axes), ys, means), d0) / count
    invs = [torch.rsqrt(var + BN_EPS).to(y.device).view(shape) for y in ys]
    out = _each(lambda y, m, inv, p: (y - m) * inv * p["scale"].view(shape) + p["bias"].view(shape), ys, means, invs, ps)
    mean, var = mean.detach(), var.detach()
    unbiased = var * n / max(n - 1, 1)
    new_s = {"mean": (1 - BN_MOMENTUM) * s["mean"] + BN_MOMENTUM * mean,
             "var": (1 - BN_MOMENTUM) * s["var"] + BN_MOMENTUM * unbiased}
    return out, new_s


def _conv_train(xs, ps, stride, padding):
    return _each(lambda x, p: F.conv2d(x, p["w"], stride=stride, padding=padding), xs, ps)


def _block_train(ps, s, xs, stride: int):
    y = _conv_train(xs, [p["conv1"] for p in ps], stride, 1)
    y, s1 = _bn_train(y, [p["bn1"] for p in ps], s["bn1"], (0, 2, 3))
    y = _conv_train([torch.relu(t) for t in y], [p["conv2"] for p in ps], 1, 1)
    y, s2 = _bn_train(y, [p["bn2"] for p in ps], s["bn2"], (0, 2, 3))
    new_s = {"bn1": s1, "bn2": s2}
    if "down" in ps[0]:
        xs = _conv_train(xs, [p["down"] for p in ps], stride, 0)
        xs, new_s["down"] = _bn_train(xs, [p["down"]["bn"] for p in ps], s["down"], (0, 2, 3))
    return [torch.relu(a + b) for a, b in zip(xs, y)], new_s


def _trunk_train(pd, stats, xs):
    """Training trunk over the shards (batch statistics, no K5, as JAX's
    `reid_forward` with train=True): [n_i, 3, 50, 50] -> [n_i, 512]."""
    new_stats: Dict[str, Any] = {}
    y = _each(lambda x, p: F.conv2d(x, p["stem"]["w"], padding=1) + p["stem"]["b"].view(1, -1, 1, 1), xs, pd)
    y, new_stats["stem"] = _bn_train(y, [p["stem"]["bn"] for p in pd], stats["stem"], (0, 2, 3))
    y = _each(lambda t: F.max_pool2d(torch.relu(t), 3, 2, 1), y)
    for si, (_, _, ds) in enumerate(STAGES):
        for bi in range(2):
            name = f"layer{si + 1}_{bi}"
            y, new_stats[name] = _block_train([p[name] for p in pd], stats[name], y, 2 if (ds and bi == 0) else 1)
    return _each(lambda t: F.avg_pool2d(t, 4, 1).flatten(1), y), new_stats


def reid_apply(params, stats, x, *, train: bool = False, reid: bool = True, dropout=None, dtype=None):
    """The JAX `reid_forward(params, stats, x, train=, reid=, dropout_key=)`:
    x [B, 50, 50, 3] normalised crops, or a list of such shards on their
    devices (one batch split for data parallelism: the BN statistics and
    the dropout mask are the whole batch's). Returns (out, new_stats), out
    a tensor or a list of shards like x:
      reid=True  -> L2-normalised [B, 512] embeddings;
      reid=False -> [B, num_classes] logits of the classifier head.
    train=True normalises with the batch statistics and returns the
    updated running stats; `dropout` (a torch.Generator on the first
    shard's device, or None for no dropout) draws the head's keep mask.
    train=False is the inference path, the convolutions in `dtype` (None:
    f32), through K5 when the fused block is switched on (in f32 its
    parity mode on the card, as JAX's interpret mode). Each shard runs with
    weights copied to its device: autograd takes the gradients back to
    `params`."""
    shards = list(x) if isinstance(x, (list, tuple)) else [x]
    pdev = _leaf(params).device
    pd = [params if s.device == pdev else _tree_to(params, s.device) for s in shards]
    xs = [s.permute(0, 3, 1, 2) for s in shards]
    if train:
        embs, new_stats = _trunk_train(pd, stats, xs)
    else:
        sd = [stats if s.device == pdev else _tree_to(stats, s.device) for s in shards]
        cdt = torch.float32 if dtype is None else dtype
        embs = _each(lambda t, p, st: _trunk(p, st, t, cdt, parity=cdt == torch.float32), xs, pd, sd)
        new_stats = dict(stats)  # inference: the running stats pass through
    if reid:
        if "fc1" in stats:
            new_stats["fc1"] = stats["fc1"]
        out = _each(_l2_normalise, embs)
    else:
        h = _each(lambda e, p: e @ p["fc1"]["w"] + p["fc1"]["b"], embs, pd)
        if train:
            h, new_stats["fc1"] = _bn_train(h, [p["fc1"]["bn"] for p in pd], stats["fc1"], (0,))
        else:
            h = _each(lambda t, p, st: (t - st["fc1"]["mean"]) * torch.rsqrt(st["fc1"]["var"] + BN_EPS)
                      * p["fc1"]["bn"]["scale"] + p["fc1"]["bn"]["bias"], h, pd, sd)
        h = [torch.relu(t) for t in h]
        if train and dropout is not None:
            keep = dropout_keep(dropout, (sum(t.shape[0] for t in h), h[0].shape[1]), shards[0].device)
            keeps = [k.to(t.device) for k, t in zip(keep.split([t.shape[0] for t in h]), h)]
            h = [torch.where(k, t / 0.5, 0.0) for k, t in zip(keeps, h)]
        out = _each(lambda t, p: t @ p["fc2"]["w"] + p["fc2"]["b"], h, pd)
    return (out if isinstance(x, (list, tuple)) else out[0]), new_stats


def _leaf(tree):
    return _leaf(next(iter(tree.values()))) if isinstance(tree, dict) else tree


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------
# torch .t7 conversion (name-mapped, BN kept explicit)
# ---------------------------------------------------------------------------

def reid_state_dict_to_pytree(sd, device=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Map the reference's `net_dict` names onto (params, batch_stats).

    Torch layout: conv.0/conv.1 stem; layer{1..4}.{0,1}.conv1/bn1/conv2/bn2
    (+ .downsample.0/.1); classifier.0 (linear), .1 (bn1d), .4 (linear).
    Conv weights stay OIHW; dense weights are stored [in, out] as in the
    JAX package (the classifier head serves training, `reid_apply` with
    reid=False).
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
    return reid_state_dict_to_pytree(sd, device)


def cast_conv_weights(params, dtype: torch.dtype):
    """Conv weights (4-D "w" leaves) in the compute dtype, once; BN vectors,
    biases and dense weights stay f32."""
    if isinstance(params, dict):
        return {k: (v.to(dtype) if k == "w" and torch.is_tensor(v) and v.dim() == 4
                    else cast_conv_weights(v, dtype)) for k, v in params.items()}
    return params
