"""Plain DeepSORT appearance network (the reference's `deep/model.py` Net at
50x50 crops): conv3x3 + BN + ReLU + maxpool(3, 2, 1), four stages of two
residual BasicBlocks, average pool, L2-normalised embedding. Plain PyTorch,
BatchNorm in inference form.

Weights: {"stem": {"w", "b", "bn": {"scale", "bias"}}, "layer<s>_<b>":
{"conv1": {"w"}, "bn1", "conv2": {"w"}, "bn2", ["down": {"w", "bn"}]}} and
running statistics {"stem": {"mean", "var"}, "layer<s>_<b>": {"bn1", "bn2",
["down"]}}.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def block_names(rcfg):
    """[(name, cin, cout, stride, has_down)] of every BasicBlock."""
    out = []
    for si, (cin, cout, ds) in enumerate(rcfg["stages"]):
        for bi in range(rcfg["blocks_per_stage"]):
            b_cin = cin if bi == 0 else cout
            stride = 2 if (ds and bi == 0) else 1
            out.append((f"layer{si + 1}_{bi}", b_cin, cout, stride, stride != 1 or b_cin != cout))
    return out


def _bn(x, p, s, eps):
    shape = (1, -1, 1, 1)
    return (x - s["mean"].view(shape)) / torch.sqrt(s["var"].view(shape) + eps) * p["scale"].view(shape) \
        + p["bias"].view(shape)


def embed(rcfg, params, stats, crops: torch.Tensor, q=None) -> torch.Tensor:
    """crops [N, 3, 50, 50] normalised -> [N, embed_dim] unit vectors.
    `q`, when given, rounds every conv's input and weight."""
    eps = rcfg["bn_eps"]

    def conv(x, w, stride, pad, b=None):
        if q is not None:
            x, w = q(x), q(w)
        return F.conv2d(x, w, b, stride=stride, padding=pad)

    st = params["stem"]
    y = conv(crops, st["w"], 1, 1, st["b"])
    y = F.max_pool2d(torch.relu(_bn(y, st["bn"], stats["stem"], eps)), 3, 2, 1)
    for name, _, _, stride, down in block_names(rcfg):
        p, s = params[name], stats[name]
        h = torch.relu(_bn(conv(y, p["conv1"]["w"], stride, 1), p["bn1"], s["bn1"], eps))
        h = _bn(conv(h, p["conv2"]["w"], 1, 1), p["bn2"], s["bn2"], eps)
        if down:
            y = _bn(conv(y, p["down"]["w"], stride, 0), p["down"]["bn"], s["down"], eps)
        y = torch.relu(y + h)
    e = F.avg_pool2d(y, rcfg["avg_pool"], 1).flatten(1)
    return e / e.norm(dim=1, keepdim=True).clamp(min=1e-12)
