"""Plain YOLOv5 v6.0 detector: the network built from the config's own
backbone/head table (ultralytics' yaml), the anchor decode and the
class-aware greedy NMS, in plain PyTorch.

Conv + BatchNorm are folded (BN at identity), so each Conv is a conv with a
bias followed by SiLU. The weights are a dict keyed by the layer index, each
Conv {"w": OIHW, "b"}, each C3 {"cv1", "cv2", "cv3", "m": [{"cv1", "cv2"}]},
SPPF {"cv1", "cv2"}, Detect {"m": [conv per scale]}: the layout of the
ultralytics module tree.

Departures, both stated by the system under test: candidates are the 512
best scores above the threshold before NMS (ultralytics takes 30000), and a
candidate's class is the first arg-max of its class logits.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

MAX_WH = 7680.0  # class offset of the batched NMS


def _divisible(x: float, d: int = 8) -> int:
    return max(int(math.ceil(x / d) * d), d)


def layer_table(cfg) -> List[Tuple]:
    """[(from, n, module, cin, cout, args)] with the depth and width
    multiples applied, as ultralytics' `parse_model` does."""
    gd, gw = cfg["depth_multiple"], cfg["width_multiple"]
    ch = []  # ch[j]: layer j's output channels
    out = []
    for f, n, m, args in cfg["backbone"] + cfg["head"]:
        n = max(round(n * gd), 1) if n > 1 else n
        if m in ("Conv", "C3", "SPPF"):
            cin, cout = (ch[f] if ch else 3), _divisible(args[0] * gw)
        elif m == "Concat":
            cin, cout = None, sum(ch[x] for x in f)
        elif m == "Detect":
            cin, cout = [ch[x] for x in f], None
        else:  # nn.Upsample
            cin, cout = ch[f], ch[f]
        out.append((f, n, m, cin, cout, args))
        ch.append(cout)
    return out


def strides(cfg) -> Tuple[int, ...]:
    """The stride of each Detect input, in order, as ultralytics' stride
    probe finds it: a Conv multiplies the running stride by its stride
    argument, nn.Upsample halves it, a Concat takes its inputs' stride
    (they must agree), the other modules keep it."""
    st = []  # st[j]: layer j's output stride
    for f, n, m, cin, cout, args in layer_table(cfg):
        s = st[f] if st and isinstance(f, int) else 1
        if m == "Conv":
            s *= args[2] if len(args) > 2 else 1
        elif m == "nn.Upsample":
            if s % 2:
                raise ValueError(f"layer {len(st)}: nn.Upsample of a stride-{s} input")
            s //= 2
        elif m == "Concat":
            ins = {st[j] for j in f}
            if len(ins) != 1:
                raise ValueError(f"layer {len(st)}: Concat of inputs at strides {sorted(ins)}")
            s = ins.pop()
        elif m == "Detect":
            return tuple(st[j] for j in f)
        st.append(s)
    raise ValueError("the layer table has no Detect layer")


def conv_shapes(cfg) -> Dict[str, object]:
    """The weight tree's shapes: the same nesting as the weights, each conv
    as (cout, cin, k). Drawing order is the order of this tree."""
    na, no = len(cfg["anchors"][0]) // 2, cfg["nc"] + 5
    tree = {}
    for i, (f, n, m, cin, cout, args) in enumerate(layer_table(cfg)):
        if m == "Conv":
            tree[str(i)] = (cout, cin, args[1])
        elif m == "C3":
            c_ = cout // 2
            tree[str(i)] = {"cv1": (c_, cin, 1), "cv2": (c_, cin, 1), "cv3": (cout, 2 * c_, 1),
                            "m": [{"cv1": (c_, c_, 1), "cv2": (c_, c_, 3)} for _ in range(n)]}
        elif m == "SPPF":
            c_ = cin // 2
            tree[str(i)] = {"cv1": (c_, cin, 1), "cv2": (cout, c_ * 4, 1)}
        elif m == "Detect":
            tree[str(i)] = {"m": [(na * no, c, 1) for c in cin]}
    return tree


def _conv(p, x, stride=1, pad=None, act=True, q=None):
    w = p["w"]
    if q is not None:
        x, w = q(x), q(w)
    y = F.conv2d(x, w, p["b"], stride=stride, padding=w.shape[-1] // 2 if pad is None else pad)
    return F.silu(y) if act else y


def _c3(p, x, shortcut, q):
    y1 = _conv(p["cv1"], x, q=q)
    for b in p["m"]:
        h = _conv(b["cv2"], _conv(b["cv1"], y1, q=q), q=q)
        y1 = y1 + h if shortcut else h
    return _conv(p["cv3"], torch.cat([y1, _conv(p["cv2"], x, q=q)], 1), q=q)


def _sppf(p, x, q):
    y = [_conv(p["cv1"], x, q=q)]
    for _ in range(3):
        y.append(F.max_pool2d(y[-1], 5, 1, 2))
    return _conv(p["cv2"], torch.cat(y, 1), q=q)


def forward(cfg, weights, images: torch.Tensor, q=None) -> List[torch.Tensor]:
    """images [B, 3, H, W] f32 in [0, 1] -> raw heads [B, na*no, Hs, Ws] per
    scale. `q`, when given, rounds every conv's input and weight (the
    lower-precision control)."""
    ys = []
    x = images
    for i, (f, n, m, cin, cout, args) in enumerate(layer_table(cfg)):
        p = weights.get(str(i))
        if m == "Conv":
            x = _conv(p, x, stride=args[2] if len(args) > 2 else 1, pad=args[3] if len(args) > 3 else None, q=q)
        elif m == "C3":
            x = _c3(p, x, shortcut=args[1] if len(args) > 1 else True, q=q)
        elif m == "SPPF":
            x = _sppf(p, x, q)
        elif m == "nn.Upsample":
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        elif m == "Concat":
            x = torch.cat([x if j == -1 else ys[j] for j in f], 1)
        elif m == "Detect":
            return [_conv(c, ys[j], act=False, q=q) for c, j in zip(p["m"], f)]
        ys.append(x)
    raise ValueError("the layer table has no Detect layer")


def decode(cfg, heads) -> Dict[str, torch.Tensor]:
    """Every anchor of every scale, each at its stride in the table
    (`strides`): boxes xyxy in network pixels, score = sigmoid(obj) *
    sigmoid(max class logit), class = first arg-max. Anchor order: scale,
    then cell (row-major), then anchor. Raises unless there is one anchor
    set and one head per Detect input."""
    na = len(cfg["anchors"][0]) // 2
    nc = cfg["nc"]
    st = strides(cfg)
    if not len(heads) == len(st) == len(cfg["anchors"]):
        raise ValueError(f"{len(cfg['anchors'])} anchor sets for {len(st)} Detect inputs and {len(heads)} heads")
    boxes, scores, classes = [], [], []
    for head, stride, anc in zip(heads, st, cfg["anchors"]):
        b, _, h, w = head.shape
        p = head.float().reshape(b, na, nc + 5, h, w).permute(0, 3, 4, 1, 2)  # [B, h, w, na, no]
        gy, gx = torch.meshgrid(torch.arange(h, device=head.device), torch.arange(w, device=head.device),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1)[None, :, :, None, :].float()
        anchor = torch.tensor(anc, dtype=torch.float32, device=head.device).reshape(1, 1, 1, na, 2)
        s = torch.sigmoid(p[..., :4])
        xy = (s[..., :2] * 2 - 0.5 + grid) * stride
        wh = (s[..., 2:4] * 2) ** 2 * anchor
        boxes.append(torch.cat([xy - wh / 2, xy + wh / 2], -1).reshape(b, -1, 4))
        logit = p[..., 5:]
        cmax = logit.amax(-1)
        lane = torch.arange(nc, device=head.device)
        cls = torch.where(logit == cmax[..., None], lane, nc).amin(-1)
        scores.append((torch.sigmoid(p[..., 4]) * torch.sigmoid(cmax)).reshape(b, -1))
        classes.append(cls.reshape(b, -1))
    return {"boxes": torch.cat(boxes, 1), "scores": torch.cat(scores, 1), "classes": torch.cat(classes, 1)}


def _iou(a, b):
    """[..., N, 4] x [..., M, 4] xyxy -> [..., N, M]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def nms(dec, conf_thres: float, iou_thres: float, max_det: int, pre_nms_topk: int):
    """Greedy class-aware NMS per image, candidates in descending score
    (ties to the lower anchor index), then at most `max_det` kept in
    descending score. Returns per image (boxes [n, 4], scores [n], classes
    [n]) lists."""
    sc = torch.where(dec["scores"] > conf_thres, dec["scores"], torch.full_like(dec["scores"], -1.0))
    k = min(pre_nms_topk, sc.shape[1])
    top, idx = torch.sort(sc, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    valid = top > 0
    bx = torch.gather(dec["boxes"], 1, idx[..., None].expand(-1, -1, 4))
    cl = torch.gather(dec["classes"], 1, idx)
    off = bx + cl[..., None].float() * MAX_WH
    over = _iou(off, off) > iou_thres  # [B, k, k]
    keep = torch.zeros_like(valid)
    for i in range(k):  # the greedy order: a candidate stands unless a kept better one overlaps it
        keep[:, i] = valid[:, i] & ~(keep[:, :i] & over[:, :i, i]).any(-1)
    out = []
    for b in range(sc.shape[0]):
        sel = torch.nonzero(keep[b]).flatten()[:max_det]
        out.append((bx[b, sel], top[b, sel], cl[b, sel]))
    return out


def restore(boxes, src_hw, net_hw):
    """Network-pixel xyxy -> source pixels, clipped to the frame."""
    sh, sw = src_hw
    gain = min(net_hw[0] / sh, net_hw[1] / sw)
    pad_x = (net_hw[1] - round(sw * gain)) / 2
    pad_y = (net_hw[0] - round(sh * gain)) / 2
    x = ((boxes[..., 0::2] - pad_x) / gain).clamp(0, sw)
    y = ((boxes[..., 1::2] - pad_y) / gain).clamp(0, sh)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1)


def detect(cfg, weights, images, conf_thres: float, q=None):
    """images [B, 3, H, W] f32 in [0, 1] -> per image (boxes in source
    pixels, scores, detector classes)."""
    dets = nms(decode(cfg, forward(cfg, weights, images, q)), conf_thres, cfg["iou_thres"], cfg["max_det"],
               cfg["pre_nms_topk"])
    return [(restore(b, cfg["source_hw"], cfg["net_hw"]), s, c) for b, s, c in dets]
