"""YOLOv5 (v6.0 graph) in PyTorch: CSPDarknet backbone, SPPF, PANet neck and
the Detect head, with the n/s/m/l/x depth/width multiples, in two graphs:
P5 (three Detect scales at strides 8/16/32, `yolov5s.yaml`) and P6 (four
at 8/16/32/64, `hub/yolov5s6.yaml`: a 768-wide stride-32 stage before the
1024-wide stride-64 one, and one more step up and down the neck).

Port of `vehicle_counting_tpu/models/yolo.py`, which has the P5 graph
alone. Params are a plain dict keyed by ultralytics' layer index ("0".."24"
for P5, "0".."33" for P6, the Detect layer last), conv+BN already folded,
in OIHW layout (`models/convert.py::yolo_params_from_jax` carries the JAX
pytree across). The graph is the number of scales: `len(cfg.strides)` when
building, the Detect layer's head count when running. `default_config`
gives a variant its own anchors and strides. `yolov5_forward` keeps the JAX
layout (NHWC images in, NHWC heads out); `yolov5_forward_nchw` is what the
pipeline runs on its planar pixels.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from vehicle_counting_tpu_torch.models.layers import (
    conv_block_nchw,
    init_conv,
    upsample2x_nearest_nchw,
)

# depth_multiple, width_multiple per variant (public yolov5 model family);
# a P6 variant (name ending in 6) takes its P5 sibling's multiples
VARIANTS: Dict[str, Tuple[float, float]] = {
    "yolov5n": (0.33, 0.25),
    "yolov5s": (0.33, 0.50),
    "yolov5m": (0.67, 0.75),
    "yolov5l": (1.00, 1.00),
    "yolov5x": (1.33, 1.25),
    "yolov5n6": (0.33, 0.25),
    "yolov5s6": (0.33, 0.50),
    "yolov5m6": (0.67, 0.75),
    "yolov5l6": (1.00, 1.00),
    "yolov5x6": (1.33, 1.25),
}

# COCO anchors (pixels) per detection scale P3/P4/P5
DEFAULT_ANCHORS: Tuple[Tuple[Tuple[float, float], ...], ...] = (
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)
STRIDES = (8, 16, 32)
# the P6 models' COCO anchors per scale P3/P4/P5/P6 (v6.0 hub/yolov5s6.yaml)
P6_ANCHORS: Tuple[Tuple[Tuple[float, float], ...], ...] = (
    ((19, 27), (44, 40), (38, 94)),
    ((96, 68), (86, 152), (180, 137)),
    ((140, 301), (303, 264), (238, 542)),
    ((436, 615), (739, 380), (925, 792)),
)
P6_STRIDES = (8, 16, 32, 64)

# per number of Detect scales: the backbone's stage widths (before the width
# multiple; the last stage feeds SPPF) and each stage's C3 depth
_STAGES = {
    3: ((128, 256, 512, 1024), (3, 6, 9, 3)),
    4: ((128, 256, 512, 768, 1024), (3, 6, 9, 3, 3)),
}


def make_divisible(x: float, divisor: int = 8) -> int:
    return max(int(math.ceil(x / divisor) * divisor), divisor)


@dataclass(frozen=True)
class YoloConfig:
    variant: str = "yolov5s"
    num_classes: int = 80
    anchors: Tuple = DEFAULT_ANCHORS
    strides: Tuple[int, ...] = STRIDES

    @property
    def depth_multiple(self) -> float:
        return VARIANTS[self.variant][0]

    @property
    def width_multiple(self) -> float:
        return VARIANTS[self.variant][1]

    def width(self, c: int) -> int:
        return make_divisible(c * self.width_multiple, 8)

    def depth(self, n: int) -> int:
        return max(round(n * self.depth_multiple), 1) if n > 1 else n

    @property
    def na(self) -> int:
        return len(self.anchors[0])

    @property
    def no(self) -> int:
        return self.num_classes + 5


def default_config(variant: str = "yolov5s", num_classes: int = 80) -> YoloConfig:
    """`variant`'s config with its own default anchors and strides: four
    scales for a P6 variant (`yolov5s6`), three otherwise. Raises KeyError
    for a name `VARIANTS` does not hold."""
    if variant not in VARIANTS:
        raise KeyError(variant)
    if variant.endswith("6"):
        return YoloConfig(variant, num_classes, P6_ANCHORS, P6_STRIDES)
    return YoloConfig(variant, num_classes)


def _stages(n_scales: int):
    if n_scales not in _STAGES:
        raise ValueError(f"a YOLOv5 v6.0 graph has 3 (P5) or 4 (P6) Detect scales, not {n_scales}")
    return _STAGES[n_scales]


def _init_c3(gen, cin: int, cout: int, n: int, device, e: float = 0.5) -> Dict[str, Any]:
    ch = int(cout * e)
    return {
        "cv1": init_conv(gen, 1, cin, ch, device=device),
        "cv2": init_conv(gen, 1, cin, ch, device=device),
        "cv3": init_conv(gen, 1, 2 * ch, cout, device=device),
        "m": [
            {"cv1": init_conv(gen, 1, ch, ch, device=device),
             "cv2": init_conv(gen, 3, ch, ch, device=device)}
            for _ in range(n)
        ],
    }


def init_yolov5(gen: torch.Generator, cfg: YoloConfig, device=None) -> Dict[str, Any]:
    """Random-init full param dict (layer index -> module params), drawn in
    layer order; the graph has `len(cfg.strides)` Detect scales."""
    w, d = cfg.width, cfg.depth
    widths, depths = _stages(len(cfg.strides))
    L: Dict[str, Any] = {}
    L["0"] = init_conv(gen, 6, 3, w(64), device=device)  # P1/2
    c = w(64)
    for i, (ci, n) in enumerate(zip(widths, depths)):  # P2/4 .. the last stage
        L[str(1 + 2 * i)] = init_conv(gen, 3, c, w(ci), device=device)
        c = w(ci)
        L[str(2 + 2 * i)] = _init_c3(gen, c, c, d(n), device)
    k = 2 * len(widths) + 1
    L[str(k)] = {"cv1": init_conv(gen, 1, c, c // 2, device=device),  # SPPF
                 "cv2": init_conv(gen, 1, c // 2 * 4, c, device=device)}
    k += 1
    levels = [w(ci) for ci in widths[1:-1]]  # the backbone outputs the neck takes, stride 8 up
    for cl in reversed(levels):  # up: lateral conv, upsample, concat, C3
        L[str(k)] = init_conv(gen, 1, c, cl, device=device)
        L[str(k + 3)] = _init_c3(gen, 2 * cl, cl, d(3), device)
        c, k = cl, k + 4
    heads = [c]
    for cl, cout in zip(levels, [w(ci) for ci in widths[2:]]):  # down: conv, concat, C3
        L[str(k)] = init_conv(gen, 3, c, c, device=device)
        L[str(k + 2)] = _init_c3(gen, c + cl, cout, d(3), device)
        c, k = cout, k + 3
        heads.append(c)
    L[str(k)] = {"m": [init_conv(gen, 1, ch, cfg.na * cfg.no, device=device) for ch in heads]}
    return L


def detect_key(params) -> str:
    """The Detect layer's key: the last layer ("24" for P5, "33" for P6)."""
    return str(max(int(k) for k in params))


def config_for_params(variant: str, params) -> YoloConfig:
    """`variant`'s default config with the class count of loaded `params`.
    Raises ValueError when the params have another number of Detect scales
    than the variant (a P6 checkpoint under a P5 name, or the reverse)."""
    heads = params[detect_key(params)]["m"]
    cfg = default_config(variant, heads[0]["b"].shape[0] // 3 - 5)
    if len(heads) != len(cfg.strides):
        raise ValueError(f"the weights have {len(heads)} Detect scales, but {variant} has "
                         f"{len(cfg.strides)}: name the model the weights are (e.g. "
                         f"{'yolov5s6' if len(heads) == 4 else 'yolov5s'})")
    return cfg


def cast_params(tree, dtype: torch.dtype):
    """Params in the compute dtype (weights and biases): bf16 on the card."""
    if isinstance(tree, dict):
        return {k: cast_params(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_params(v, dtype) for v in tree]
    return tree.to(dtype)


def _c3(p, x, *, shortcut: bool):
    y1 = conv_block_nchw(p["cv1"], x)
    for m in p["m"]:
        h = conv_block_nchw(m["cv2"], conv_block_nchw(m["cv1"], y1))
        y1 = y1 + h if shortcut else h
    y2 = conv_block_nchw(p["cv2"], x)
    return conv_block_nchw(p["cv3"], torch.cat([y1, y2], dim=1))


def _sppf(p, x):
    y = conv_block_nchw(p["cv1"], x)
    m1 = F.max_pool2d(y, 5, 1, 2)
    m2 = F.max_pool2d(m1, 5, 1, 2)
    m3 = F.max_pool2d(m2, 5, 1, 2)
    return conv_block_nchw(p["cv2"], torch.cat([y, m1, m2, m3], dim=1))


def yolov5_forward_nchw(params, images: torch.Tensor) -> List[torch.Tensor]:
    """images [B, 3, H, W] in [0, 1] -> raw heads [B, na*no, Hs, Ws] per
    scale, in the params' dtype. The graph is the Detect layer's head
    count; H and W must be multiples of the last stride (32 for P5, 64
    for P6)."""
    L = params
    head = detect_key(L)
    n_stages = len(_stages(len(L[head]["m"]))[0])
    x = conv_block_nchw(L["0"], images, stride=2, padding=2)
    levels = []  # the backbone outputs the neck takes, stride 8 up
    for i in range(n_stages):
        x = conv_block_nchw(L[str(1 + 2 * i)], x, stride=2)
        x = _c3(L[str(2 + 2 * i)], x, shortcut=True)
        if 0 < i < n_stages - 1:
            levels.append(x)
    k = 2 * n_stages + 1
    x = _sppf(L[str(k)], x)
    k += 1
    laterals = []
    for feat in reversed(levels):  # up
        t = conv_block_nchw(L[str(k)], x)
        laterals.append(t)
        x = _c3(L[str(k + 3)], torch.cat([upsample2x_nearest_nchw(t), feat], dim=1), shortcut=False)
        k += 4
    outs = [x]
    for t in reversed(laterals):  # down
        x = conv_block_nchw(L[str(k)], x, stride=2)
        x = _c3(L[str(k + 2)], torch.cat([x, t], dim=1), shortcut=False)
        outs.append(x)
        k += 3
    return [conv_block_nchw(m, o, act=False) for m, o in zip(L[head]["m"], outs)]


def _check_params(params, cfg: YoloConfig) -> None:
    """Raise unless `params` are a `cfg` network: the stem's width and one
    head of na * no channels per stride."""
    stem = params["0"]["w"].shape[0]
    heads = [m["w"].shape[0] for m in params[detect_key(params)]["m"]]
    if stem != cfg.width(64) or heads != [cfg.na * cfg.no] * len(cfg.strides):
        raise ValueError(f"params (stem {stem} channels, heads {heads}) are not a {cfg.variant} with "
                         f"{cfg.num_classes} classes (stem {cfg.width(64)}, heads {cfg.na * cfg.no} each)")


def yolov5_forward(params, images: torch.Tensor, cfg: YoloConfig, *, dtype=torch.bfloat16) -> List[torch.Tensor]:
    """The JAX call: images [B, H, W, 3] in [0, 1] -> heads [B, Hs, Ws,
    na*no] per scale, in the compute dtype `dtype` (None: the params'
    own). `cfg` is checked against the params."""
    _check_params(params, cfg)
    if dtype is not None:
        params = cast_params(params, dtype)
    heads = yolov5_forward_nchw(params, images.permute(0, 3, 1, 2))
    return [h.permute(0, 2, 3, 1) for h in heads]


def decode_predictions(heads: Sequence[torch.Tensor], cfg: YoloConfig) -> Dict[str, torch.Tensor]:
    """Anchor-grid decode of NHWC heads to input-pixel space, [B, A, ...].

    xy = (2 s_xy - 0.5 + grid) * stride, wh = (2 s_wh)^2 * anchor,
    score = sigmoid(obj) * sigmoid(max class logit), class = first argmax.
    """
    outs_box, outs_obj, outs_cls = [], [], []
    for head, stride, anchors in zip(heads, cfg.strides, cfg.anchors):
        b, h, w, _ = head.shape
        p = head.reshape(b, h, w, cfg.na, cfg.no)
        s_xywh = torch.sigmoid(p[..., 0:4].float())
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=head.device),
            torch.arange(w, dtype=torch.float32, device=head.device), indexing="ij",
        )
        grid = torch.stack([gx, gy], dim=-1)[None, :, :, None, :]
        anc = torch.tensor(anchors, dtype=torch.float32, device=head.device)[None, None, None]
        xy = (s_xywh[..., 0:2] * 2.0 - 0.5 + grid) * float(stride)
        wh = torch.square(s_xywh[..., 2:4] * 2.0) * anc
        outs_box.append(torch.cat([xy, wh], dim=-1).reshape(b, h * w * cfg.na, 4))
        outs_obj.append(torch.sigmoid(p[..., 4].float()).reshape(b, h * w * cfg.na))
        outs_cls.append(p[..., 5:].reshape(b, h * w * cfg.na, cfg.num_classes))
    boxes = torch.cat(outs_box, dim=1)
    obj = torch.cat(outs_obj, dim=1)
    cls_logit = torch.cat(outs_cls, dim=1)
    cls_max = cls_logit.amax(-1)
    lane = torch.arange(cfg.num_classes, device=cls_logit.device)
    best_cls = torch.where(cls_logit == cls_max[..., None], lane, cfg.num_classes).amin(-1).to(torch.int32)
    scores = obj * torch.sigmoid(cls_max.float())
    x1 = boxes[..., 0] - boxes[..., 2] / 2
    y1 = boxes[..., 1] - boxes[..., 3] / 2
    xyxy = torch.stack([x1, y1, x1 + boxes[..., 2], y1 + boxes[..., 3]], dim=-1)
    return {"boxes": xyxy, "scores": scores, "classes": best_cls, "obj": obj}
