"""YOLOv5 (v6.0 graph) in PyTorch: CSPDarknet backbone, SPPF, PANet neck and
the 3-scale Detect head, with the n/s/m/l/x depth/width multiples.

Port of `vehicle_counting_tpu/models/yolo.py`. Params are a plain dict
keyed by the canonical layer index ("0".."24"), conv+BN already folded, in
OIHW layout (`models/convert.py::yolo_params_from_jax` carries the JAX
pytree across). `yolov5_forward` keeps the JAX layout (NHWC images in,
NHWC heads out); `yolov5_forward_nchw` is what the pipeline runs on its
planar pixels.
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

# depth_multiple, width_multiple per variant (public yolov5 model family)
VARIANTS: Dict[str, Tuple[float, float]] = {
    "yolov5n": (0.33, 0.25),
    "yolov5s": (0.33, 0.50),
    "yolov5m": (0.67, 0.75),
    "yolov5l": (1.00, 1.00),
    "yolov5x": (1.33, 1.25),
}

# COCO anchors (pixels) per detection scale P3/P4/P5
DEFAULT_ANCHORS: Tuple[Tuple[Tuple[float, float], ...], ...] = (
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)
STRIDES = (8, 16, 32)


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
    """Random-init full param dict (layer index -> module params)."""
    w, d = cfg.width, cfg.depth
    c64, c128, c256, c512, c1024 = w(64), w(128), w(256), w(512), w(1024)
    L: Dict[str, Any] = {}
    L["0"] = init_conv(gen, 6, 3, c64, device=device)        # P1/2
    L["1"] = init_conv(gen, 3, c64, c128, device=device)     # P2/4
    L["2"] = _init_c3(gen, c128, c128, d(3), device)
    L["3"] = init_conv(gen, 3, c128, c256, device=device)    # P3/8
    L["4"] = _init_c3(gen, c256, c256, d(6), device)
    L["5"] = init_conv(gen, 3, c256, c512, device=device)    # P4/16
    L["6"] = _init_c3(gen, c512, c512, d(9), device)
    L["7"] = init_conv(gen, 3, c512, c1024, device=device)   # P5/32
    L["8"] = _init_c3(gen, c1024, c1024, d(3), device)
    L["9"] = {"cv1": init_conv(gen, 1, c1024, c1024 // 2, device=device),  # SPPF
              "cv2": init_conv(gen, 1, c1024 // 2 * 4, c1024, device=device)}
    L["10"] = init_conv(gen, 1, c1024, c512, device=device)
    L["13"] = _init_c3(gen, c1024, c512, d(3), device)
    L["14"] = init_conv(gen, 1, c512, c256, device=device)
    L["17"] = _init_c3(gen, c512, c256, d(3), device)
    L["18"] = init_conv(gen, 3, c256, c256, device=device)
    L["20"] = _init_c3(gen, c512, c512, d(3), device)
    L["21"] = init_conv(gen, 3, c512, c512, device=device)
    L["23"] = _init_c3(gen, c1024, c1024, d(3), device)
    L["24"] = {"m": [init_conv(gen, 1, c, cfg.na * cfg.no, device=device) for c in (c256, c512, c1024)]}
    return L


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
    scale, in the params' dtype."""
    L = params
    x = conv_block_nchw(L["0"], images, stride=2, padding=2)
    x = conv_block_nchw(L["1"], x, stride=2)
    x = _c3(L["2"], x, shortcut=True)
    x = conv_block_nchw(L["3"], x, stride=2)
    p3 = _c3(L["4"], x, shortcut=True)
    x = conv_block_nchw(L["5"], p3, stride=2)
    p4 = _c3(L["6"], x, shortcut=True)
    x = conv_block_nchw(L["7"], p4, stride=2)
    x = _c3(L["8"], x, shortcut=True)
    p5 = _sppf(L["9"], x)
    t10 = conv_block_nchw(L["10"], p5)
    x = _c3(L["13"], torch.cat([upsample2x_nearest_nchw(t10), p4], dim=1), shortcut=False)
    t14 = conv_block_nchw(L["14"], x)
    o3 = _c3(L["17"], torch.cat([upsample2x_nearest_nchw(t14), p3], dim=1), shortcut=False)
    x = conv_block_nchw(L["18"], o3, stride=2)
    o4 = _c3(L["20"], torch.cat([x, t14], dim=1), shortcut=False)
    x = conv_block_nchw(L["21"], o4, stride=2)
    o5 = _c3(L["23"], torch.cat([x, t10], dim=1), shortcut=False)
    return [conv_block_nchw(m, o, act=False) for m, o in zip(L["24"]["m"], (o3, o4, o5))]


def _check_params(params, cfg: YoloConfig) -> None:
    """Raise unless `params` are a `cfg` network: the stem's width and the
    three heads' na * no channels."""
    stem = params["0"]["w"].shape[0]
    heads = [m["w"].shape[0] for m in params["24"]["m"]]
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
