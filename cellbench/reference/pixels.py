"""Plain pixel path: the letterbox of raw RGB frames to the network input,
its I420 round trip, and the ReID crops, in plain PyTorch.

- Letterbox: bilinear resize with half-pixel centres and no anti-aliasing
  (cv2's INTER_LINEAR), rounded to u8, pasted into the 114-gray canvas at
  round(pad - 0.1).
- I420: BT.601 studio swing; chroma taken from the top-left pixel of each
  2x2 block (cv2's COLOR_RGB2YUV_I420), back to RGB by nearest chroma
  upsampling, clipped and truncated to u8 (cv2's COLOR_YUV2RGB_I420).
- Crops: integer bounds x1 = max(int(x1), 0), x2 = min(int(x2), W - 1) of
  the box in letterbox pixels; bilinear resize of [x1, x2) x [y1, y2) to
  50x50 with src = (dst + 0.5) * size / 50 - 0.5 clamped inside the crop;
  /255, then ImageNet mean and std.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PAD = 114


def letterbox_geometry(src_hw, net_hw):
    """(gain, left, top, new_w, new_h)."""
    sh, sw = src_hw
    gain = min(net_hw[0] / sh, net_hw[1] / sw)
    new_w, new_h = round(sw * gain), round(sh * gain)
    return gain, int(round((net_hw[1] - new_w) / 2 - 0.1)), int(round((net_hw[0] - new_h) / 2 - 0.1)), new_w, new_h


def box_transform(src_hw, net_hw):
    """(gain, pad_x, pad_y): source pixels -> letterbox pixels, x * gain + pad."""
    gain, _, _, new_w, new_h = letterbox_geometry(src_hw, net_hw)
    return gain, (net_hw[1] - new_w) / 2, (net_hw[0] - new_h) / 2


def letterbox_rgb(frames: torch.Tensor, net_hw) -> torch.Tensor:
    """[B, H, W, 3] u8 -> planar [B, 3, h, w] u8 letterbox."""
    b, sh, sw, _ = frames.shape
    _, left, top, new_w, new_h = letterbox_geometry((sh, sw), net_hw)
    x = frames.permute(0, 3, 1, 2).float()
    r = F.interpolate(x, size=(new_h, new_w), mode="bilinear", align_corners=False, antialias=False)
    out = torch.full((b, 3) + tuple(net_hw), PAD, dtype=torch.uint8, device=frames.device)
    out[:, :, top:top + new_h, left:left + new_w] = torch.floor(r + 0.5).clamp(0, 255).to(torch.uint8)
    return out


def i420_round_trip(rgb: torch.Tensor) -> torch.Tensor:
    """Planar u8 RGB [B, 3, h, w] -> I420 -> planar u8 RGB."""
    r, g, b = (rgb[:, i].float() for i in range(3))
    y = torch.floor(16 + 0.256788 * r + 0.504129 * g + 0.097906 * b + 0.5).clamp(0, 255)
    rs, gs, bs = r[:, 0::2, 0::2], g[:, 0::2, 0::2], b[:, 0::2, 0::2]
    u = torch.floor(128 - 0.148223 * rs - 0.290993 * gs + 0.439216 * bs + 0.5).clamp(0, 255)
    v = torch.floor(128 + 0.439216 * rs - 0.367788 * gs - 0.071427 * bs + 0.5).clamp(0, 255)
    u = u.repeat_interleave(2, 1).repeat_interleave(2, 2) - 128
    v = v.repeat_interleave(2, 1).repeat_interleave(2, 2) - 128
    yy = (y - 16) * 1.164
    out = torch.stack([yy + 1.596027 * v, yy - 0.391762 * u - 0.812968 * v, yy + 2.017232 * u], 1)
    return out.clamp(0, 255).to(torch.uint8)


def network_pixels(frames: torch.Tensor, net_hw) -> torch.Tensor:
    """Raw frames [B, H, W, 3] u8 -> the planar u8 RGB the detector and
    the crops read."""
    return i420_round_trip(letterbox_rgb(frames, net_hw))


def crops(pixels: torch.Tensor, frame_idx: torch.Tensor, boxes: torch.Tensor, crop_hw, mean, std) -> torch.Tensor:
    """pixels [B, 3, h, w] u8; frame_idx [D]; boxes [D, 4] xyxy letterbox
    pixels -> normalised crops [D, 3, ch, cw] f32."""
    _, _, h, w = pixels.shape
    oh, ow = crop_hw
    x1 = boxes[:, 0].to(torch.int64).clamp(min=0)
    y1 = boxes[:, 1].to(torch.int64).clamp(min=0)
    x2 = boxes[:, 2].to(torch.int64).clamp(max=w - 1)
    y2 = boxes[:, 3].to(torch.int64).clamp(max=h - 1)
    cw = (x2 - x1).clamp(min=1).double()
    ch = (y2 - y1).clamp(min=1).double()
    dev = pixels.device

    def taps(lo, size, n, limit):
        s = (torch.arange(n, device=dev, dtype=torch.float64)[None] + 0.5) * (size[:, None] / n) - 0.5
        s = torch.minimum(s.clamp(min=0), size[:, None] - 1) + lo[:, None]
        i0 = torch.floor(s)
        return i0.long().clamp(0, limit - 1), (i0 + 1).long().clamp(0, limit - 1), s - i0

    ya, yb, fy = taps(y1, ch, oh, h)
    xa, xb, fx = taps(x1, cw, ow, w)
    hwc = pixels.permute(0, 2, 3, 1)
    f = frame_idx.long()[:, None, None]

    def at(yi, xi):  # [D, 3, oh, ow]
        return hwc[f, yi[:, :, None], xi[:, None, :]].permute(0, 3, 1, 2).double()

    fy, fx = fy[:, None, :, None], fx[:, None, None, :]
    top = at(ya, xa) * (1 - fx) + at(ya, xb) * fx
    bot = at(yb, xa) * (1 - fx) + at(yb, xb) * fx
    c = (top * (1 - fy) + bot * fy) / 255.0
    m = torch.tensor(mean, dtype=torch.float64, device=dev)[None, :, None, None]
    s = torch.tensor(std, dtype=torch.float64, device=dev)[None, :, None, None]
    return ((c - m) / s).float()
