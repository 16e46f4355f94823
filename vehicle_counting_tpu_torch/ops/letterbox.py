"""Letterbox geometry, host letterbox / I420 packing and the device pixel path.

Port of `vehicle_counting_tpu/ops/letterbox.py`. Three upload encodings:
- thin I420 (the default): the host letterboxes to AutoShape's
  stride-aligned shape and packs the content rows as I420
  (`host_letterbox_yuv420`); the device re-inserts the gray padding rows
  (`yuv420_content_to_full`) and converts to planar uint8 RGB
  (`yuv420_to_rgb_u8_planar`, or interleaved `yuv420_to_rgb_u8`);
- letterboxed RGB: `host_letterbox` on the host, /255 on the device;
- raw RGB: full frames, letterboxed on the device (`letterbox`, the
  anti-aliased bilinear resize of `jax.image.resize`).
`restore_boxes` maps detector boxes back to source pixels. The integer
pixel functions are array-equal to the JAX ones; `letterbox` and
`yuv420_to_rgb` agree to f32 rounding.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Tuple

import numpy as np
import torch

from vehicle_counting_tpu_torch.ops import true_div

PAD_VALUE = 114.0  # ultralytics letterbox fill gray


def autoshape_hw(src_hw: Tuple[int, int], size, stride: int = 32) -> Tuple[int, int]:
    """Network input (h, w) AutoShape infers at: scale by size / max(src),
    round each side UP to a stride multiple (720x1280 @ 640 -> 384x640)."""
    sh, sw = src_hw
    if not isinstance(size, (int, float)):
        size = max(size)
    g = float(size) / float(max(sh, sw))
    return (
        int(math.ceil(sh * g / stride) * stride),
        int(math.ceil(sw * g / stride) * stride),
    )


def letterbox_params(src_hw: Tuple[int, int], dst_hw: Tuple[int, int]):
    """(gain, pad_x, pad_y, new_w, new_h): min(dst/src) gain, symmetric pad."""
    sh, sw = src_hw
    dh, dw = dst_hw
    gain = min(dh / sh, dw / sw)
    new_w, new_h = round(sw * gain), round(sh * gain)
    pad_x = (dw - new_w) / 2
    pad_y = (dh - new_h) / 2
    return gain, pad_x, pad_y, new_w, new_h


def content_rows(src_hw: Tuple[int, int], dst_hw: Tuple[int, int]) -> Tuple[int, int]:
    """(top, ch): content row offset and even-aligned content height."""
    dh, dw = dst_hw
    _, _, pad_y, _, new_h = letterbox_params(src_hw, dst_hw)
    top = int(round(pad_y - 0.1))
    ch = new_h + (new_h & 1)
    return top, min(ch, dh - top)


def content_upload_exact(src_hw: Tuple[int, int], dst_hw: Tuple[int, int]) -> bool:
    """True when the content-only upload is bit-identical to full-frame."""
    top, ch = content_rows(src_hw, dst_hw)
    new_h = letterbox_params(src_hw, dst_hw)[4]
    return top % 2 == 0 and ch == new_h


def _gray_yuv():
    """I420 bytes cv2 produces for the uniform 114-gray padding."""
    import cv2

    g = cv2.cvtColor(np.full((2, 2, 3), int(PAD_VALUE), np.uint8), cv2.COLOR_RGB2YUV_I420)
    return int(g[0, 0]), int(g[2, 0]), int(g[2, 1])  # y, u, v


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] f32 weights of `jax.image.resize`'s "bilinear"
    along one axis (its `compute_weight_mat`, antialias on): a triangle
    kernel on half-pixel centres, widened by 1 / scale when downsampling;
    each output column normalised to sum 1 over the taps inside the image;
    columns whose sample falls outside the image zeroed. The same f32
    operations in the same order, in numpy."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.0) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= f32(-0.5)) & (sample_f <= f32(in_size - 0.5))
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=16)
def _resize_weights_on(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_resize_weights(in_size, out_size)).to(device)


def _resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """[B, H, W, C] -> [B, oh, ow, C] f32: `jax.image.resize(x, ...,
    "bilinear")` (anti-aliased when downsampling), as two contractions with
    the separable weight matrices, rows first. f32 matmuls: TF32 must be
    off for f32 parity (the pipeline turns it off in f32 mode)."""
    b, h, w, c = x.shape
    oh, ow = out_hw
    xf = x.to(torch.float32)
    if oh != h:
        wy = _resize_weights_on(h, oh, xf.device)  # [h, oh]
        xf = torch.matmul(wy.t(), xf.reshape(b, h, w * c)).reshape(b, oh, w, c)
    if ow != w:
        wx = _resize_weights_on(w, ow, xf.device)  # [w, ow]
        xf = torch.matmul(xf.transpose(2, 3), wx).transpose(2, 3)
    return xf


def letterbox(images: torch.Tensor, dst_hw: Tuple[int, int]) -> torch.Tensor:
    """Device letterbox of [B, H, W, 3] uint8/float RGB (0..255) frames to
    [B, dh, dw, 3] f32 in [0, 1]: the anti-aliased bilinear resize to the
    content size, pasted into the 114-gray canvas at round(pad - 0.1), /255."""
    b, sh, sw, c = images.shape
    dh, dw = dst_hw
    _, pad_x, pad_y, new_w, new_h = letterbox_params((sh, sw), (dh, dw))
    x = _resize_bilinear(images, (new_h, new_w))
    top, left = int(round(pad_y - 0.1)), int(round(pad_x - 0.1))
    out = torch.full((b, dh, dw, c), PAD_VALUE, dtype=torch.float32, device=images.device)
    out[:, top : top + new_h, left : left + new_w] = x
    return true_div(out, 255.0)


def host_letterbox(frames: np.ndarray, dst_hw: Tuple[int, int]) -> np.ndarray:
    """cv2 letterbox on host, uint8 in and out: the letterboxed-RGB upload
    (the device only divides by 255; ReID crops come from the letterboxed
    frame through the (gain, pad) transform)."""
    import cv2

    b, sh, sw, c = frames.shape
    dh, dw = dst_hw
    _, pad_x, pad_y, new_w, new_h = letterbox_params((sh, sw), (dh, dw))
    top, left = int(round(pad_y - 0.1)), int(round(pad_x - 0.1))
    out = np.full((b, dh, dw, c), int(PAD_VALUE), dtype=np.uint8)
    for i in range(b):
        r = cv2.resize(frames[i], (new_w, new_h), interpolation=cv2.INTER_LINEAR)
        out[i, top : top + new_h, left : left + new_w] = r
    return out


def _map_frames(fn, b: int) -> None:
    """Run fn(i) for every frame, threaded when the host has cores (cv2
    releases the GIL)."""
    n = min(8, os.cpu_count() or 1)
    if n <= 1 or b <= 1:
        for i in range(b):
            fn(i)
        return
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(n) as pool:
        list(pool.map(fn, range(b)))


def host_letterbox_yuv420(frames: np.ndarray, dst_hw: Tuple[int, int],
                          content_only: bool = False) -> np.ndarray:
    """Letterbox + RGB->I420 on host: [B, dh*3/2, dw] uint8.

    content_only=True ships only the content rows ([B, ch*3/2, dw]); the
    device re-inserts the gray padding with `yuv420_content_to_full`.
    """
    import cv2

    b, sh, sw, c = frames.shape
    dh, dw = dst_hw
    if content_only:
        _, pad_x, _, new_w, new_h = letterbox_params((sh, sw), (dh, dw))
        _, ch = content_rows((sh, sw), (dh, dw))
        left = int(round(pad_x - 0.1))
        out = np.empty((b, ch * 3 // 2, dw), np.uint8)

        def one(i):
            strip = np.full((ch, dw, c), int(PAD_VALUE), np.uint8)
            r = cv2.resize(frames[i], (new_w, new_h), interpolation=cv2.INTER_LINEAR)
            strip[:new_h, left : left + new_w] = r
            out[i] = cv2.cvtColor(strip, cv2.COLOR_RGB2YUV_I420)

        _map_frames(one, b)
        return out

    lb = host_letterbox(frames, dst_hw)
    out = np.empty((b, dh * 3 // 2, dw), np.uint8)

    def one_full(i):
        out[i] = cv2.cvtColor(lb[i], cv2.COLOR_RGB2YUV_I420)

    _map_frames(one_full, b)
    return out


def yuv420_content_to_full(yuv_c: torch.Tensor, src_hw: Tuple[int, int],
                           dst_hw: Tuple[int, int]) -> torch.Tensor:
    """[B, ch*3/2, dw] content-only I420 -> [B, dh*3/2, dw] full I420."""
    b, ch15, w = yuv_c.shape
    ch = ch15 * 2 // 3
    dh, dw = dst_hw
    top, ch_expect = content_rows(src_hw, dst_hw)
    if ch != ch_expect or w != dw:
        raise ValueError(f"content upload {tuple(yuv_c.shape)} does not fit {src_hw} -> {dst_hw}")
    yg, ug, vg = _gray_yuv()
    out = torch.empty((b, dh * 3 // 2, w), dtype=torch.uint8, device=yuv_c.device)
    yf = out[:, :dh]
    uf = out[:, dh : dh + dh // 4].reshape(b, dh // 2, w // 2)
    vf = out[:, dh + dh // 4 :].reshape(b, dh // 2, w // 2)
    yf.fill_(yg)
    uf.fill_(ug)
    vf.fill_(vg)
    yf[:, top : top + ch] = yuv_c[:, :ch]
    uf[:, top // 2 : top // 2 + ch // 2] = yuv_c[:, ch : ch + ch // 4].reshape(b, ch // 2, w // 2)
    vf[:, top // 2 : top // 2 + ch // 2] = yuv_c[:, ch + ch // 4 :].reshape(b, ch // 2, w // 2)
    return out


def _yuv420_planes(yuv: torch.Tensor):
    """(y, u, v) f32 [B, H, W] of an I420 [B, H*3/2, W] uint8 batch: Y
    studio-scaled, chroma upsampled 2x (nearest) on the u8 planes, -128."""
    b, h15, w = yuv.shape
    h = h15 * 2 // 3
    y = (yuv[:, :h].to(torch.float32) - 16.0) * 1.163999557
    u8_ = yuv[:, h : h + h // 4].reshape(b, h // 2, w // 2)
    v8_ = yuv[:, h + h // 4 :].reshape(b, h // 2, w // 2)
    u = u8_.repeat_interleave(2, 1).repeat_interleave(2, 2).to(torch.float32) - 128.0
    v = v8_.repeat_interleave(2, 1).repeat_interleave(2, 2).to(torch.float32) - 128.0
    return y, u, v


def yuv420_to_rgb(yuv: torch.Tensor) -> torch.Tensor:
    """I420 [B, H*3/2, W] uint8 -> RGB [B, H, W, 3] f32 in 0..255 (BT.601
    studio swing, as cv2's COLOR_YUV2RGB_I420)."""
    y, u, v = _yuv420_planes(yuv)
    r = y + 1.596026612 * v
    g = y - 0.391762290 * u - 0.812967647 * v
    bl = y + 2.017232143 * u
    return torch.clamp(torch.stack([r, g, bl], dim=-1), 0.0, 255.0)


def yuv420_to_rgb_u8(yuv: torch.Tensor) -> torch.Tensor:
    """`yuv420_to_rgb(yuv)` cast to uint8, interleaved [B, H, W, 3]: the
    same bytes as `yuv420_to_rgb_u8_planar`, channels last."""
    return yuv420_to_rgb_u8_planar(yuv).permute(0, 2, 3, 1).contiguous()


def yuv420_to_rgb_u8_planar(yuv: torch.Tensor) -> torch.Tensor:
    """I420 [B, H*3/2, W] uint8 -> planar RGB [B, 3, H, W] uint8.

    BT.601 studio swing, the same f32 expressions and order as the JAX
    version (nearest 2x chroma upsample, clip, truncating u8 cast).
    """
    y, u, v = _yuv420_planes(yuv)
    r = torch.clamp(y + 1.596026612 * v, 0.0, 255.0).to(torch.uint8)
    g = torch.clamp(y - 0.391762290 * u - 0.812967647 * v, 0.0, 255.0).to(torch.uint8)
    bl = torch.clamp(y + 2.017232143 * u, 0.0, 255.0).to(torch.uint8)
    return torch.stack([r, g, bl], dim=1)


def restore_boxes(boxes: torch.Tensor, src_hw: Tuple[int, int],
                  dst_hw: Tuple[int, int]) -> torch.Tensor:
    """xyxy boxes [..., 4] from letterboxed to source pixels, clipped."""
    gain, pad_x, pad_y, _, _ = letterbox_params(src_hw, dst_hw)
    sh, sw = src_hw
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack(
        [
            torch.clamp(true_div(x1 - pad_x, gain), 0, sw),
            torch.clamp(true_div(y1 - pad_y, gain), 0, sh),
            torch.clamp(true_div(x2 - pad_x, gain), 0, sw),
            torch.clamp(true_div(y2 - pad_y, gain), 0, sh),
        ],
        dim=-1,
    )
