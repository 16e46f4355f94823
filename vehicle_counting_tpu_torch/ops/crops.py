"""ReID crop gather + cv2-bilinear resize + normalisation (kernel K1).

Port of `vehicle_counting_tpu/ops/crops.py::gather_crops_batch` (the plain
version, `gather_crops_batch_plain`) and of the TPU kernel
`ops/pallas/crops.py::gather_crops_batch_pallas` (the CUDA kernel
`csrc/crops.cu`, reached through `gather_crops_batch`). K1 reads planar
[B, 3, H, W] frames; an interleaved [B, H, W, 3] source (the raw-RGB and
letterboxed-RGB uploads, `gather_crops`'s one frame) goes through K1 on a
planar copy (`planar_copy`: one u8 transpose per batch, as the JAX
package transposes before its Pallas gather).

Semantics (reference deep_sort.py:88-129, feature_extractor.py:26-39):
integer crop bounds x1 = max(int(x), 0), x2 = min(int(x2), W - 1); cv2
bilinear src = (dst + 0.5) * (crop / 50) - 0.5 clamped inside the crop;
/255 then (v - mean) / std with ImageNet stats; invalid rows are zero.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from vehicle_counting_tpu_torch import _build
from vehicle_counting_tpu_torch.ops import true_div

CROP_SIZE = 50
_MEAN = np.asarray((0.485, 0.456, 0.406), np.float32)
_STD = np.asarray((0.229, 0.224, 0.225), np.float32)


def crop_boxes_to_bounds(boxes_xyxy: torch.Tensor, height: int, width: int):
    """Float xyxy -> integer crop bounds (x1, y1, x2, y2), reference rules."""
    b = boxes_xyxy
    x1 = torch.clamp(b[..., 0].to(torch.int32), min=0)
    y1 = torch.clamp(b[..., 1].to(torch.int32), min=0)
    x2 = torch.clamp(b[..., 2].to(torch.int32), max=width - 1)
    y2 = torch.clamp(b[..., 3].to(torch.int32), max=height - 1)
    return x1, y1, x2, y2


def _bilinear_coords(boxes_xyxy: torch.Tensor, h: int, w: int, out_size: Tuple[int, int]):
    """Per-crop cv2-bilinear sample coordinates (y0c, y1c, fy, x0c, x1c, fx),
    each [D, o*]; indices int32, weights f32."""
    oh, ow = out_size
    x1, y1, x2, y2 = crop_boxes_to_bounds(boxes_xyxy, h, w)
    cw = torch.clamp(x2 - x1, min=1).to(torch.float32)  # crop spans [x1, x2)
    ch = torch.clamp(y2 - y1, min=1).to(torch.float32)
    dev = boxes_xyxy.device
    di = torch.arange(oh, dtype=torch.float32, device=dev)
    dj = torch.arange(ow, dtype=torch.float32, device=dev)
    sy = y1[:, None].to(torch.float32) + torch.clamp(
        (di[None, :] + 0.5) * true_div(ch[:, None], oh) - 0.5,
        torch.zeros((), device=dev), ch[:, None] - 1.0,
    )
    sx = x1[:, None].to(torch.float32) + torch.clamp(
        (dj[None, :] + 0.5) * true_div(cw[:, None], ow) - 0.5,
        torch.zeros((), device=dev), cw[:, None] - 1.0,
    )
    y0 = torch.floor(sy).to(torch.int32)
    x0 = torch.floor(sx).to(torch.int32)
    fy = sy - y0
    fx = sx - x0
    y0c = torch.clamp(y0, 0, h - 1)
    y1c = torch.clamp(y0 + 1, 0, h - 1)
    x0c = torch.clamp(x0, 0, w - 1)
    x1c = torch.clamp(x0 + 1, 0, w - 1)
    return y0c, y1c, fy, x0c, x1c, fx


def gather_crops_batch_plain(frames_planar: torch.Tensor, frame_idx: torch.Tensor,
                             boxes_xyxy: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: normalised [D, 50, 50, 3] f32 crops.

    frames_planar [B, 3, H, W] uint8 RGB; frame_idx [D] source frame per
    crop; boxes_xyxy [D, 4] f32 crop-source pixels; valid [D] bool.
    The column mix is p0 * (1 - fx) + p1 * fx with separately rounded
    products (p0 * ((1 - fx) + fx) where the clamp taps coincide), the
    same arithmetic as the CUDA kernel.
    """
    b, _, h, w = frames_planar.shape
    d = frame_idx.shape[0]
    y0c, y1c, fy, x0c, x1c, fx = _bilinear_coords(boxes_xyxy, h, w, (CROP_SIZE, CROP_SIZE))
    f = torch.clamp(frame_idx.long(), 0, b - 1)[:, None]
    wx1 = fx[:, None, None, :]            # [D, 1, 1, ow]
    wx0 = 1.0 - wx1
    same = (x0c == x1c)[:, None, None, :]
    i0 = x0c.long()[:, None, None, :].expand(d, CROP_SIZE, 3, CROP_SIZE)
    i1 = x1c.long()[:, None, None, :].expand(d, CROP_SIZE, 3, CROP_SIZE)

    def col_mix(y_idx):
        rows = frames_planar[f, :, y_idx.long()]  # [D, oh, 3, W] u8
        p0 = torch.gather(rows, 3, i0).to(torch.float32)
        p1 = torch.gather(rows, 3, i1).to(torch.float32)
        return torch.where(same, p0 * (wx0 + wx1), p0 * wx0 + p1 * wx1)  # [D, oh, 3, ow]

    m0 = col_mix(y0c)
    m1 = col_mix(y1c)
    wy1 = fy[:, :, None, None]
    crops = (m0 * (1.0 - wy1) + m1 * wy1).permute(0, 1, 3, 2)  # [D, oh, ow, 3]
    mean = torch.from_numpy(_MEAN).to(crops.device)
    std = torch.from_numpy(_STD).to(crops.device)
    crops = (true_div(crops, 255.0) - mean) / std
    return torch.where(valid[:, None, None, None], crops, torch.zeros((), device=crops.device))


def _check_cuda_args(frames_planar, frame_idx, boxes_xyxy, valid):
    dev = frames_planar.device
    if frames_planar.dtype != torch.uint8 or frames_planar.dim() != 4 or frames_planar.shape[1] != 3:
        raise ValueError(f"frames_planar must be [B, 3, H, W] uint8, got {tuple(frames_planar.shape)} {frames_planar.dtype}")
    if not frames_planar.is_contiguous():
        raise ValueError("frames_planar must be contiguous")
    if 3 * frames_planar.shape[2] * frames_planar.shape[3] >= 2 ** 31:
        raise ValueError(f"frames of {tuple(frames_planar.shape[2:])} exceed the kernel's 32-bit pixel offsets")
    d = frame_idx.shape[0]
    if frame_idx.dim() != 1 or boxes_xyxy.shape != (d, 4) or valid.shape != (d,):
        raise ValueError(
            f"shape mismatch: frame_idx {tuple(frame_idx.shape)}, boxes {tuple(boxes_xyxy.shape)}, valid {tuple(valid.shape)}"
        )
    if boxes_xyxy.dtype != torch.float32 or valid.dtype != torch.bool or frame_idx.dtype not in (torch.int32, torch.int64):
        raise ValueError("boxes must be float32, valid bool, frame_idx int32/int64")
    for t in (frame_idx, boxes_xyxy, valid):
        if t.device != dev:
            raise ValueError(f"all tensors must be on {dev}, got {t.device}")


_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_float] * 6 + [ctypes.c_void_p] * 3
)
_NORM = tuple(float(v) for v in (*_MEAN, *_STD))


def _launch(frames_planar, frame_idx, boxes_xyxy, valid, staged_count=None):
    """Check the operands and launch the CUDA kernel: one `torch.empty` and
    one launch, no other device op (for contiguous operands). The kernel
    computes `crop_boxes_to_bounds` and `_bilinear_coords` itself, reads
    `frame_idx` as int32 or int64 and `valid` as bytes. `staged_count`, a
    zeroed int32 tensor on the device, receives the number of crops whose
    source band was staged in shared memory (the others read their taps
    from global memory); for checks."""
    _check_cuda_args(frames_planar, frame_idx, boxes_xyxy, valid)
    b, _, h, w = frames_planar.shape
    d = frame_idx.shape[0]
    frame_idx, boxes_xyxy, valid = frame_idx.contiguous(), boxes_xyxy.contiguous(), valid.contiguous()
    out = torch.empty((d, CROP_SIZE, CROP_SIZE, 3), dtype=torch.float32, device=frames_planar.device)
    fn = _build.entry("crops", "vct_crop_gather", _ARGTYPES)
    rc = fn(
        frames_planar.data_ptr(), b, h, w, frame_idx.data_ptr(), int(frame_idx.dtype == torch.int64),
        boxes_xyxy.data_ptr(), valid.data_ptr(), d, *_NORM, out.data_ptr(),
        None if staged_count is None else staged_count.data_ptr(),
        _build.current_stream(frames_planar.device),
    )
    _build.check(rc, "crop gather kernel")
    return out


def gather_crops_batch(frames_planar: torch.Tensor, frame_idx: torch.Tensor,
                       boxes_xyxy: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """K1: normalised [D, 50, 50, 3] f32 crops, each from its own frame.

    CPU tensors take the plain version; CUDA tensors launch the kernel of
    `csrc/crops.cu` (array-equal to the plain version) or raise. Boxes must
    be finite and within +-2^31 (the pipeline clamps them to the frame
    upstream): the kernel converts float to int as CUDA does, saturating,
    and nothing on the device checks for it.
    """
    if frames_planar.device.type == "cpu":
        return gather_crops_batch_plain(frames_planar, frame_idx, boxes_xyxy, valid)
    if frames_planar.device.type != "cuda":
        raise ValueError(f"unsupported device {frames_planar.device}")
    out = _launch(frames_planar, frame_idx, boxes_xyxy, valid)
    gather_crops_batch.launches += 1
    return out


gather_crops_batch.launches = 0


def planar_copy(frames: torch.Tensor) -> torch.Tensor:
    """Interleaved [B, H, W, 3] frames -> a contiguous planar [B, 3, H, W]
    copy, the layout K1 reads."""
    return frames.permute(0, 3, 1, 2).contiguous()


def gather_crops(frame: torch.Tensor, boxes_xyxy: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Normalised [D, 50, 50, 3] f32 crops of one interleaved [H, W, 3]
    frame (the JAX package's `gather_crops`): K1 on the frame's planar copy
    for CUDA tensors, its plain version for CPU tensors."""
    fidx = torch.zeros(boxes_xyxy.shape[0], dtype=torch.int32, device=frame.device)
    return gather_crops_batch(planar_copy(frame[None]), fidx, boxes_xyxy, valid)
