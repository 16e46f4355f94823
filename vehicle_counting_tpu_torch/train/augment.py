"""Train-time augmentation for the ReID trainer, as batched torch ops.

Port of `vehicle_counting_tpu/train/augment.py`. Reference recipe
(deep/train.py:34-53): random crop-context, horizontal flip, ~10-degree
rotation; plus the MEAN/STD normalize contract from
augmentations/transforms.py:6-27 (Denormalize inverse included). Images
are [B, H, W, 3] (the JAX layout) on any device; the draws come from an
explicit `torch.Generator` on the images' device, through `flip_mask` and
`rotation_degrees`, which a test can replace with the values JAX draws
from the same key.
"""

from __future__ import annotations

import math

import torch

from vehicle_counting_tpu_torch.models.reid import IMAGENET_MEAN, IMAGENET_STD


def _const(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8/float 0..255 RGB -> ImageNet-normalized float32."""
    x = images.to(torch.float32) / torch.full((), 255.0, device=images.device)
    return (x - _const(IMAGENET_MEAN, x)) / _const(IMAGENET_STD, x)


def denormalize(images: torch.Tensor) -> torch.Tensor:
    """Inverse of normalize (augmentations/transforms.py:9-27 role)."""
    x = images * _const(IMAGENET_STD, images) + _const(IMAGENET_MEAN, images)
    return torch.clamp(x * 255.0, 0, 255)


def flip_mask(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """[n] bool, True with p = 0.5 (the JAX `bernoulli(key, 0.5, (n,))`)."""
    return torch.rand(n, generator=gen, device=device) < 0.5


def rotation_degrees(gen: torch.Generator, n: int, max_deg: float, device) -> torch.Tensor:
    """[n] f32 uniform in [-max_deg, max_deg) (the JAX `uniform` draw)."""
    return torch.rand(n, generator=gen, device=device) * (2 * max_deg) - max_deg


def random_flip(gen: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    """Per-sample horizontal flip with p=0.5."""
    flip = flip_mask(gen, images.shape[0], images.device)
    return torch.where(flip[:, None, None, None], images.flip(2), images)


def rotate(images: torch.Tensor, degrees: torch.Tensor) -> torch.Tensor:
    """Rotate each sample by its angle about the centre (bilinear, edge
    clamp), written out as the JAX `random_rotate`'s `rot_one`."""
    b, h, w, c = images.shape
    dev = images.device
    theta = (degrees.to(torch.float32) * (math.pi / 180.0))[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = (torch.arange(h, dtype=torch.float32, device=dev) - cy)[:, None].expand(h, w)
    xx = (torch.arange(w, dtype=torch.float32, device=dev) - cx)[None, :].expand(h, w)
    cos, sin = torch.cos(theta), torch.sin(theta)
    sx = cx + cos * xx - sin * yy
    sy = cy + sin * xx + cos * yy
    x0 = torch.clamp(torch.floor(sx).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.floor(sy).to(torch.int64), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    fx = (torch.clamp(sx, 0, w - 1) - x0)[..., None]
    fy = (torch.clamp(sy, 0, h - 1) - y0)[..., None]
    flat = images.reshape(b * h * w, c)
    base = (torch.arange(b, device=dev) * (h * w))[:, None, None]

    def at(yi, xi):
        return flat[base + yi * w + xi]

    top = at(y0, x0) * (1 - fx) + at(y0, x1) * fx
    bot = at(y1, x0) * (1 - fx) + at(y1, x1) * fx
    return top * (1 - fy) + bot * fy


def random_rotate(gen: torch.Generator, images: torch.Tensor, max_deg: float = 10.0) -> torch.Tensor:
    """Per-sample small rotation (bilinear, edge clamp), torch rot10-style."""
    return rotate(images, rotation_degrees(gen, images.shape[0], max_deg, images.device))


def augment_batch(gen: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    """flip + rot10 pipeline on normalized images (deep/train.py contract):
    the flip's draw first, then the rotation's, from one generator."""
    return random_rotate(gen, random_flip(gen, images))
