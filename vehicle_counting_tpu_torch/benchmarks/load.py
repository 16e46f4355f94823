"""The synthetic load that `bench.py`, `stage_bench.py` and the smoke test
share: a confidence threshold and class map that give a random-init
detector a realistic number of tracked detections per frame, and the
seeded synthetic detections of the stage bench (the reference stage
bench's recipe and seeds)."""

from __future__ import annotations

import collections
from typing import List, Tuple

import numpy as np
import torch


NUM_DETECTOR_CLASSES = 80  # the random-init detectors of the bench are COCO-shaped


def calibrate_from_det(det, k: int = 30) -> Tuple[float, np.ndarray, List[int]]:
    """From the det dict of one pass at conf 0 with the identity class map:
    a random-init argmax concentrates on a few classes, so track the 4
    dominant classes of frame 0 (this measures compute load, not COCO
    semantics) and put the threshold at the k-th score among them.
    Returns (conf_thres, lut int32 [80] with -1 = dropped, top4).
    """
    scores = det["scores"][0].float().cpu().numpy()
    classes = det["classes"][0].cpu().numpy()
    ok = det["valid"][0].cpu().numpy()
    top4 = [int(c) for c, _ in collections.Counter(classes[ok].tolist()).most_common(4)]
    lut = np.full((NUM_DETECTOR_CLASSES,), -1, np.int32)
    for d, src in enumerate(top4):
        lut[src] = d
    pool = np.sort(scores[ok & np.isin(classes, top4)])
    conf = float(pool[-min(k, pool.size)]) if pool.size else 0.0
    return conf, lut, top4


def synthetic_boxes(seed: int, b: int, n_det: int, src_hw) -> np.ndarray:
    """[b, n_det, 4] f64 xyxy boxes, 40-160 px a side, centres at least
    100 px inside a (H, W) source frame."""
    h, w = src_hw
    r = np.random.default_rng(seed)
    cx = r.uniform(100, w - 100, size=(b, n_det))
    cy = r.uniform(100, h - 100, size=(b, n_det))
    bw = r.uniform(40, 160, size=(b, n_det))
    bh = r.uniform(40, 160, size=(b, n_det))
    return np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)


def synthetic_detections(b: int, n_det: int, k: int, num_classes: int, dominant_frac: float = 0.0):
    """(valid bool, classes i32, scores f32), each [b, n_det]: the first k
    slots of every frame valid, classes drawn uniformly (a `dominant_frac`
    share forced into class 0: real traffic is class-skewed), scores in
    [0.3, 0.9)."""
    valid = np.zeros((b, n_det), bool)
    valid[:, :k] = True
    classes = np.asarray(np.random.default_rng(1).integers(0, num_classes, size=(b, n_det)), np.int32)
    if dominant_frac > 0:
        dom = np.random.default_rng(9).random(size=(b, n_det)) < dominant_frac
        classes = np.where(dom, 0, classes).astype(np.int32)
    scores = np.asarray(np.random.default_rng(2).uniform(0.3, 0.9, size=(b, n_det)), np.float32)
    return valid, classes, scores


def crop_gather_inputs(boxes: torch.Tensor, k: int, gain: float, pad_x: float, pad_y: float):
    """(frame index i32 [b*k], boxes f32 [b*k, 4] in network-input pixels,
    valid bool [b*k]) for one crop-gather call over the first k source-pixel
    boxes of every frame of `boxes` [b, n_det, 4]."""
    b = boxes.shape[0]
    fidx = torch.from_numpy(np.repeat(np.arange(b), k).astype(np.int32)).to(boxes.device)
    bsel = boxes[:, :k].reshape(b * k, 4) * float(gain) + torch.tensor(
        [pad_x, pad_y, pad_x, pad_y], dtype=torch.float32, device=boxes.device)
    return fidx, bsel, torch.ones((b * k,), dtype=torch.bool, device=boxes.device)
