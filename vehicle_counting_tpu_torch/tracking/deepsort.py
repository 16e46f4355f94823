"""Multi-class DeepSORT: detections + frames -> per-class track updates.

Port of `vehicle_counting_tpu/tracking/deepsort.py` (class_mode
"batched" only): one tracker state per class (reference
modules/track.py:16), each fed only its class's detections, slotted into
fixed [C, K] arrays in detection order; the confidence filter and SORT's
greedy NMS run vectorised; ReID crops of ALL frames' valid detections are
gathered (kernel K1) and embedded in shared chunks.

The per-frame work splits into `frame_inputs` (frame-independent, batched
over any leading frame axis) and `frame_update` (the recurrent tracker
step); `deepsort_frame_core` is the two for one frame.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from vehicle_counting_tpu_torch.models.reid import EMBED_DIM, reid_forward
from vehicle_counting_tpu_torch.ops.boxes import xyxy_to_tlwh
from vehicle_counting_tpu_torch.ops.crops import gather_crops_batch
from vehicle_counting_tpu_torch.ops.nms import sort_nms_mask
from vehicle_counting_tpu_torch.tracking.tracker import (
    TrackerOutputs,
    TrackerParams,
    TrackerState,
    init_state,
    l2_normalize,
    tracker_feature_post,
    tracker_precompute,
    tracker_step_core,
)


class DeepSortParams(NamedTuple):
    """Static facade config: tracker hyper-params + class count."""

    tracker: TrackerParams
    num_classes: int
    min_confidence: float = 0.25  # MIN_CONFIDENCE
    nms_max_overlap: float = 0.5  # NMS_MAX_OVERLAP
    class_mode: str = "batched"   # only "batched" is ported
    max_embed: int = 128          # ReID crops per CNN forward


def init_states(hp: DeepSortParams, device=None) -> TrackerState:
    """Per-class tracker states with a leading [C] axis."""
    if hp.class_mode != "batched":
        raise NotImplementedError(f"class_mode={hp.class_mode!r} is not yet ported (only 'batched')")
    return init_state(hp.tracker, hp.num_classes, device)


def _slot_by_class(boxes, scores, classes, valid, num_classes: int, k: int):
    """Slot flat detections [..., N] into per-class arrays [..., C, K] in
    detection order; detections past the K-th of a class are dropped.
    Returns (boxes [..., C, K, 4], scores, det index (N = empty), valid)."""
    n = boxes.shape[-2]
    dev = boxes.device
    cls_m = valid[..., None, :] & (
        classes[..., None, :] == torch.arange(num_classes, device=dev)[:, None]
    )  # [..., C, N]
    rank = torch.cumsum(cls_m.to(torch.int64), -1) - 1
    slot = torch.where(cls_m & (rank < k), rank, k)
    cidx = torch.full(cls_m.shape[:-1] + (k + 1,), n, dtype=torch.int64, device=dev)
    src = torch.arange(n, device=dev).expand(cls_m.shape).contiguous()
    cidx = cidx.scatter(-1, slot, src)[..., :k]
    cv = cidx < n
    lead = boxes.shape[:-2]
    bpad = torch.cat([boxes.float(), torch.zeros(lead + (1, 4), device=dev)], -2)
    spad = torch.cat([scores.float(), torch.zeros(lead + (1,), device=dev)], -1)
    flat = cidx.reshape(lead + (-1,))
    cb = torch.gather(bpad, -2, flat[..., None].expand(flat.shape + (4,))).reshape(cidx.shape + (4,))
    cs = torch.gather(spad, -1, flat).reshape(cidx.shape)
    return cb, cs, cidx, cv


def _crop_transform(boxes, crop_gain: float, crop_pad: Tuple[float, float]):
    """Source-pixel boxes -> letterboxed crop-frame boxes."""
    if crop_gain != 1.0 or crop_pad != (0.0, 0.0):
        px, py = crop_pad
        return boxes * crop_gain + torch.tensor([px, py, px, py], dtype=torch.float32, device=boxes.device)
    return boxes


def _embed_compacted_chunks(gather_chunk, embed_chunk, valid_flat, chunk: int):
    """Embed every valid detection of a flat axis, `chunk` crops per CNN
    forward: valid detections compact to the front (stable order) and the
    last chunk is padded with invalid entries (zero crops). Returns [n, F]
    with zeros at invalid detections. One host sync reads the count."""
    n = valid_flat.shape[0]
    dev = valid_flat.device
    feats = torch.zeros((n, EMBED_DIM), dtype=torch.float32, device=dev)
    order = torch.nonzero(valid_flat).flatten()
    nv = order.shape[0]
    c = min(chunk, n)
    for start in range(0, nv, c):
        sel = order[start : start + c]
        pad = c - sel.shape[0]
        v = torch.ones(c, dtype=torch.bool, device=dev)
        if pad:
            sel = torch.cat([sel, torch.zeros(pad, dtype=sel.dtype, device=dev)])
            v[c - pad :] = False
        f = embed_chunk(gather_chunk(sel, v))
        feats[sel[: c - pad]] = f[: c - pad]
    return feats


def embed_detections_batch(frames_planar, boxes, valid, reid_params, reid_stats, hp: DeepSortParams,
                           crop_gain: float = 1.0, crop_pad: Tuple[float, float] = (0.0, 0.0),
                           dtype=torch.float32):
    """Batch-global chunked ReID embed: [B, N, F], every valid det embedded.

    frames_planar [B, 3, H, W] uint8 crop source; boxes [B, N, 4] xyxy
    source pixels (mapped into the crop frame by crop_gain/crop_pad);
    valid [B, N]. Crops go through kernel K1 (`gather_crops_batch`).
    """
    b, n = valid.shape
    dev = valid.device
    fb = _crop_transform(boxes.reshape(b * n, 4).float(), crop_gain, crop_pad)
    fidx = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(n)

    def gather_chunk(sel, v):
        return gather_crops_batch(frames_planar, fidx[sel], fb[sel], v)

    def embed_chunk(crops):
        return reid_forward(reid_params, reid_stats, crops, dtype=dtype)

    feats = _embed_compacted_chunks(gather_chunk, embed_chunk, valid.reshape(b * n), hp.max_embed)
    return feats.reshape(b, n, -1)


class FrameInputs(NamedTuple):
    """Per-frame, per-class tracker inputs (leading dims [..., C, K])."""

    tlwh: torch.Tensor      # [..., C, K, 4]
    scores: torch.Tensor    # [..., C, K]
    valid: torch.Tensor     # [..., C, K] after the conf filter and SORT NMS
    feats: torch.Tensor     # [..., C, K, F]
    present: torch.Tensor   # [..., C] class had ANY raw detection
    order: torch.Tensor     # [..., C, K] rank in the reference's detection list


def frame_inputs(feats, boxes, scores, classes, valid, hp: DeepSortParams) -> FrameInputs:
    """The frame-independent part of `deepsort_frame_core`, for [..., N]
    detections (any leading frame axes)."""
    k = hp.tracker.capacity
    cb, cs, cidx, cv = _slot_by_class(boxes, scores, classes, valid, hp.num_classes, k)
    lead = feats.shape[:-2]
    fpad = torch.cat([feats.float(), torch.zeros(lead + (1, feats.shape[-1]), device=feats.device)], -2)
    flat = cidx.reshape(lead + (-1,))
    cf = torch.gather(fpad, -2, flat[..., None].expand(flat.shape + (feats.shape[-1],)))
    cf = cf.reshape(cidx.shape + (feats.shape[-1],))
    # a class advances iff it had ANY raw detection (modules/track.py:55-59)
    present = cv.any(-1)
    cv = cv & (cs > hp.min_confidence)
    ct = xyxy_to_tlwh(cb)
    cv = cv & sort_nms_mask(ct, cs, cv, hp.nms_max_overlap)
    # detection list order: descending score, ties to the higher index
    sc = torch.where(cv, cs, torch.full_like(cs, float("-inf")))
    idx = torch.arange(k, device=cs.device)
    before = (sc[..., None, :] > sc[..., :, None]) | (
        (sc[..., None, :] == sc[..., :, None]) & (idx[None, :] > idx[:, None])
    )
    order = before.sum(-1).to(torch.int32)
    return FrameInputs(ct, cs, cv, cf, present, order)


def frame_update(states: TrackerState, inp: FrameInputs, hp: DeepSortParams,
                 out_hw: Tuple[int, int]) -> Tuple[TrackerState, TrackerOutputs]:
    """The recurrent part: one frame of every class's tracker."""
    h, w = out_hw
    pre = tracker_precompute(states, inp.tlwh, inp.feats, inp.valid, hp.tracker)
    new_st, outputs, flags = tracker_step_core(
        states, pre, inp.tlwh, inp.scores, inp.valid, hp.tracker, w, h, inp.present, inp.order,
    )
    gallery, gallery_count, pending_count = tracker_feature_post(
        states.gallery, states.gallery_count, states.pending_count, flags,
        l2_normalize(inp.feats), hp.tracker,
    )
    return new_st._replace(gallery=gallery, gallery_count=gallery_count,
                           pending_count=pending_count), outputs


def deepsort_frame_core(states: TrackerState, feats, boxes, scores, classes, valid,
                        hp: DeepSortParams, out_hw: Tuple[int, int]):
    """Association + lifecycle for one frame, features precomputed:
    feats [N, F], boxes [N, 4] xyxy source pixels, scores [N], classes [N],
    valid [N]. The gallery is updated in place."""
    if hp.class_mode != "batched":
        raise NotImplementedError(f"class_mode={hp.class_mode!r} is not yet ported (only 'batched')")
    return frame_update(states, frame_inputs(feats, boxes, scores, classes, valid, hp), hp, out_hw)
