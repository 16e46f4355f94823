"""The tracker's frame step around the association: kernel K9 before it,
kernel K10 after it.

Port-only: no TPU kernel stands behind them (XLA fuses the same
elementwise work inside the JAX package's frame scan). The frame step
(`tracking/deepsort.py::frame_update`) is

    f_n = l2_normalize(feats)              torch ops
    sims = gallery_sims(gallery, f_n)      the gallery's f32 cast + one GEMM
    pre = track_frame_pre(...)             K9
    det_free, track_col, det_key = ...     K2, or the staged route's K4 stages
    track_frame_post(...)                  K10

where PyTorch's op chain ran some 450 small kernels on the card.
`track_frame_pre_plain` and `track_frame_post_plain` are that chain
(`tracking/tracker.py`'s pieces, op for op), what CPU tensors run, and
with the same signatures as the wrappers, so a caller can put them in
the wrappers' place as the kernels' yardstick; the kernels of
`csrc/track_frame.cu` compute the same in f32 in the chain's operation
order, bitwise but for the 4-term sum of the Mahalanobis distance and the
two contractions of `kalman.update`, which the chain leaves to a reduction
kernel and cuBLAS.

K10 writes the new state into `out_state` (by default new tensors; the
frame runner passes the state itself, so the step runs in place) and the
gallery in place, as `tracker_feature_post` does.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from vehicle_counting_tpu_torch import _build
from vehicle_counting_tpu_torch.ops.assignment import MAX_S
from vehicle_counting_tpu_torch.tracking.tracker import (
    TrackerOutputs,
    TrackerParams,
    TrackerState,
    appearance_from_sims,
    association_inputs,
    gate_cost,
    lifecycle,
    predict_active,
    present_gate,
    tracker_feature_post,
)

# the widest association the tracker runs (the staged route's K4 width;
# K2's routing gate is narrower)
MAX_K = MAX_S


class PreOut(NamedTuple):
    """K9's outputs: the predicted state and the association's operands."""

    mean: torch.Tensor       # [C, K, 8] f32, predicted on active slots
    cov: torch.Tensor        # [C, K, 8, 8] f32
    gated: torch.Tensor      # [C, K, D] f32 gated appearance cost
    iou_cost: torch.Tensor   # [C, K, D] f32
    lvl_of: torch.Tensor     # [C, K] i32 cascade level (IMAX: none)
    tentative: torch.Tensor  # [C, K] bool
    iou_order: torch.Tensor  # [C, K] i32 IoU-stage row order


def track_frame_pre_plain(st: TrackerState, tlwh, det_valid, sims, hp: TrackerParams) -> PreOut:
    """The chain K9 replaces: the predict, the gated appearance cost from
    the GEMM's `sims` ([C, K, B, D]) and the association's other
    operands."""
    mean, cov = predict_active(st)
    gated = gate_cost(mean, cov, appearance_from_sims(sims, st.gallery_count), tlwh, det_valid)
    tentative, lvl_of, iou_cost, iou_order = association_inputs(st, mean, tlwh, hp)
    return PreOut(mean, cov, gated, iou_cost, lvl_of, tentative, iou_order)


def track_frame_post_plain(st: TrackerState, pre: PreOut, tlwh, conf, det_valid, present, f_n,
                           det_free, track_col, det_key, hp: TrackerParams, width: int, height: int,
                           out_state: TrackerState = None, out: TrackerOutputs = None):
    """The chain K10 replaces: the lifecycle, the `present` gate and
    `tracker_feature_post` (the gallery in place). Returns (new state,
    TrackerOutputs), copied into `out_state` / `out` where given (all
    computed before the first copy, so `out_state` may be `st`)."""
    new_st, outputs, flags = lifecycle(st, pre.mean, pre.cov, tlwh, conf, det_valid, det_free, track_col, det_key,
                                       hp, width, height)
    new_st, outputs, flags = present_gate(st, new_st, outputs, flags, present)
    gallery, gallery_count, pending_count = tracker_feature_post(
        st.gallery, st.gallery_count, st.pending_count, flags, f_n, hp)
    new_st = new_st._replace(gallery=gallery, gallery_count=gallery_count, pending_count=pending_count)
    if out_state is not None:
        for name, dst, src in zip(TrackerState._fields, out_state, new_st):
            if name != "gallery":
                dst.copy_(src)
        new_st = out_state._replace(gallery=gallery)
    if out is not None:
        for dst, src in zip(out, outputs):
            dst.copy_(src)
        outputs = out
    return new_st, outputs


_STATE_DTYPES = {"mean": torch.float32, "cov": torch.float32, "last_conf": torch.float32}
_GALLERY_DTYPES = (torch.float32, torch.bfloat16)


def _check_leaf(name, t, shape, dtype):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype} {list(shape)}, got {t.dtype} {list(t.shape)}"
                         + ("" if t.is_contiguous() else f" with strides {t.stride()}"))


def _check_state(st: TrackerState, what="state"):
    """(C, K, B, F) of a state whose leaves the kernels can take, else raise."""
    if st.state.dim() != 2:
        raise ValueError(f"{what}: leaves must carry a class axis [C, K, ...], got state {list(st.state.shape)}")
    c, k = st.state.shape
    if k > MAX_K:
        raise ValueError(f"{what}: K = {k} (state {list(st.state.shape)}) is wider than the association takes "
                         f"(K <= {MAX_K})")
    if st.gallery.dim() != 4 or tuple(st.gallery.shape[:2]) != (c, k) or st.gallery.dtype not in _GALLERY_DTYPES \
            or not st.gallery.is_contiguous():
        raise ValueError(f"{what}: gallery must be contiguous float32 or bfloat16 [{c}, {k}, budget, F], got "
                         f"{st.gallery.dtype} {list(st.gallery.shape)}")
    b, f = st.gallery.shape[2:]
    shapes = {"mean": (c, k, 8), "cov": (c, k, 8, 8), "next_id": (c,), "overflow": (c,)}
    for name in TrackerState._fields:
        if name != "gallery":
            _check_leaf(f"{what}.{name}", getattr(st, name), shapes.get(name, (c, k)),
                        _STATE_DTYPES.get(name, torch.int32))
    return c, k, b, f


def _check_device(device, *tensors):
    if device.type != "cuda":
        raise ValueError(f"the track_frame kernels take CUDA tensors, got {device}")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"every operand must be on {device}, got one on {t.device}")


_PRE_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 8


def _launch_pre(st: TrackerState, tlwh, det_valid, sims, hp: TrackerParams) -> PreOut:
    """Check the operands and launch K9: one block per (slot, class)."""
    c, k, b, f = _check_state(st)
    _check_leaf("tlwh", tlwh, (c, k, 4), torch.float32)
    _check_leaf("det_valid", det_valid, (c, k), torch.bool)
    _check_leaf("sims", sims, (c, k, b, k), torch.float32)
    dev = st.state.device
    _check_device(dev, *st, tlwh, det_valid, sims)
    f32 = dict(dtype=torch.float32, device=dev)
    out = PreOut(torch.empty((c, k, 8), **f32), torch.empty((c, k, 8, 8), **f32), torch.empty((c, k, k), **f32),
                 torch.empty((c, k, k), **f32), torch.empty((c, k), dtype=torch.int32, device=dev),
                 torch.empty((c, k), dtype=torch.bool, device=dev), torch.empty((c, k), dtype=torch.int32, device=dev))
    rc = _build.entry("track_frame", "vct_track_pre", _PRE_ARGTYPES)(
        st.mean.data_ptr(), st.cov.data_ptr(), st.track_id.data_ptr(), st.state.data_ptr(), st.tsu.data_ptr(),
        st.gallery_count.data_ptr(), tlwh.data_ptr(), det_valid.data_ptr(), sims.data_ptr(), c, k, b,
        int(hp.max_age), *(t.data_ptr() for t in out), _build.current_stream(dev))
    _build.check(rc, "track_frame K9")
    return out


_POST_ARGTYPES = ([ctypes.c_void_p] * 22 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 18)


def _launch_post(st: TrackerState, pre: PreOut, tlwh, conf, det_valid, present, f_n, det_free, track_col,
                 det_key, hp: TrackerParams, width: int, height: int, out_state: TrackerState, out: TrackerOutputs):
    """Check the operands and launch K10: one block per class. `out_state`
    and `out` are written; `out_state.gallery` is ignored (the gallery is
    `st.gallery`, written in place)."""
    c, k, b, f = _check_state(st)
    for name, t, shape, dtype in (
            ("pre.mean", pre.mean, (c, k, 8), torch.float32), ("pre.cov", pre.cov, (c, k, 8, 8), torch.float32),
            ("tlwh", tlwh, (c, k, 4), torch.float32), ("conf", conf, (c, k), torch.float32),
            ("det_valid", det_valid, (c, k), torch.bool), ("present", present, (c,), torch.bool),
            ("f_n", f_n, (c, k, f), torch.float32), ("det_free", det_free, (c, k), torch.bool),
            ("track_col", track_col, (c, k), torch.int32), ("det_key", det_key, (c, k), torch.int32),
            ("out.boxes", out.boxes, (c, k, 4), torch.int32), ("out.ids", out.ids, (c, k), torch.int32),
            ("out.scores", out.scores, (c, k), torch.float32), ("out.mask", out.mask, (c, k), torch.bool)):
        _check_leaf(name, t, shape, dtype)
    _check_state(out_state._replace(gallery=st.gallery), "out_state")
    dev = st.state.device
    _check_device(dev, *st, pre.mean, pre.cov, tlwh, conf, det_valid, present, f_n, det_free, track_col, det_key,
                  *out_state, *out)
    small = [getattr(out_state, n) for n in ("mean", "cov", "track_id", "state", "hits", "age", "tsu",
                                             "gallery_count", "pending_count", "last_conf", "next_id", "overflow")]
    rc = _build.entry("track_frame", "vct_track_post", _POST_ARGTYPES)(
        st.mean.data_ptr(), st.cov.data_ptr(), st.track_id.data_ptr(), st.state.data_ptr(), st.hits.data_ptr(),
        st.age.data_ptr(), st.tsu.data_ptr(), st.gallery_count.data_ptr(), st.pending_count.data_ptr(),
        st.last_conf.data_ptr(), st.next_id.data_ptr(), st.overflow.data_ptr(), pre.mean.data_ptr(),
        pre.cov.data_ptr(), tlwh.data_ptr(), conf.data_ptr(), det_valid.data_ptr(), present.data_ptr(),
        f_n.data_ptr(), det_free.data_ptr(), track_col.data_ptr(), det_key.data_ptr(),
        c, k, b, f, int(st.gallery.dtype == torch.bfloat16), int(hp.max_age), int(hp.n_init), int(width),
        int(height), *(t.data_ptr() for t in small), st.gallery.data_ptr(), *(t.data_ptr() for t in out),
        _build.current_stream(dev))
    _build.check(rc, "track_frame K10")


def track_frame_pre(st: TrackerState, tlwh, det_valid, sims, hp: TrackerParams) -> PreOut:
    """K9: the Kalman predict and the association's operands, from the
    state (leaves [C, K, ...]), the frame's detections tlwh [C, K, 4] and
    det_valid [C, K], and the GEMM's sims [C, K, B, K] (`gallery_sims`).
    CPU tensors take the plain version; CUDA tensors launch the kernel of
    `csrc/track_frame.cu` or raise."""
    dev = st.state.device
    if dev.type == "cpu":
        return track_frame_pre_plain(st, tlwh, det_valid, sims, hp)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    res = _launch_pre(st, tlwh, det_valid, sims, hp)
    track_frame_pre.launches += 1
    return res


def _new_state(st: TrackerState) -> TrackerState:
    return TrackerState(*(t if name == "gallery" else torch.empty_like(t)
                          for name, t in zip(TrackerState._fields, st)))


def _new_outputs(st: TrackerState) -> TrackerOutputs:
    c, k = st.state.shape
    dev = st.state.device
    return TrackerOutputs(torch.empty((c, k, 4), dtype=torch.int32, device=dev),
                          torch.empty((c, k), dtype=torch.int32, device=dev),
                          torch.empty((c, k), dtype=torch.float32, device=dev),
                          torch.empty((c, k), dtype=torch.bool, device=dev))


def track_frame_post(st: TrackerState, pre: PreOut, tlwh, conf, det_valid, present, f_n, det_free, track_col,
                     det_key, hp: TrackerParams, width: int, height: int, out_state: TrackerState = None,
                     out: TrackerOutputs = None):
    """K10: everything after the association, from the state, K9's `pre`,
    the frame (tlwh, conf, det_valid [C, K], present [C], L2-normalised
    features f_n [C, K, F]) and the association's det_free / track_col /
    det_key [C, K]. Writes the new state into `out_state` (None: new
    tensors; it may be `st` itself) and the outputs into `out` (None: new
    tensors); the gallery is `st.gallery`, updated in place. Returns (new
    state, TrackerOutputs). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    dev = st.state.device
    if dev.type == "cpu":
        return track_frame_post_plain(st, pre, tlwh, conf, det_valid, present, f_n, det_free, track_col, det_key,
                                      hp, width, height, out_state, out)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out_state = _new_state(st) if out_state is None else out_state._replace(gallery=st.gallery)
    out = _new_outputs(st) if out is None else out
    _launch_post(st, pre, tlwh, conf, det_valid, present, f_n, det_free, track_col, det_key, hp, width, height,
                 out_state, out)
    track_frame_post.launches += 1
    return out_state, out


track_frame_pre.launches = 0
track_frame_post.launches = 0
