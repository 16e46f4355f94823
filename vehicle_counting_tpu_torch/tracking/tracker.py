"""Fixed-capacity vectorised DeepSORT tracker core, batched over classes.

Port of `vehicle_counting_tpu/tracking/tracker.py`. The state is a
structure of arrays whose leaves carry a leading class axis [C, ...]
written out (the JAX code vmaps one class). Semantics are the
reference's (networks/deepsort/sort/tracker.py, track.py, nn_matching.py,
linear_assignment.py, iou_matching.py):

  * K track slots: Kalman mean/cov, lifecycle state (0 empty, 1
    tentative, 2 confirmed), hits/age/time_since_update, increasing ids
    taken in unmatched-detection list order;
  * an appearance gallery ring [K, budget, F] with in-ring pending writes
    revealed on confirmation (`tracker_feature_post`);
  * association: matching cascade + IoU stage, one launch of kernel K2
    for all classes (`_associate` -> ops/cascade.py), or the staged route
    with one launch of kernel K4's fused stage per stage
    (`_associate_staged` -> ops/assignment.py) past the reference's key
    range or slot count for the fused kernel, or where the switch says so;
  * a class with no raw detection this frame does not advance.

`tracker_step` is the single-class step on an unbatched [K] state (the
JAX package's `tracker_step`); it runs the [C]-batched frame step
(`tracking/deepsort.py::frame_update`) with C = 1, so its association
takes the per-class entry of K2's kernel (K3).

The frame step runs as kernels K9 and K10 around the association
(`ops/track_frame.py`). Their plain versions, what CPU tensors run, are
PyTorch's op chain built from this module's pieces (`gallery_sims`,
`predict_active`, `gate_cost`, `association_inputs`, `lifecycle`,
`present_gate`, `tracker_feature_post`).

On the card the per-frame step is sync-free on both routes:
data-dependent choices are masked selects and scatters, never host
branches, and the staged route runs a fixed schedule of stages. That is
what lets `tracking/graph.py` capture the step in a CUDA graph.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from vehicle_counting_tpu_torch.ops.boxes import tlwh_iou_matrix, tlwh_to_xyah
from vehicle_counting_tpu_torch.ops.assignment import MAX_S, match_stage_batched
from vehicle_counting_tpu_torch.ops.cascade import (
    IMAX,
    cascade_match_batched,
    cascade_match_classparallel,
)
from vehicle_counting_tpu_torch.tracking import kalman
from vehicle_counting_tpu_torch.tracking.assignment import BIG

INFTY_COST = 1e5  # linear_assignment.py:9

EMPTY, TENTATIVE, CONFIRMED = 0, 1, 2


@dataclass(frozen=True)
class TrackerParams:
    """Per-camera DeepSORT hyper-parameters (configs/cam_configs.yaml keys)."""

    capacity: int = 64          # track slots K (== detection capacity)
    feat_dim: int = 512
    budget: int = 60            # NN_BUDGET gallery ring size (>= N_INIT)
    pending_cap: int = 8        # JAX's field, kept for its call: it bounds
                                # nothing here (no buffer is allocated for it)
    max_dist: float = 0.2       # MAX_DIST cosine matching threshold
    max_iou_distance: float = 0.6
    max_age: int = 30
    n_init: int = 3
    feat_dtype: str = "float32"  # gallery storage dtype ("bfloat16" on the card)


class TrackerState(NamedTuple):
    mean: torch.Tensor           # [C, K, 8]
    cov: torch.Tensor            # [C, K, 8, 8]
    track_id: torch.Tensor       # [C, K] i32
    state: torch.Tensor          # [C, K] i32
    hits: torch.Tensor           # [C, K] i32
    age: torch.Tensor            # [C, K] i32
    tsu: torch.Tensor            # [C, K] i32 time_since_update
    gallery: torch.Tensor        # [C, K, budget, F] (pending rows included)
    gallery_count: torch.Tensor  # [C, K] i32 revealed count; ring pos = count % budget
    pending_count: torch.Tensor  # [C, K] i32 appended since the last flush
    last_conf: torch.Tensor      # [C, K] f32
    next_id: torch.Tensor        # [C] i32
    overflow: torch.Tensor       # [C] i32 count of dropped initiations


# the leaves `lifecycle` moves on; the gallery and its two counts are
# `tracker_feature_post`'s
SMALL_FIELDS = ("mean", "cov", "track_id", "state", "hits", "age", "tsu", "last_conf", "next_id", "overflow")


class TrackerOutputs(NamedTuple):
    boxes: torch.Tensor   # [C, K, 4] i32 xyxy
    ids: torch.Tensor     # [C, K] i32
    scores: torch.Tensor  # [C, K] f32
    mask: torch.Tensor    # [C, K] bool


class TrackerFlags(NamedTuple):
    """Per-slot association outcome that `tracker_feature_post` applies."""

    matched: torch.Tensor     # [C, K] bool
    gcol: torch.Tensor        # [C, K] matched detection index (0 if unmatched)
    delete: torch.Tensor      # [C, K] bool
    src: torch.Tensor         # [C, K] detection initiating this slot (K = none)
    conf_after: torch.Tensor  # [C, K] bool: CONFIRMED after the lifecycle


_FEAT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def init_state(hp: TrackerParams, num_classes=None, device=None) -> TrackerState:
    """Empty tracker state for `num_classes` classes (leaves [C, ...]), or
    with None one class's state without the class axis (`tracker_step`'s)."""
    lead = () if num_classes is None else (num_classes,)
    k, b, f = hp.capacity, hp.budget, hp.feat_dim
    i32 = dict(dtype=torch.int32, device=device)
    mean = torch.zeros(lead + (k, 8), device=device)
    mean[..., 3] = 1.0  # h = 1 keeps the Cholesky finite on empty slots
    return TrackerState(
        mean=mean,
        cov=torch.eye(8, device=device).expand(lead + (k, 8, 8)).clone(),
        track_id=torch.zeros(lead + (k,), **i32),
        state=torch.zeros(lead + (k,), **i32),
        hits=torch.zeros(lead + (k,), **i32),
        age=torch.zeros(lead + (k,), **i32),
        tsu=torch.zeros(lead + (k,), **i32),
        gallery=torch.zeros(lead + (k, b, f), dtype=_FEAT_DTYPES[hp.feat_dtype], device=device),
        gallery_count=torch.zeros(lead + (k,), **i32),
        pending_count=torch.zeros(lead + (k,), **i32),
        last_conf=torch.zeros(lead + (k,), device=device),
        next_id=torch.ones(lead, **i32),
        overflow=torch.zeros(lead, **i32),
    )


def l2_normalize(feat: torch.Tensor) -> torch.Tensor:
    return feat / torch.clamp(torch.linalg.vector_norm(feat, dim=-1, keepdim=True), min=1e-12)


def gallery_sims(gallery: torch.Tensor, f_n: torch.Tensor) -> torch.Tensor:
    """[C, K, B, D] dot products of every gallery row with every detection's
    L2-normalised feature f_n [C, D, F]: the features rounded to the
    gallery's storage dtype and the products summed in f32 (a bf16 gallery
    gives bf16 x bf16 -> f32, as on the TPU). One GEMM."""
    c, k, b, f = gallery.shape
    f_n = f_n.to(gallery.dtype).float()
    sims = torch.matmul(gallery.float().reshape(c, k * b, f), f_n.transpose(-1, -2))
    return sims.reshape(c, k, b, -1)


def appearance_from_sims(sims: torch.Tensor, gallery_count: torch.Tensor) -> torch.Tensor:
    """[C, K, D] min cosine distance over each slot's revealed ring rows."""
    b = sims.shape[2]
    slot = torch.arange(b, device=sims.device)
    slot_valid = slot < torch.clamp(gallery_count, max=b)[..., None]  # [C, K, B]
    dist = torch.where(slot_valid[..., None], 1.0 - sims, torch.full_like(sims, INFTY_COST))
    return dist.amin(dim=2)


def _associate_staged(gated, iou_cost, lvl_of, tentative, track_id, iou_order,
                      det_valid, det_order, hp: TrackerParams, fixed_schedule=None):
    """Staged association for [C] classes -> (det_free, track_col, det_key).

    Counterpart of the JAX `tracker.py::_associate_xla`: one matching stage
    (JAX `_match_stage`; here `ops/assignment.py::match_stage_batched`: on
    the card one launch of kernel K4's fused stage, in place on det_free,
    track_col and det_key; on the CPU its plain version) per occupied
    cascade level, each class walking its own levels in ascending order (a
    class out of levels sits its stage out), then the IoU stage.

    The number of cascade stages: a class has at most min(max_age, K)
    distinct levels, and a stage whose class has no row or no free
    detection changes nothing. With `fixed_schedule` (None: on the card)
    that many stages always run and nothing is read back from the device,
    so the step can be captured in a CUDA graph; otherwise (on the CPU) the
    largest count of occupied levels is read and only those stages run.
    The two give the same result.
    """
    c, k = lvl_of.shape
    dev = lvl_of.device
    if fixed_schedule is None:
        fixed_schedule = dev.type == "cuda"
    # per class, its distinct occupied levels in ascending order, IMAX after
    srt = torch.sort(lvl_of, dim=-1).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    first &= srt != IMAX
    levels = torch.full((c, k + 1), IMAX, dtype=lvl_of.dtype, device=dev)
    levels.scatter_(1, torch.where(first, torch.cumsum(first.to(torch.int64), -1) - 1, k), srt)
    n_stages = min(hp.max_age, k) if fixed_schedule else int(first.sum(-1).max())

    # every stage's rows and base at once: [S, C, K] and [S, C]
    level = levels[:, :n_stages].t().contiguous()
    occupied = level != IMAX
    rows = (lvl_of[None] == level[:, :, None]) & occupied[:, :, None]
    stage_base = torch.where(occupied, level + 1, 0)

    det_free = det_valid.clone()
    track_col = torch.full((c, k), -1, dtype=torch.int32, device=dev)
    det_key = det_order.clone()
    for i in range(n_stages):
        det_free, track_col, det_key = match_stage_batched(
            gated, rows[i], det_free, track_col, hp.max_dist, track_id, det_key, stage_base[i],
        )
    iou_rows = tentative | ((lvl_of == 0) & (track_col < 0))
    return match_stage_batched(
        iou_cost, iou_rows, det_free, track_col, hp.max_iou_distance,
        iou_order, det_key, torch.full((c,), 1 + hp.max_age, dtype=torch.int32, device=dev),
    )


# The JAX package's switch under its own name, so that a line written for
# `vehicle_counting_tpu.tracking.tracker` works here unchanged. None: auto
# (kernel K2 within the gates below); False: force the staged route (kernel
# K4 per stage); True: K2, within the same gates. Read when the step runs
# eagerly, and when the frame graph is captured on the card
# (`tracking/graph.py`): a flip needs a fresh capture, as in JAX it needs a
# fresh jit trace.
FORCE_PALLAS_CASCADE = None

# The routing gates are the TPU kernel's: its packed argmin word held keys
# below 2^22 (demoted det keys reach (max_age + 2) * K) and it held 256
# slots. The CUDA kernel ranks its keys before packing and has neither
# limit (`ops/cascade.py::MAX_K`), so the gates decide only which of two
# equal routes a configuration takes, the same one as in the JAX package.
KEY_LIMIT = 1 << 22
CASCADE_MAX_K = 256


def _use_cascade_kernel(hp: TrackerParams) -> bool:
    """The JAX `_cascade_kernel_mode` decision: K2 or the staged route."""
    if (hp.max_age + 2) * hp.capacity >= KEY_LIMIT or hp.capacity > CASCADE_MAX_K:
        return False
    return FORCE_PALLAS_CASCADE is not False


def _associate(gated, iou_cost, lvl_of, tentative, track_id, iou_order,
               det_valid, det_order, hp: TrackerParams):
    """Cascade + IoU association for [C] classes -> (det_free, track_col, det_key).

    One launch of the association kernel K2 for all classes (a single
    class goes through the per-class entry, as in the reference), or the
    staged route (`_associate_staged`). CPU tensors take the plain
    versions on both routes.
    """
    c, k = lvl_of.shape
    if not _use_cascade_kernel(hp):
        if k > MAX_S:
            raise ValueError(f"the staged association takes K <= {MAX_S} (kernel K4's width), got {k}")
        return _associate_staged(gated, iou_cost, lvl_of, tentative, track_id, iou_order,
                                 det_valid, det_order, hp)
    fn = cascade_match_classparallel if c > 1 else cascade_match_batched
    out = fn(
        gated, iou_cost, lvl_of, tentative, track_id, iou_order, det_valid, det_order,
        hp.max_dist, hp.max_iou_distance, max_age=hp.max_age,
    )
    return out.det_free, out.track_col, out.det_key


def predict_active(st: TrackerState):
    """The Kalman predict of the active slots -> (mean, cov)."""
    active = st.state > EMPTY
    pm, pc = kalman.predict(st.mean, st.cov)
    mean = torch.where(active[..., None], pm, st.mean)
    cov = torch.where(active[..., None, None], pc, st.cov)
    return mean, cov


def gate_cost(mean, cov, app, tlwh, det_valid):
    """The appearance cost gated by the Mahalanobis distance (INFTY past
    the chi-square bound) and by det_valid (BIG at invalid detections)."""
    maha = kalman.gating_distance(mean, cov, tlwh_to_xyah(tlwh))
    gated = torch.where(maha > kalman.CHI2INV95_4DOF, torch.full_like(app, INFTY_COST), app)
    return torch.where(det_valid[..., None, :], gated, torch.full_like(gated, BIG))


def tracker_precompute(st: TrackerState, tlwh, feat, det_valid, hp: TrackerParams):
    """Association-independent math: predict + gated appearance cost.
    Returns (pred_mean, pred_cov, gated [C, K, D]); kernel K9 computes the
    same on the card."""
    mean, cov = predict_active(st)
    app = appearance_from_sims(gallery_sims(st.gallery, l2_normalize(feat)), st.gallery_count)
    return mean, cov, gate_cost(mean, cov, app, tlwh, det_valid)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [C, D, ...] gathered at idx [C, K] along dim 1 -> [C, K, ...]."""
    shape = idx.shape + x.shape[2:]
    ix = idx.long().reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, ix)


def association_inputs(st: TrackerState, mean, tlwh, hp: TrackerParams):
    """The association's operands besides the gated cost, from the
    predicted mean: (tentative [C, K] bool, cascade level lvl_of [C, K] i32
    (IMAX: not in the cascade), the IoU cost [C, K, D] with the rows of
    tracks missed more than once at INFTY, the IoU stage's row order
    [C, K] i32)."""
    tsu = st.tsu + (st.state > EMPTY).to(torch.int32)
    confirmed = st.state == CONFIRMED
    tentative = st.state == TENTATIVE
    # level L matches tracks with tsu == 1 + L (cascade depth = max_age)
    lvl_of = torch.where(confirmed & (tsu <= hp.max_age), tsu - 1, torch.full_like(tsu, IMAX))
    iou_cost = 1.0 - tlwh_iou_matrix(kalman.to_tlwh(mean), tlwh)
    iou_cost = torch.where(tsu[..., None] > 1, torch.full_like(iou_cost, INFTY_COST), iou_cost)
    # IoU-stage row order: unconfirmed tracks first, each group in id order
    iou_order = st.track_id + torch.where(confirmed, 1 << 20, 0).to(torch.int32)
    return tentative, lvl_of, iou_cost, iou_order


def lifecycle(st: TrackerState, mean, cov, tlwh, conf, det_valid, det_free, track_col, det_key,
              hp: TrackerParams, width: int, height: int):
    """Everything after the association, from its (det_free, track_col,
    det_key) for [C] classes on the small state: Kalman update of matched
    slots, confirmation, deletion, initiation, outputs. Returns (new_state,
    outputs, flags); gallery leaves pass through."""
    k = hp.capacity
    c = st.state.shape[0]
    dev = st.state.device
    i32 = torch.int32
    active = st.state > EMPTY
    age = st.age + active.to(i32)
    tsu = st.tsu + active.to(i32)
    det_xyah = tlwh_to_xyah(tlwh)

    # ---- matched: KF update + lifecycle ----------------------------------
    matched = track_col >= 0
    gcol = torch.where(matched, track_col, 0)
    um, uc = kalman.update(mean, cov, _take(det_xyah, gcol))
    mean = torch.where(matched[..., None], um, mean)
    cov = torch.where(matched[..., None, None], uc, cov)
    hits = st.hits + matched.to(i32)
    tsu = torch.where(matched, 0, tsu)
    last_conf = torch.where(matched, _take(conf, gcol), st.last_conf)
    state = torch.where((st.state == TENTATIVE) & (hits >= hp.n_init), CONFIRMED, st.state)

    # ---- missed: delete tentative, expire confirmed ------------------------
    missed = active & ~matched
    delete = (missed & (st.state == TENTATIVE)) | (missed & (tsu > hp.max_age))
    state = torch.where(delete, EMPTY, state)

    # ---- initiate new tracks from unmatched detections, in list order -----
    unmatched_det = det_valid & det_free
    order_key = torch.where(unmatched_det, det_key, torch.full_like(det_key, IMAX))
    det_rank = torch.sum(order_key[..., :, None] > order_key[..., None, :], dim=-1)  # [C, K]
    free = state == EMPTY
    free_pos = torch.cumsum(free.to(torch.int64), -1) - 1
    num_free = free.sum(-1, keepdim=True)
    d_idx = torch.arange(k, device=dev).expand(c, k)
    slot_of_rank = torch.full((c, k + 1), k, dtype=torch.int64, device=dev)
    slot_of_rank.scatter_(1, torch.where(free, free_pos, k), d_idx.contiguous())
    place = unmatched_det & (det_rank < num_free)
    slot_at = torch.gather(slot_of_rank, 1, torch.clamp(det_rank, 0, k - 1))
    target = torch.where(place, slot_at, k)  # det -> slot (k: none)
    src = torch.full((c, k + 1), k, dtype=torch.int64, device=dev)
    src.scatter_(1, target, d_idx.contiguous())
    src = src[:, :k]  # slot -> initiating det (k: none)
    hit = src < k
    src_c = torch.clamp(src, max=k - 1)

    nm, ncv = kalman.initiate(det_xyah)
    mean = torch.where(hit[..., None], _take(nm, src_c), mean)
    cov = torch.where(hit[..., None, None], _take(ncv, src_c), cov)
    new_ids = (st.next_id[:, None] + det_rank).to(i32)
    track_id = torch.where(hit, torch.gather(new_ids, 1, src_c), st.track_id)
    state = torch.where(hit, TENTATIVE, state)
    hits = torch.where(hit, 1, hits)
    age = torch.where(hit, 1, age)
    tsu = torch.where(hit, 0, tsu)
    last_conf = torch.where(hit, _take(conf, src_c), last_conf)

    next_id = st.next_id + place.sum(-1).to(i32)
    overflow = st.overflow + (unmatched_det & ~place).sum(-1).to(i32)
    new_state = st._replace(
        mean=mean, cov=cov, track_id=track_id, state=state.to(i32), hits=hits.to(i32),
        age=age.to(i32), tsu=tsu.to(i32), last_conf=last_conf, next_id=next_id, overflow=overflow,
    )
    flags = TrackerFlags(matched=matched, gcol=gcol.to(torch.int64), delete=delete,
                         src=src, conf_after=state == CONFIRMED)

    # ---- outputs: confirmed tracks updated this frame, int xyxy clamped ----
    out_mask = (state == CONFIRMED) & (tsu <= 1)
    t = kalman.to_tlwh(mean)
    x1 = torch.clamp(t[..., 0].to(i32), min=0)
    y1 = torch.clamp(t[..., 1].to(i32), min=0)
    x2 = torch.clamp((t[..., 0] + t[..., 2]).to(i32), max=width - 1)
    y2 = torch.clamp((t[..., 1] + t[..., 3]).to(i32), max=height - 1)
    m = out_mask.to(i32)
    outputs = TrackerOutputs(
        boxes=torch.stack([x1, y1, x2, y2], -1) * m[..., None],
        ids=track_id * m,
        scores=last_conf * out_mask,
        mask=out_mask,
    )
    return new_state, outputs, flags


def tracker_feature_post(gallery, gallery_count, pending_count, flags: TrackerFlags,
                         f_n, hp: TrackerParams):
    """Commit the frame's gallery mutations, IN PLACE on `gallery`.

    In order: matched tracks append their detection's feature at ring
    position (gallery_count + pending_count) % budget; deleted tracks
    reset; newly initiated slots start with their feature at position 0;
    confirmed tracks reveal their pending appends (gallery_count +=
    pending_count). Every slot writes at most one ring row. f_n [C, D, F]
    L2-normalised detection features.
    """
    b = hp.budget
    c, k = gallery_count.shape
    dev = gallery.device
    has_new = flags.src < k
    write = flags.matched | has_new
    idx = torch.clamp(torch.where(has_new, flags.src, flags.gcol), 0, f_n.shape[-2] - 1)
    feat_w = _take(f_n.to(gallery.dtype), idx)  # [C, K, F]
    pos = torch.where(has_new, 0, torch.remainder(gallery_count + pending_count, b)).long()
    ci = torch.arange(c, device=dev)[:, None].expand(c, k)
    ki = torch.arange(k, device=dev)[None, :].expand(c, k)
    old = gallery[ci, ki, pos]
    gallery[ci, ki, pos] = torch.where(write[..., None], feat_w, old)  # unwritten slots keep their row

    pending_count = torch.where(flags.matched, pending_count + 1, pending_count)
    gallery_count = torch.where(flags.delete, 0, gallery_count)
    pending_count = torch.where(flags.delete, 0, pending_count)
    gallery_count = torch.where(has_new, 0, gallery_count)
    pending_count = torch.where(has_new, 1, pending_count)
    gallery_count = torch.where(flags.conf_after, gallery_count + pending_count, gallery_count)
    pending_count = torch.where(flags.conf_after, 0, pending_count)
    return gallery, gallery_count.to(torch.int32), pending_count.to(torch.int32)


def present_gate(st: TrackerState, new_st: TrackerState, outputs: TrackerOutputs, flags: TrackerFlags, present):
    """A class with no raw detection this frame (`present` [C] False)
    keeps its state, outputs nothing and flags nothing."""
    k = flags.src.shape[-1]

    def keep(new, old):
        p = present.reshape(present.shape + (1,) * (new.dim() - 1))
        return torch.where(p, new, old)

    new_st = new_st._replace(**{f: keep(getattr(new_st, f), getattr(st, f)) for f in SMALL_FIELDS})
    outputs = TrackerOutputs(*(keep(o, torch.zeros_like(o)) for o in outputs))
    flags = TrackerFlags(
        matched=flags.matched & present[:, None],
        gcol=keep(flags.gcol, torch.zeros_like(flags.gcol)),
        delete=flags.delete & present[:, None],
        src=keep(flags.src, torch.full_like(flags.src, k)),
        conf_after=flags.conf_after & present[:, None],
    )
    return new_st, outputs, flags


def tracker_step_core(st: TrackerState, pre, tlwh, conf, det_valid, hp: TrackerParams,
                      width: int, height: int, present, det_order):
    """Association + lifecycle for [C] classes from `tracker_precompute`'s
    `pre`, gated by `present` [C]: a class with no raw detection this frame
    keeps its state, outputs nothing and flags nothing. Returns (new_state,
    outputs, flags); the gallery leaves pass through."""
    mean, cov, gated = pre
    tentative, lvl_of, iou_cost, iou_order = association_inputs(st, mean, tlwh, hp)
    assoc = _associate(gated, iou_cost, lvl_of, tentative, st.track_id, iou_order, det_valid, det_order, hp)
    new_st, outputs, flags = lifecycle(st, mean, cov, tlwh, conf, det_valid, *assoc, hp, width, height)
    return present_gate(st, new_st, outputs, flags, present)


def _tracker_step_impl(st: TrackerState, tlwh, conf, feat, det_valid, hp: TrackerParams, width: int, height: int,
                       det_order, pre=None, present=None):
    """Self-contained single-class step on an unbatched [K] state, through
    the [C]-batched frame step with C = 1: kernels K9 and K10 on the card,
    their plain versions on the CPU. A given `pre` (pred_mean, pred_cov,
    gated) stands for the predict and the gated cost: the association's
    other operands are computed from it, then K10 runs. `present` (a bool
    tensor, default True) gates the step. The gallery is updated in
    place."""
    from vehicle_counting_tpu_torch.ops.track_frame import PreOut, track_frame_post
    from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, FrameInputs, frame_update

    one = TrackerState(*(x[None] for x in st))
    present = torch.as_tensor(True if present is None else present, dtype=torch.bool, device=det_valid.device)
    inp = FrameInputs(tlwh[None], conf[None], det_valid[None], feat[None], present.reshape(1), det_order[None])
    if pre is None:
        new_st, outputs = frame_update(one, inp, DeepSortParams(tracker=hp, num_classes=1), (height, width))
    else:
        mean, cov, gated = (p[None] for p in pre)
        tentative, lvl_of, iou_cost, iou_order = association_inputs(one, mean, inp.tlwh, hp)
        assoc = _associate(gated, iou_cost, lvl_of, tentative, one.track_id, iou_order, inp.valid, inp.order, hp)
        new_st, outputs = track_frame_post(one, PreOut(mean, cov, gated, iou_cost, lvl_of, tentative, iou_order),
                                           inp.tlwh, inp.scores, inp.valid, inp.present, l2_normalize(inp.feats),
                                           *assoc, hp, width, height)
    return TrackerState(*(x[0] for x in new_st)), TrackerOutputs(*(o[0] for o in outputs))


def tracker_step(st: TrackerState, tlwh, conf, feat, det_valid, hp: TrackerParams, width: int, height: int,
                 present=None, det_order=None, pre=None):
    """One frame for one class (JAX `tracker.py::tracker_step`): state
    leaves without the class axis ([K, ...]), detections tlwh [K, 4], conf
    [K], feat [K, F], det_valid [K] (after the confidence filter and NMS).

    `present`: whether the class had ANY raw detection this frame, before
    the confidence filter (modules/track.py:55-59); default any(det_valid).
    A class not present keeps its state and outputs nothing (a select, not
    a host branch). `det_order` [K] i32: each detection's rank in the
    reference's detection list (default: slot order). `pre`: an unbatched
    `tracker_precompute` result (K9's first three outputs), computed here
    when absent.
    Returns (new state, TrackerOutputs [K, ...]); the gallery is updated in
    place."""
    if present is None:
        present = det_valid.any()
    if det_order is None:
        det_order = torch.arange(hp.capacity, dtype=torch.int32, device=det_valid.device)
    return _tracker_step_impl(st, tlwh, conf, feat, det_valid, hp, width, height, det_order, pre, present)
