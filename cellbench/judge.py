"""The comparison that decides `correct`: what the timed path produced for
the checked batches against the plain reference (`cellbench/reference`),
numbers of which each cell compares those its limits file
(`cellbench/limits/<workload>.json`) names, each against its own limit.

- `det_unpaired_share`: the program's detections of the tracked classes
  against the reference detector's on the same raw frames (its own
  letterbox and I420 round trip), paired one to one within a class by the
  largest total IoU, a pair needing IoU >= 0.5. Each detection weighs its
  score's margin over the threshold, so the share is that of the unpaired
  detections' margins in all margins: a detection that one side keeps and
  the other drops at the threshold weighs next to nothing.
- `feat_gap`: the widest L2 distance between the program's ReID feature of
  a detection and the reference network's, on crops the reference cuts from
  its own pixels at the program's box.
- `track_rows_differing`: the reference tracker, started from the
  program's tracker state at the batch's start (a fresh tracker for the
  first batch) and fed the program's detections and features, against the
  program's per-frame track rows (id, integer box within a pixel) and its
  state at the batch's end (each live track's id, lifecycle state, hits,
  age and misses): the share of rows present on one side only or different.
  A class is compared up to the first frame in which the reference took a
  decision within rounding of its other side (`reference/deepsort.py`,
  `TIE_EPS`), since float32 and float64 may part there and the rest of
  the class's batch follows the side taken; its end state only where the
  batch had no such frame. Past such a frame the age of each track that
  was live at the batch's start and is live at its end on both sides is
  still compared: it grows by the frames in which its class had
  detections, whichever way the associations went.
- `track_box_gap` (reported; a cell compares it only where the control
  reads it at three times the program or more): the widest difference, in
  source pixels, between the two end states' Kalman boxes of the tracks
  both hold, in the classes whose end states are compared.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from cellbench.reference import deepsort as ds_ref
from cellbench.reference import pixels as px_ref
from cellbench.reference import reid as reid_ref
from cellbench.reference import yolo as yolo_ref

NUMBERS = ("det_unpaired_share", "feat_gap", "track_rows_differing", "track_box_gap")
PAIR_IOU = 0.5
TIE_EPS = 1e-3  # costs and assignment margins: float32's drift from float64 over a batch stays far below
BOX_TOLERANCE_PX = 1  # integer output boxes: f32 and f64 Kalman states truncate apart by one
STATE_FIELDS = ("mean", "cov", "track_id", "state", "hits", "age", "tsu", "gallery", "gallery_count",
                "pending_count", "last_conf", "next_id")


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Rounding to float8 e4m3 with one scale per tensor, its largest
    magnitude at the format's largest (448): the control's conv operands."""
    s = x.abs().amax().clamp(min=1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


def bf16(x):
    """Rounding to bfloat16 of a float64 array (the control's tracker)."""
    return ds_ref.round_to(x, "bfloat16")


class Frame:
    """One frame's detections of the tracked classes, in the detector's
    order: boxes [n, 4] source pixels, scores, classes, feats [n, F]."""

    def __init__(self, boxes, scores, classes, feats=None):
        self.boxes, self.scores, self.classes, self.feats = boxes, scores, classes, feats


def program_frames(det, feats) -> List[Frame]:
    v = det["valid"].cpu().numpy()
    b, s, c = (det[k].float().cpu().numpy() if k != "classes" else det[k].cpu().numpy()
               for k in ("boxes", "scores", "classes"))
    f = feats.float().cpu().numpy() if feats is not None else None
    return [Frame(b[i][v[i]], s[i][v[i]], c[i][v[i]].astype(np.int64), None if f is None else f[i][v[i]])
            for i in range(v.shape[0])]


def reference_frames(cfg, w, frames_u8, lut, conf, q=None, block=32) -> List[Frame]:
    """The reference detector on raw frames [B, H, W, 3] u8 (device),
    classes mapped through `lut` (-1 dropped), in blocks of frames."""
    out = []
    lut_t = torch.as_tensor(lut, device=frames_u8.device)
    for i in range(0, frames_u8.shape[0], block):
        pix = px_ref.network_pixels(frames_u8[i:i + block], cfg["net_hw"])
        for boxes, scores, cls in yolo_ref.detect(cfg, w, pix.float() / 255.0, conf, q):
            mapped = lut_t[cls]
            keep = mapped >= 0
            out.append(Frame(boxes[keep].cpu().numpy(), scores[keep].cpu().numpy(),
                             mapped[keep].cpu().numpy().astype(np.int64)))
    return out


def reference_feats(cfg, reid_p, reid_s, frames_u8, boxes_per_frame, q=None, block=512) -> List[np.ndarray]:
    """The reference ReID features at the given source-pixel boxes (one
    array [n_i, 4] per frame), crops cut from the reference's pixels."""
    rc = cfg["reid"]
    dev = frames_u8.device
    gain, pad_x, pad_y = px_ref.box_transform(cfg["source_hw"], cfg["net_hw"])
    counts = [len(b) for b in boxes_per_frame]
    out = [np.zeros((n, rc["embed_dim"]), np.float32) for n in counts]
    if not sum(counts):
        return out
    flat = torch.as_tensor(np.concatenate(boxes_per_frame).astype(np.float32), device=dev)
    flat = flat * gain + torch.tensor([pad_x, pad_y, pad_x, pad_y], dtype=torch.float32, device=dev)
    fidx = torch.as_tensor(np.repeat(np.arange(len(counts)), counts), device=dev)
    feats = []
    pix = px_ref.network_pixels(frames_u8, cfg["net_hw"])
    for i in range(0, flat.shape[0], block):
        c = px_ref.crops(pix, fidx[i:i + block], flat[i:i + block], rc["crop_hw"], rc["mean"], rc["std"])
        feats.append(reid_ref.embed(rc, reid_p, reid_s, c, q).cpu().numpy())
    feats = np.concatenate(feats)
    return np.split(feats, np.cumsum(counts)[:-1])


def det_numbers(prog: List[Frame], ref: List[Frame], conf: float):
    """(unpaired margin, margin): each detection weighs its score's margin
    over the threshold, so that one the other side drops at the threshold
    weighs next to nothing; pairs one to one by the largest total IoU
    within a class (IoU >= PAIR_IOU)."""
    unpaired, total = 0.0, 0.0
    for p, r in zip(prog, ref):
        mp, mr = p.scores.astype(np.float64) - conf, r.scores.astype(np.float64) - conf
        total += mp.sum() + mr.sum()
        unpaired += mp.sum() + mr.sum()
        if len(mp) and len(mr):
            iou = yolo_ref._iou(torch.as_tensor(p.boxes, dtype=torch.float64),
                                torch.as_tensor(r.boxes, dtype=torch.float64)).numpy()
            iou = np.where(p.classes[:, None] == r.classes[None, :], iou, 0.0)
            ri, ci = linear_sum_assignment(-iou)
            ok = iou[ri, ci] >= PAIR_IOU
            unpaired -= mp[ri[ok]].sum() + mr[ci[ok]].sum()
    return unpaired, total


def feat_gap(prog_feats: List[np.ndarray], ref_feats: List[np.ndarray]) -> float:
    gaps = [np.linalg.norm(p - r, axis=1).max() for p, r in zip(prog_feats, ref_feats) if len(p)]
    return float(max(gaps)) if gaps else 0.0


def _slots(state: Dict[str, np.ndarray], c: int) -> Dict[str, np.ndarray]:
    return {k: state[k][c] for k in STATE_FIELDS}


def run_tracker(cfg, state0, frames: List[Frame], q=None, tie_eps=None):
    """The reference tracker over a batch's frames, per class, from the
    program's slot state `state0` (numpy leaves [C, ...]) or fresh (None).
    Returns (rows per frame {(class, id): box}, end state {(class, id):
    (state, hits, age, tsu)}, end boxes, and per class the first frame
    with a near-tie, len(frames) where none: all len(frames) without
    `tie_eps`)."""
    tc = cfg["tracker"]
    k = tc["capacity"]
    hw = tuple(cfg["source_hw"])
    trackers = [ds_ref.DeepSort.from_slots(tc, _slots(state0, c), q, tie_eps) if state0 is not None
                else ds_ref.DeepSort(tc, q, tie_eps) for c in range(tc["num_classes"])]
    rows = []
    cut = [len(frames)] * len(trackers)
    for f, fr in enumerate(frames):
        out = {}
        for c, tr in enumerate(trackers):
            sel = np.nonzero(fr.classes == c)[0][:k]
            if sel.size:
                for x1, y1, x2, y2, tid in tr.update(fr.boxes[sel], fr.scores[sel], fr.feats[sel], hw):
                    out[(c, tid)] = (x1, y1, x2, y2)
                if tr.near_tie:
                    cut[c] = min(cut[c], f)
        rows.append(out)
    end = {(c, t.track_id): (t.state, t.hits, t.age, t.tsu) for c, tr in enumerate(trackers) for t in tr.tracks}
    boxes = {(c, t.track_id): t.to_tlwh() for c, tr in enumerate(trackers) for t in tr.tracks}
    return rows, end, boxes, cut


def _tlwh(mean):
    w = mean[..., 2] * mean[..., 3]
    return np.stack([mean[..., 0] - w / 2, mean[..., 1] - mean[..., 3] / 2, w, mean[..., 3]], -1)


def program_tracks(mask, ids, boxes, state_end):
    """The program's rows per frame, end state and end boxes in
    `run_tracker`'s form."""
    rows = []
    for f in range(mask.shape[0]):
        c, s = np.nonzero(mask[f])
        rows.append({(int(ci), int(ids[f, ci, si])): tuple(int(v) for v in boxes[f, ci, si]) for ci, si in zip(c, s)})
    c, s = np.nonzero(state_end["state"] > 0)
    keys = [(int(ci), int(state_end["track_id"][ci, si])) for ci, si in zip(c, s)]
    end = {k: tuple(int(state_end[f][ci, si]) for f in ("state", "hits", "age", "tsu")) for k, ci, si in zip(keys, c, s)}
    tlwh = _tlwh(state_end["mean"].astype(np.float64))
    return rows, end, {k: tlwh[ci, si] for k, ci, si in zip(keys, c, s)}


def track_numbers(prog, ref, old=frozenset()):
    """(rows differing, rows compared, widest box gap in pixels, rows in
    all): per-frame rows (an id on one side only, or its integer box apart
    by more than BOX_TOLERANCE_PX) of each class before the reference's
    first near-tie in it, and, in the classes with none, the end state's
    tracks (id, lifecycle state, hits, age, misses) and the gap between the
    two end states' boxes of the tracks both hold; in the other classes the
    age of the tracks in `old` (live at the batch's start) that both end
    states hold."""
    (p_rows, p_end, p_box), (r_rows, r_end, r_box, cut) = prog[:3], ref
    whole = {c for c, f in enumerate(cut) if f == len(r_rows)}
    diff = total = every = 0
    for f, (a, b) in enumerate(zip(p_rows, r_rows)):
        for key in set(a) | set(b):
            every += 1
            if f >= cut[key[0]]:
                continue
            total += 1
            diff += key not in a or key not in b or max(abs(x - y) for x, y in zip(a[key], b[key])) > BOX_TOLERANCE_PX
    for key in set(p_end) | set(r_end):
        every += 1
        if key[0] in whole:
            total += 1
            diff += p_end.get(key) != r_end.get(key)
        elif key in old and key in p_end and key in r_end:
            total += 1
            diff += p_end[key][2] != r_end[key][2]
    common = {k for k in set(p_box) & set(r_box) if k[0] in whole}
    gap = max((float(np.abs(p_box[k] - r_box[k]).max()) for k in common), default=0.0)
    return diff, total, gap, every


class Tally:
    """The numbers over every checked batch."""

    def __init__(self):
        self.unpaired = self.margin = 0.0
        self.rows_diff = self.rows = self.rows_all = 0
        self.feat_gap = self.box_gap = 0.0

    def add(self, det, feat, track):
        self.unpaired += det[0]
        self.margin += det[1]
        self.feat_gap = max(self.feat_gap, feat)
        self.rows_diff += track[0]
        self.rows += track[1]
        self.box_gap = max(self.box_gap, track[2])
        self.rows_all += track[3]

    def compared_share(self) -> float:
        """The share of the tracker's rows that came before a near-tie."""
        return self.rows / max(self.rows_all, 1)

    def numbers(self) -> Dict[str, float]:
        return {"det_unpaired_share": self.unpaired / max(self.margin, 1e-12), "feat_gap": self.feat_gap,
                "track_rows_differing": self.rows_diff / max(self.rows, 1), "track_box_gap": self.box_gap}


def check_batch(cfg, ref_w, frames_u8, lut, conf, checked, tally: Tally, control: bool = False):
    """Judge one checked batch (`checked`: the program's det, feats, host
    track rows and states at the batch's start and end). With `control`,
    the reference at the precision below the configuration's stands in for
    the program: float8 conv operands, a bfloat16 tracker."""
    yolo_w, reid_p, reid_s = ref_w
    ref = reference_frames(cfg, yolo_w, frames_u8, lut, conf)
    if control:
        prog = reference_frames(cfg, yolo_w, frames_u8, lut, conf, q=fp8)
        for fr, f in zip(prog, reference_feats(cfg, reid_p, reid_s, frames_u8, [p.boxes for p in prog], q=fp8)):
            fr.feats = f
    else:
        prog = program_frames(checked["det"], checked["feats"])
    ref_feats = reference_feats(cfg, reid_p, reid_s, frames_u8, [p.boxes for p in prog])
    feat = feat_gap([p.feats for p in prog], ref_feats)
    det = det_numbers(prog, ref, conf)
    if control:
        prog_tracks = run_tracker(cfg, checked["state0"], prog, q=bf16)
    else:
        prog_tracks = program_tracks(checked["mask"], checked["ids"], checked["boxes"], checked["state1"])
    s0 = checked["state0"]
    old = set() if s0 is None else {(int(c), int(s0["track_id"][c, k])) for c, k in zip(*np.nonzero(s0["state"] > 0))}
    track = track_numbers(prog_tracks, run_tracker(cfg, s0, prog, tie_eps=TIE_EPS), old)
    tally.add(det, feat, track)
    return det, feat, track
