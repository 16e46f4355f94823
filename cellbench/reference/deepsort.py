"""Plain DeepSORT, one tracker per class, in NumPy (float64) with scipy's
Hungarian solver: the reference's matching cascade over cosine-gallery
costs gated by the Mahalanobis distance, the IoU stage, the track
lifecycle, the gallery budget and the output rule (nwojke/deep_sort as
kaylode/vehicle-counting runs it, modules/track.py).

What the configuration adds to the published tracker, and this states:
- features are L2-normalised and stored in the gallery in `feat_dtype`
  (bfloat16); the cosine distance is 1 - <gallery row, feature>;
- a class holds at most `capacity` live tracks: a new track that finds no
  free place is dropped and takes no id;
- a class sees at most `capacity` detections per frame, the first in the
  detector's order;
- a class with no detection in a frame is not updated (no predict either).

With `tie_eps` the tracker also notes whether a frame's update took a
decision that lies within rounding of its other side (`near_tie`): an
NMS overlap or a cost at its threshold, a Mahalanobis distance at the
gate, or an assignment whose best alternative costs within `tie_eps` of
it. float32 and float64 can take either side of such a decision, and the
rest of the class's batch follows whichever side was taken.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch
from scipy.optimize import linear_sum_assignment

CHI2_GATE = 9.4877
GATE_TIE = 1e-2  # relative: the gate's distance carries the Kalman state's drift
INFTY = 1e5
TENT, CONF, DEL = 1, 2, 3


def round_to(x, dtype: str):
    """x rounded to `dtype` and back to float64 (the gallery's storage)."""
    if dtype == "float32":
        return np.asarray(x, np.float32).astype(np.float64)
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(getattr(torch, dtype))
    return t.to(torch.float64).numpy()


def unit(f):
    f = np.asarray(f, np.float32)
    return f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), np.float32(1e-12))


class KF:
    def __init__(self, q=None):
        self.F = np.eye(8)
        for i in range(4):
            self.F[i, 4 + i] = 1.0
        self.H = np.eye(4, 8)
        self.swp, self.swv = 1 / 20, 1 / 160
        self.q = q or (lambda x: x)

    def initiate(self, m):
        mean = np.r_[m, np.zeros(4)]
        h = m[3]
        std = [2 * self.swp * h, 2 * self.swp * h, 1e-2, 2 * self.swp * h,
               10 * self.swv * h, 10 * self.swv * h, 1e-5, 10 * self.swv * h]
        return self.q(mean), self.q(np.diag(np.square(std)))

    def predict(self, mean, cov):
        h = mean[3]
        q = np.diag(np.square([self.swp * h, self.swp * h, 1e-2, self.swp * h,
                               self.swv * h, self.swv * h, 1e-5, self.swv * h]))
        return self.q(self.F @ mean), self.q(self.F @ cov @ self.F.T + q)

    def project(self, mean, cov):
        h = mean[3]
        r = np.diag(np.square([self.swp * h, self.swp * h, 1e-1, self.swp * h]))
        return self.H @ mean, self.H @ cov @ self.H.T + r

    def update(self, mean, cov, z):
        pm, pc = self.project(mean, cov)
        chol = scipy.linalg.cho_factor(pc, lower=True)
        gain = scipy.linalg.cho_solve(chol, (cov @ self.H.T).T).T
        return self.q(mean + (z - pm) @ gain.T), self.q(cov - gain @ pc @ gain.T)

    def gating(self, mean, cov, zs):
        pm, pc = self.project(mean, cov)
        chol = np.linalg.cholesky(pc)
        z = scipy.linalg.solve_triangular(chol, (zs - pm).T, lower=True)
        return self.q(np.sum(z * z, axis=0))


def tlwh_to_xyah(t):
    return np.array([t[0] + t[2] / 2, t[1] + t[3] / 2, t[2] / max(t[3], 1e-6), t[3]])


def iou_tlwh(a, bs):
    ax1, ay1, ax2, ay2 = a[0], a[1], a[0] + a[2], a[1] + a[3]
    out = []
    for b in bs:
        bx1, by1, bx2, by2 = b[0], b[1], b[0] + b[2], b[1] + b[3]
        ix = max(0.0, min(ax2, bx2) - max(ax1, bx1))
        iy = max(0.0, min(ay2, by2) - max(ay1, by1))
        inter = ix * iy
        u = a[2] * a[3] + b[2] * b[3] - inter
        out.append(inter / u if u > 0 else 0.0)
    return np.array(out)


class Track:
    def __init__(self, mean, cov, tid, feature, conf, hits=1, age=1, tsu=0, state=TENT):
        self.mean, self.cov = mean, cov
        self.track_id = tid
        self.hits, self.age, self.tsu, self.state = hits, age, tsu, state
        self.features = [] if feature is None else [feature]
        self.conf = conf

    def predict(self, kf):
        self.mean, self.cov = kf.predict(self.mean, self.cov)
        self.age += 1
        self.tsu += 1

    def update(self, kf, det, n_init):
        tlwh, conf, feat = det
        self.mean, self.cov = kf.update(self.mean, self.cov, tlwh_to_xyah(tlwh))
        self.features.append(feat)
        self.conf = conf
        self.hits += 1
        self.tsu = 0
        if self.state == TENT and self.hits >= n_init:
            self.state = CONF

    def mark_missed(self, max_age):
        if self.state == TENT or self.tsu > max_age:
            self.state = DEL

    def to_tlwh(self):
        m = self.mean
        w = m[2] * m[3]
        return np.array([m[0] - w / 2, m[1] - m[3] / 2, w, m[3]])


def sort_nms(tlwhs, scores, max_overlap):
    """SORT's greedy NMS; picks in processing order (descending score, ties
    to the higher index), the detection list's order downstream."""
    if len(tlwhs) == 0:
        return []
    x1, y1 = tlwhs[:, 0], tlwhs[:, 1]
    x2, y2 = tlwhs[:, 2] + tlwhs[:, 0], tlwhs[:, 3] + tlwhs[:, 1]
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    idxs = list(np.argsort(scores, kind="stable"))
    pick = []
    while idxs:
        i = idxs.pop()
        pick.append(i)
        keep = []
        for j in idxs:
            w = max(0.0, min(x2[i], x2[j]) - max(x1[i], x1[j]) + 1)
            h = max(0.0, min(y2[i], y2[j]) - max(y1[i], y1[j]) + 1)
            if (w * h) / area[j] <= max_overlap:
                keep.append(j)
        idxs = keep
    return pick


def _overlap_near(tlwhs, max_overlap, eps):
    """Whether any pair's overlap ratio, as `sort_nms` computes it, lies
    within `eps` of `max_overlap`."""
    x1, y1 = tlwhs[:, 0], tlwhs[:, 1]
    x2, y2 = tlwhs[:, 2] + x1, tlwhs[:, 3] + y1
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    w = np.maximum(0.0, np.minimum(x2[:, None], x2[None]) - np.maximum(x1[:, None], x1[None]) + 1)
    h = np.maximum(0.0, np.minimum(y2[:, None], y2[None]) - np.maximum(y1[:, None], y1[None]) + 1)
    ratio = w * h / area[None, :]
    np.fill_diagonal(ratio, np.inf)
    return bool(np.any(np.abs(ratio - max_overlap) < eps))


class DeepSort:
    """One class's tracker. `q` rounds the Kalman state, the gating
    distances and the costs (the lower-precision control; None: float64)."""

    def __init__(self, tcfg, q=None, tie_eps=None):
        self.t = tcfg
        self.q = q or (lambda x: x)
        self.tie_eps = tie_eps
        self.near_tie = False
        self.kf = KF(q)
        self.tracks = []
        self.samples = {}
        self.next_id = 1

    @classmethod
    def from_slots(cls, tcfg, slots, q=None, tie_eps=None):
        """A tracker holding the state of one class's fixed slots: dict of
        numpy arrays mean [K, 8], cov [K, 8, 8], track_id, state, hits, age,
        tsu, gallery [K, budget, F], gallery_count, pending_count, last_conf
        [K], and next_id. Tracks in id order (their creation order);
        revealed gallery rows oldest first, pending rows as the track's
        unrevealed features."""
        self = cls(tcfg, q, tie_eps)
        b = tcfg["budget"]
        live = [k for k in range(len(slots["state"])) if slots["state"][k] > 0]
        for k in sorted(live, key=lambda k: slots["track_id"][k]):
            t = Track(slots["mean"][k].astype(np.float64), slots["cov"][k].astype(np.float64),
                      int(slots["track_id"][k]), None, float(slots["last_conf"][k]), int(slots["hits"][k]),
                      int(slots["age"][k]), int(slots["tsu"][k]), CONF if slots["state"][k] == 2 else TENT)
            n, p = int(slots["gallery_count"][k]), int(slots["pending_count"][k])
            g = slots["gallery"][k].astype(np.float64)
            t.features = [g[(n + j) % b] for j in range(p)]
            if t.state == CONF:
                self.samples[t.track_id] = [g[(n + j) % b] for j in range(-min(n, b), 0)]
            self.tracks.append(t)
        self.next_id = int(slots["next_id"])
        return self

    def _match(self, cost_fn, thr, track_idx, det_idx, dets):
        if not track_idx or not det_idx:
            return [], list(track_idx), list(det_idx)
        cost = self.q(cost_fn(track_idx, det_idx, dets))
        if self.tie_eps is not None and np.any(np.abs(cost - thr) < self.tie_eps):
            self.near_tie = True
        cost = np.where(cost > thr, thr + 1e-5, cost)
        ri, ci = linear_sum_assignment(cost)
        if self.tie_eps is not None and not self.near_tie:
            self.near_tie = self._assignment_margin(cost, thr, ri, ci) < self.tie_eps
        matches = []
        um_t = [t for r, t in enumerate(track_idx) if r not in ri]
        um_d = [d for c, d in enumerate(det_idx) if c not in ci]
        for r, c in zip(ri, ci):
            if cost[r, c] > thr:
                um_t.append(track_idx[r])
                um_d.append(det_idx[c])
            else:
                matches.append((track_idx[r], det_idx[c]))
        return matches, um_t, um_d

    @staticmethod
    def _assignment_margin(cost, thr, ri, ci):
        """How much more the best assignment costs that drops one of the
        accepted pairs (each in turn made a rejected pair)."""
        best = cost[ri, ci].sum()
        margin = np.inf
        for r, c in zip(ri, ci):
            if cost[r, c] > thr:
                continue
            alt = cost.copy()
            alt[r, c] = thr + 1e-5
            r2, c2 = linear_sum_assignment(alt)
            margin = min(margin, alt[r2, c2].sum() - best)
        return margin

    def _app_cost(self, track_idx, det_idx, dets):
        f = np.array([dets[i][2] for i in det_idx])
        cost = np.zeros((len(track_idx), len(det_idx)))
        zs = np.array([tlwh_to_xyah(dets[i][0]) for i in det_idx])
        for r, ti in enumerate(track_idx):
            t = self.tracks[ti]
            cost[r] = (1.0 - np.asarray(self.samples[t.track_id]) @ f.T).min(axis=0)
            d = self.kf.gating(t.mean, t.cov, zs)
            if self.tie_eps is not None and np.any(np.abs(d - CHI2_GATE) < GATE_TIE * CHI2_GATE):
                self.near_tie = True
            cost[r, d > CHI2_GATE] = INFTY
        return cost

    def _iou_cost(self, track_idx, det_idx, dets):
        cost = np.zeros((len(track_idx), len(det_idx)))
        boxes = [dets[i][0] for i in det_idx]
        for r, ti in enumerate(track_idx):
            t = self.tracks[ti]
            cost[r] = INFTY if t.tsu > 1 else 1.0 - iou_tlwh(t.to_tlwh(), boxes)
        return cost

    def update(self, boxes_xyxy, confidences, feats, frame_hw):
        """One frame of this class's detections (already limited to the
        first `capacity`; at least one). Returns output rows [x1, y1, x2,
        y2, id] of the confirmed tracks updated this frame."""
        t = self.t
        h, w = frame_hw
        tlwhs = np.asarray(boxes_xyxy, np.float64).copy()
        tlwhs[:, 2:] -= tlwhs[:, :2]
        f_n = round_to(unit(feats), t["feat_dtype"])
        dets = [(tlwhs[i], float(confidences[i]), f_n[i]) for i in range(len(tlwhs))
                if confidences[i] > t["min_confidence"]]
        self.near_tie = False
        if dets:
            if self.tie_eps is not None:
                self.near_tie = _overlap_near(np.array([d[0] for d in dets]), t["nms_max_overlap"], self.tie_eps)
            keep = sort_nms(np.array([d[0] for d in dets]), np.array([d[1] for d in dets]), t["nms_max_overlap"])
            dets = [dets[i] for i in keep]

        for tr in self.tracks:
            tr.predict(self.kf)

        confirmed = [i for i, tr in enumerate(self.tracks) if tr.state == CONF]
        unconfirmed = [i for i, tr in enumerate(self.tracks) if tr.state != CONF]
        unmatched_d = list(range(len(dets)))
        matches_a = []
        remaining = set(confirmed)
        for level in range(t["max_age"]):
            if not unmatched_d:
                break
            lvl = [k for k in confirmed if self.tracks[k].tsu == 1 + level]
            if not lvl:
                continue
            m, _, unmatched_d = self._match(self._app_cost, t["max_dist"], lvl, unmatched_d, dets)
            matches_a += m
            for k, _ in m:
                remaining.discard(k)
        um_t_a = sorted(remaining)
        iou_cands = unconfirmed + [k for k in um_t_a if self.tracks[k].tsu == 1]
        um_t_a = [k for k in um_t_a if self.tracks[k].tsu != 1]
        matches_b, um_t_b, unmatched_d = self._match(self._iou_cost, t["max_iou_distance"], iou_cands,
                                                     unmatched_d, dets)

        for ti, di in matches_a + matches_b:
            self.tracks[ti].update(self.kf, dets[di], t["n_init"])
        for ti in set(um_t_a + um_t_b):
            self.tracks[ti].mark_missed(t["max_age"])
        room = t["capacity"] - sum(tr.state != DEL for tr in self.tracks)
        for di in unmatched_d[:max(room, 0)]:
            mean, cov = self.kf.initiate(tlwh_to_xyah(dets[di][0]))
            self.tracks.append(Track(mean, cov, self.next_id, dets[di][2], dets[di][1]))
            self.next_id += 1
        self.tracks = [tr for tr in self.tracks if tr.state != DEL]

        active = {tr.track_id for tr in self.tracks if tr.state == CONF}
        for tr in self.tracks:
            if tr.state == CONF:
                s = self.samples.setdefault(tr.track_id, []) + tr.features
                self.samples[tr.track_id] = s[-t["budget"]:]
                tr.features = []
        self.samples = {k: v for k, v in self.samples.items() if k in active}

        out = []
        for tr in self.tracks:
            if tr.state != CONF or tr.tsu > 1:
                continue
            b = tr.to_tlwh()
            out.append([max(int(b[0]), 0), max(int(b[1]), 0), min(int(b[0] + b[2]), w - 1),
                        min(int(b[1] + b[3]), h - 1), tr.track_id])
        return out
