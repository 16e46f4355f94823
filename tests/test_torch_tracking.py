"""PyTorch port, tracker: Kalman filter, the scipy-exact assignment, the
association (kernel K2's plain version, and the staged route over kernel
K4's plain version) and the per-frame DeepSORT core, against the JAX
package on the same numpy inputs."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy.optimize import linear_sum_assignment

from vehicle_counting_tpu.ops.pallas.cascade import LVL_SENTINEL, cascade_match_classparallel as j_cp
from vehicle_counting_tpu.tracking import kalman as jk
from vehicle_counting_tpu.tracking.assignment import solve_assignment_sub as j_solve
from vehicle_counting_tpu.tracking.deepsort import DeepSortParams as JDP
from vehicle_counting_tpu.tracking.deepsort import deepsort_frame_core as j_core
from vehicle_counting_tpu.tracking.deepsort import init_states as j_init
from vehicle_counting_tpu.tracking.tracker import TrackerParams as JTP
from vehicle_counting_tpu.tracking.tracker import _associate_xla, _cascade_kernel_mode, _stable_rank
from vehicle_counting_tpu.tracking import tracker as jtrk
from vehicle_counting_tpu_torch.ops import assignment as tasg
from vehicle_counting_tpu_torch.ops import cascade as tcas
from vehicle_counting_tpu_torch.testing import association_problem, one_torch_thread
from vehicle_counting_tpu_torch.tracking import kalman as tk
from vehicle_counting_tpu_torch.tracking import tracker as trk
from vehicle_counting_tpu_torch.tracking.assignment import BIG, solve_assignment_sub as t_solve
from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, deepsort_frame_core, init_states
from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

_staged = trk._associate_staged
NAMES = ["gated", "iou", "lvl_of", "tentative", "track_id", "iou_order", "det_valid", "det_order"]


def _kf_inputs(seed, k=10):
    rng = np.random.default_rng(seed)
    xyah = np.stack([rng.uniform(0, 300, k), rng.uniform(0, 200, k), rng.uniform(0.3, 3, k),
                     rng.uniform(10, 80, k)], -1).astype(np.float32)
    meas = (xyah + rng.normal(0, 2, xyah.shape) * [1, 1, 0.02, 1]).astype(np.float32)
    return xyah, meas


def test_kalman_matches_jax():
    """atol 1e-5 relative to the values' scale; the gate decisions equal."""
    xyah, meas = _kf_inputs(0)
    jm, jc = jk.initiate(jnp.asarray(xyah))
    tm, tc = tk.initiate(torch.from_numpy(xyah))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=0)
    for _ in range(3):
        jm, jc = jk.predict(jm, jc)
        tm, tc = tk.predict(tm, tc)
        jm, jc = jk.update(jm, jc, jnp.asarray(meas))
        tm, tc = tk.update(tm, tc, torch.from_numpy(meas))
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    dets = np.concatenate([meas, meas + [[15, 9, 0.1, 5]]]).astype(np.float32)
    jd = np.asarray(jk.gating_distance(jm, jc, jnp.asarray(dets)))
    td = tk.gating_distance(tm, tc, torch.from_numpy(dets)).numpy()
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(td > jk.CHI2INV95_4DOF, jd > jk.CHI2INV95_4DOF)
    assert (jd > jk.CHI2INV95_4DOF).any() and (jd <= jk.CHI2INV95_4DOF).any()
    np.testing.assert_allclose(tk.to_tlwh(tm).numpy(), np.asarray(jk.to_tlwh(jm)), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_assignment_matches_jax_and_scipy(kind):
    rng = np.random.default_rng(1 if kind == "random" else 2)
    s = 12
    for _ in range(12):
        nr, nc = int(rng.integers(1, s + 1)), int(rng.integers(1, s + 1))
        sub = (rng.random((nr, nc)) if kind == "random" else rng.choice([0.1, 0.3, 0.30001], (nr, nc)))
        cost = np.full((s, s), BIG, np.float32)
        cost[:nr, :nc] = sub
        want = np.asarray(j_solve(jnp.asarray(cost), jnp.int32(nr), jnp.int32(nc)))
        got = t_solve(torch.from_numpy(cost), nr, nc).numpy()
        np.testing.assert_array_equal(got, want)
        r, c = linear_sum_assignment(cost[:nr, :nc])
        if kind == "random":
            np.testing.assert_array_equal(got[r], c)
        else:
            # scipy runs its duals in f64, where these f32 ties may not tie:
            # the optimum's cost is what must agree
            rows = np.nonzero(got[:nr] >= 0)[0]
            assert rows.size == min(nr, nc)
            np.testing.assert_allclose(cost[rows, got[rows]].sum(), cost[r, c].sum(), rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_associate(k, max_age):
    hp = JTP(capacity=k, max_age=max_age)
    return jax.jit(lambda *a: _associate_xla(*a, hp))


@pytest.mark.parametrize("route", ["kernel", "staged"])
@pytest.mark.parametrize("kind", ["random", "ties", "empty", "steady"])
def test_association_bitwise_equal_to_jax(kind, route):
    """K2's plain version, and the [C]-batched staged route, per class
    against JAX `_associate_xla`."""
    k, c, max_age = 12, 4, 5
    fn = _jax_associate(k, max_age)
    hp = TrackerParams(capacity=k, max_age=max_age)
    rng = np.random.default_rng({"random": 10, "ties": 11, "empty": 12, "steady": 17}[kind])
    for _ in range(4):
        pr = association_problem(rng, c, k, max_age, kind)
        args = [torch.from_numpy(pr[n]) for n in NAMES]
        if route == "kernel":
            det_free, det_key, out_row, track_col = tcas.cascade_match_classparallel(*args, 0.2, 0.6, max_age=max_age)
        else:
            det_free, track_col, det_key = trk._associate_staged(*args, hp)
        for ci in range(c):
            jf, jcol, jkey = map(np.asarray, fn(*(jnp.asarray(pr[n][ci]) for n in NAMES)))
            np.testing.assert_array_equal(det_free[ci].numpy(), jf)
            np.testing.assert_array_equal(det_key[ci].numpy(), jkey)
            if route == "kernel":
                want_row = np.full(k, -1)
                want_row[jcol[jcol >= 0]] = np.nonzero(jcol >= 0)[0]
                np.testing.assert_array_equal(out_row[ci].numpy(), want_row)
            np.testing.assert_array_equal(track_col[ci].numpy(), jcol)


def test_association_matches_pallas_kernel_interpret():
    """One tiny case against the TPU kernel itself (interpret mode), C=2, K=8."""
    k, c, max_age = 8, 2, 4
    pr = association_problem(np.random.default_rng(13), c, k, max_age, "random")
    j_free, j_key, j_row = j_cp(
        jnp.asarray(pr["gated"]), jnp.asarray(pr["iou"]),
        jnp.asarray(np.minimum(pr["lvl_of"], LVL_SENTINEL), jnp.int32),
        jnp.asarray(pr["tentative"], jnp.int32),
        jnp.stack([_stable_rank(jnp.asarray(pr["track_id"][i])) for i in range(c)]),
        jnp.stack([_stable_rank(jnp.asarray(pr["iou_order"][i])) for i in range(c)]),
        jnp.asarray(pr["det_valid"], jnp.int32), jnp.asarray(pr["det_order"]),
        0.2, 0.6, max_age=max_age, interpret=True,
    )
    t_free, t_key, t_row, t_col = tcas.cascade_match_batched(
        *(torch.from_numpy(pr[n]) for n in NAMES), 0.2, 0.6, max_age=max_age)
    np.testing.assert_array_equal(t_free.numpy(), np.asarray(j_free))
    np.testing.assert_array_equal(t_key.numpy(), np.asarray(j_key))
    np.testing.assert_array_equal(t_row.numpy(), np.asarray(j_row))
    want_col = np.full((c, k), -1)
    for ci, row in enumerate(np.asarray(j_row)):
        want_col[ci, row[row >= 0]] = np.nonzero(row >= 0)[0]
    np.testing.assert_array_equal(t_col.numpy(), want_col)


def _scenario(seed, frames=20, n=24, c=3, feat=512):
    """Moving objects of c classes with stable appearance, missed
    detections, low-score and clutter detections."""
    rng = np.random.default_rng(seed)
    n_obj = 10
    cls = rng.integers(0, c, n_obj)
    pos = rng.uniform(20, 200, (n_obj, 2))
    vel = rng.uniform(-4, 4, (n_obj, 2))
    size = rng.uniform(15, 40, (n_obj, 2))
    base = rng.standard_normal((n_obj, feat))
    out = []
    for t in range(frames):
        boxes = np.zeros((n, 4), np.float32)
        scores = np.zeros(n, np.float32)
        classes = np.full(n, -1, np.int32)
        valid = np.zeros(n, bool)
        feats = np.zeros((n, feat), np.float32)
        j = 0
        for o in rng.permutation(n_obj):
            if rng.random() < 0.15:
                continue
            xy = pos[o] + vel[o] * t + rng.normal(0, 1, 2)
            boxes[j] = [*xy, *(xy + size[o])]
            scores[j] = rng.uniform(0.2, 0.95)
            classes[j] = cls[o]
            feats[j] = base[o] + rng.normal(0, 0.3, feat)
            valid[j] = True
            j += 1
        for _ in range(2):  # clutter
            xy = rng.uniform(0, 250, 2)
            boxes[j] = [*xy, *(xy + rng.uniform(10, 30, 2))]
            scores[j] = rng.uniform(0.2, 0.9)
            classes[j] = rng.integers(0, c)
            feats[j] = rng.standard_normal(feat)
            valid[j] = True
            j += 1
        out.append((feats, boxes, scores, classes, valid))
    return out


_STATE_INTS = ("track_id", "state", "hits", "age", "tsu", "gallery_count", "pending_count", "next_id", "overflow")


def _run_frames(frames, k, max_age, out_hw=(260, 300), c=3, check_state=False, **tracker_kw):
    """JAX and the port's deepsort_frame_core over the frames; asserts each
    frame's outputs equal (with check_state, the integer state leaves too)
    and returns (confirmed outputs, states)."""
    jhp = JDP(tracker=JTP(capacity=k, max_age=max_age, n_init=3, **tracker_kw), num_classes=c)
    thp = DeepSortParams(tracker=TrackerParams(capacity=k, max_age=max_age, n_init=3, **tracker_kw), num_classes=c)
    jstep = jax.jit(lambda st, *a: j_core(st, *a, jhp, out_hw))
    jst, tst = j_init(jhp), init_states(thp)
    confirmed = 0
    for feats, boxes, scores, classes, valid in frames:
        jst, jo = jstep(jst, *(jnp.asarray(x) for x in (feats, boxes, scores, classes, valid)))
        tst, to = deepsort_frame_core(tst, *(torch.from_numpy(x) for x in (feats, boxes, scores, classes, valid)),
                                      thp, out_hw)
        np.testing.assert_array_equal(to.mask.numpy(), np.asarray(jo.mask))
        np.testing.assert_array_equal(to.ids.numpy(), np.asarray(jo.ids))
        np.testing.assert_allclose(to.boxes.numpy(), np.asarray(jo.boxes), atol=1e-4)
        np.testing.assert_allclose(to.scores.numpy(), np.asarray(jo.scores), atol=1e-6)
        if check_state:
            for name in _STATE_INTS:
                np.testing.assert_array_equal(getattr(tst, name).numpy(), np.asarray(getattr(jst, name)), err_msg=name)
        confirmed += int(np.asarray(jo.mask).sum())
    return confirmed, jst, tst


@pytest.mark.parametrize("route", ["auto", "staged"])
def test_frame_core_matches_jax_over_frames(route, monkeypatch):
    """Both association routes of the port: auto (K2) and the staged
    route forced (K4 per stage)."""
    if route == "staged":
        monkeypatch.setattr(trk, "FORCE_PALLAS_CASCADE", False)
    calls = []
    monkeypatch.setattr(trk, "_associate_staged", lambda *a: calls.append(1) or _staged(*a))
    confirmed, jst, tst = _run_frames(_scenario(20), 12, 6)
    assert bool(calls) == (route == "staged")
    np.testing.assert_array_equal(tst.track_id.numpy(), np.asarray(jst.track_id))
    np.testing.assert_array_equal(tst.gallery_count.numpy(), np.asarray(jst.gallery_count))
    np.testing.assert_allclose(tst.mean.numpy(), np.asarray(jst.mean), rtol=1e-4, atol=1e-3)
    assert confirmed > 20  # the scenario really tracks


@pytest.mark.cuda
def test_association_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the association kernel is CUDA C++ with no CPU mode")
    rng = np.random.default_rng(14)
    for kind in ("random", "ties", "empty"):
        pr = association_problem(rng, 4, 64, 30, kind)
        cpu = [torch.from_numpy(pr[n]) for n in NAMES]
        got = tcas.cascade_match_classparallel(*(x.cuda() for x in cpu), 0.2, 0.6, max_age=30)
        want = tcas.cascade_match_classparallel(*cpu, 0.2, 0.6, max_age=30)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def test_key_gate_takes_staged_route(monkeypatch):
    """Past K2's key range, (max_age + 2) * K >= 2^22, the port takes the
    staged route where JAX's dispatch returns "off", and counts the same."""
    k, max_age = 8, 1 << 19
    assert _cascade_kernel_mode(JTP(capacity=k, max_age=max_age)) == "off"
    assert not trk._use_cascade_kernel(TrackerParams(capacity=k, max_age=max_age))
    assert trk._use_cascade_kernel(TrackerParams(capacity=k, max_age=(1 << 19) - 3))
    calls = []
    monkeypatch.setattr(trk, "_associate_staged", lambda *a: calls.append(1) or _staged(*a))
    confirmed, _, _ = _run_frames(_scenario(21, frames=6), k, max_age)
    assert calls and confirmed > 0


def test_k320_takes_staged_route_matches_jax(monkeypatch):
    """K = 320 is past K2's 256 slots: the port takes the staged route, as
    JAX does with its Pallas cascade off, and agrees with it frame by frame
    (ids, mask and the integer state exactly; boxes atol 1e-4)."""
    k, max_age = 320, 4
    monkeypatch.setattr(jtrk, "FORCE_PALLAS_CASCADE", False)
    assert _cascade_kernel_mode(JTP(capacity=k, max_age=max_age)) == "off"
    assert not trk._use_cascade_kernel(TrackerParams(capacity=k, max_age=max_age))
    assert trk._use_cascade_kernel(TrackerParams(capacity=256, max_age=max_age))
    calls = []
    monkeypatch.setattr(trk, "_associate_staged", lambda *a: calls.append(1) or _staged(*a))
    confirmed, _, _ = _run_frames(_scenario(22, frames=8, feat=32), k, max_age, c=2, check_state=True,
                                  feat_dim=32, budget=6)
    assert len(calls) == 8 and confirmed > 0


def test_association_rejects_k_past_max_s():
    """Past kernel K4's width (one column per thread, K <= 1023) the staged
    route raises, on the CPU as on the card."""
    k = tasg.MAX_S + 1
    z = torch.zeros((1, k), dtype=torch.int32)
    with pytest.raises(ValueError, match=f"K <= {tasg.MAX_S}"):
        trk._associate(torch.zeros((1, k, k)), torch.zeros((1, k, k)), z, z.bool(), z, z, z.bool(), z,
                       TrackerParams(capacity=k, max_age=3))


def test_kernel_gate_raises_past_key_range():
    pr = association_problem(np.random.default_rng(15), 2, 8, 4, "random")
    args = [torch.from_numpy(pr[n]) for n in NAMES]
    # the kernel ranks its keys before packing them: its own limit is the
    # int32 range of the demoted keys, (max_age + 2) * K
    with pytest.raises(ValueError, match="int32 range of the detection keys"):
        tcas._launch(*args, 0.2, 0.6, (1 << 31) // 8)
    # the routing keeps the reference's gate: past 2^22 the staged route
    assert not trk._use_cascade_kernel(TrackerParams(capacity=8, max_age=(1 << 22) // 8))
    assert trk._use_cascade_kernel(TrackerParams(capacity=8, max_age=30))


@pytest.mark.cuda
def test_staged_route_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the assignment kernel is CUDA C++ with no CPU mode")
    rng = np.random.default_rng(16)
    hp = TrackerParams(capacity=64, max_age=30)
    for kind in ("random", "ties", "empty"):
        pr = association_problem(rng, 4, 64, 30, kind)
        cpu = [torch.from_numpy(pr[n]) for n in NAMES]
        got = trk._associate_staged(*(x.cuda() for x in cpu), hp)
        want = trk._associate_staged(*cpu, hp)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
