"""PyTorch port, `class_mode="scan"` and the single-class entry points: the
tracker's association and lifecycle class by class on [1, ...] slices (one
launch of K2's per-class entry, K3, per class on the card), against the
JAX package's scan over classes and against the port's batched mode;
`tracker_step` (one class, unbatched state) against JAX's; `deepsort_frame`
(crop + embed + step for one frame) against JAX's on the facade test's
cases; the frame runner over a scan-mode step. Bitwise unless said."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_graph import OUT_HW, _assert_trees_equal, _batches, _hp, _t
from test_torch_tracking import _scenario
from test_tracker_batched import H, W, _random_frames
from vehicle_counting_tpu.models.reid import init_reid as j_init_reid
from vehicle_counting_tpu.tracking import DeepSortParams as JDP
from vehicle_counting_tpu.tracking import TrackerParams as JTP
from vehicle_counting_tpu.tracking import deepsort_frame as j_deepsort_frame
from vehicle_counting_tpu.tracking import init_states as j_init
from vehicle_counting_tpu.tracking.deepsort import deepsort_frame_core as j_core
from vehicle_counting_tpu.tracking.tracker import init_state as j_init_state
from vehicle_counting_tpu.tracking.tracker import tracker_step as j_tracker_step
from vehicle_counting_tpu_torch.models.convert import reid_params_from_jax
from vehicle_counting_tpu_torch.ops.boxes import xyxy_to_tlwh
from vehicle_counting_tpu_torch.pipeline import step as step_mod
from vehicle_counting_tpu_torch.tracking import graph as tgraph
from vehicle_counting_tpu_torch.tracking import tracker as trk
from vehicle_counting_tpu_torch.tracking.deepsort import (
    DeepSortParams,
    deepsort_frame,
    deepsort_frame_core,
    frame_inputs,
    init_states,
)
from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams, TrackerState, init_state, tracker_step
from vehicle_counting_tpu_torch.testing import one_torch_thread

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

_INT_LEAVES = ("track_id", "state", "hits", "age", "tsu", "gallery_count", "pending_count", "next_id", "overflow")


def _count_association_entries(monkeypatch):
    """Count the calls of the association kernel's two entries as
    `tracker._associate` makes them: {"k2": n, "k3": n}."""
    calls = {"k2": 0, "k3": 0}
    cp, one = trk.cascade_match_classparallel, trk.cascade_match_batched

    def k2(*a, **kw):
        calls["k2"] += 1
        return cp(*a, **kw)

    def k3(*a, **kw):
        calls["k3"] += 1
        return one(*a, **kw)

    monkeypatch.setattr(trk, "cascade_match_classparallel", k2)
    monkeypatch.setattr(trk, "cascade_match_batched", k3)
    return calls


def _assert_outputs_equal_jax(out, jout, what):
    for name in out._fields:
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(jout, name)),
                                      err_msg=f"{what}: output {name}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scan_matches_jax_scan_and_port_batched(seed, monkeypatch):
    """`test_tracker_batched.py`'s seeds (churn, classes absent whole
    frames): the port's scan mode equals JAX's scan mode on every output
    and integer state leaf, and the port's batched mode on every output
    and state leaf, bitwise; one K3 call per class per frame, no K2."""
    rng = np.random.default_rng(seed)
    n_det, n_classes, n_frames = 24, 3, 12
    jhp = JDP(tracker=JTP(capacity=16, feat_dim=32, budget=6, pending_cap=4, max_age=4, n_init=2),
              num_classes=n_classes, class_mode="scan")
    hp_scan = DeepSortParams(tracker=TrackerParams(capacity=16, feat_dim=32, budget=6, max_age=4, n_init=2),
                             num_classes=n_classes, class_mode="scan")
    hp_bat = hp_scan._replace(class_mode="batched")
    frames = _random_frames(rng, n_frames, n_det, n_classes)
    feats = rng.normal(size=(n_frames, n_det, 32)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    core = jax.jit(j_core, static_argnames=("hp", "out_hw"))
    calls = _count_association_entries(monkeypatch)
    jst, st_scan, st_bat = j_init(jhp), init_states(hp_scan), init_states(hp_bat)
    n_out = 0
    for t, det in enumerate(frames):
        args = (feats[t],) + det
        jst, jout = core(jst, *(jnp.asarray(x) for x in args), hp=jhp, out_hw=(H, W))
        targs = [torch.from_numpy(np.asarray(x)) for x in args]
        st_scan, out_scan = deepsort_frame_core(st_scan, *targs, hp_scan, (H, W))
        n_calls = dict(calls)
        st_bat, out_bat = deepsort_frame_core(st_bat, *targs, hp_bat, (H, W))
        assert n_calls == {"k2": t, "k3": n_classes * (t + 1)}, n_calls
        _assert_outputs_equal_jax(out_scan, jout, f"frame {t}")
        for name in _INT_LEAVES:
            np.testing.assert_array_equal(getattr(st_scan, name).numpy(), np.asarray(getattr(jst, name)),
                                          err_msg=f"frame {t} state {name}")
        _assert_trees_equal(out_scan, out_bat, f"frame {t} scan vs batched outputs")
        _assert_trees_equal(st_scan, st_bat, f"frame {t} scan vs batched state")
        n_out += int(out_scan.mask.sum())
    assert int(st_scan.next_id.max()) > 2 and n_out > 0


@pytest.mark.parametrize("route", ["auto", "staged"])
def test_scan_equals_batched_on_a_tracking_scenario(route, monkeypatch):
    """A scenario that confirms, misses and deletes tracks (`_scenario`,
    classes absent for ten frames), both association routes: scan ==
    batched on every output and state leaf, and == JAX's scan on the
    outputs and integer state."""
    if route == "staged":
        monkeypatch.setattr(trk, "FORCE_PALLAS_CASCADE", False)
    hp_scan = _hp()._replace(class_mode="scan")
    hp_bat = _hp()
    jhp = JDP(tracker=JTP(capacity=hp_scan.tracker.capacity, max_age=hp_scan.tracker.max_age, n_init=3,
                          feat_dim=hp_scan.tracker.feat_dim, budget=6),
              num_classes=hp_scan.num_classes, class_mode="scan")
    core = jax.jit(j_core, static_argnames=("hp", "out_hw"))
    jst, st_scan, st_bat = j_init(jhp), init_states(hp_scan), init_states(hp_bat)
    n_out = 0
    for feats, det in _batches(32, frames=24):
        for i in range(feats.shape[0]):
            args = (feats[i], det["boxes"][i], det["scores"][i], det["classes"][i], det["valid"][i])
            jst, jout = core(jst, *(jnp.asarray(x) for x in args), hp=jhp, out_hw=OUT_HW)
            targs = [torch.from_numpy(x) for x in args]
            st_scan, out_scan = deepsort_frame_core(st_scan, *targs, hp_scan, OUT_HW)
            st_bat, out_bat = deepsort_frame_core(st_bat, *targs, hp_bat, OUT_HW)
            _assert_trees_equal(out_scan, out_bat, "scan vs batched outputs")
            _assert_trees_equal(st_scan, st_bat, "scan vs batched state")
            _assert_outputs_equal_jax(out_scan, jout, "scan vs JAX scan")
            for name in _INT_LEAVES:
                np.testing.assert_array_equal(getattr(st_scan, name).numpy(), np.asarray(getattr(jst, name)),
                                              err_msg=name)
            n_out += int(out_scan.mask.sum())
    assert n_out > 30


def test_tracker_step_matches_jax():
    """The single-class step on an unbatched state: 16 frames of one
    class's slots, with a frame where the class is absent (`present`
    False: nothing moves) and a permuted detection order; outputs and
    integer state equal to JAX's `tracker_step`, the Kalman mean to f32
    rounding."""
    k, feat = 12, 32
    tp = TrackerParams(capacity=k, feat_dim=feat, budget=6, max_age=4, n_init=2)
    jtp = JTP(capacity=k, feat_dim=feat, budget=6, max_age=4, n_init=2)
    jstep = jax.jit(j_tracker_step, static_argnames=("hp",))
    jst, tst = j_init_state(jtp), init_state(tp)
    assert tst.track_id.shape == (k,) and tst.next_id.shape == ()
    n_out = 0
    for t, (feats, boxes, scores, classes, valid) in enumerate(_scenario(40, frames=16, c=1, feat=feat)):
        tlwh = xyxy_to_tlwh(torch.from_numpy(boxes[:k])).numpy()
        ok = valid[:k] & (scores[:k] > 0.25)
        f = feats[:k] / np.maximum(np.linalg.norm(feats[:k], axis=-1, keepdims=True), 1e-12)
        order = np.random.default_rng(t).permutation(k).astype(np.int32)
        present = t != 7
        jst, jout = jstep(jst, jnp.asarray(tlwh), jnp.asarray(scores[:k]), jnp.asarray(f), jnp.asarray(ok), jtp,
                          W, H, present=jnp.asarray(present), det_order=jnp.asarray(order))
        tst, tout = tracker_step(tst, torch.from_numpy(tlwh), torch.from_numpy(scores[:k]), torch.from_numpy(f),
                                 torch.from_numpy(ok), tp, W, H, present=torch.tensor(present),
                                 det_order=torch.from_numpy(order))
        _assert_outputs_equal_jax(tout, jout, f"frame {t}")
        for name in _INT_LEAVES:
            np.testing.assert_array_equal(getattr(tst, name).numpy(), np.asarray(getattr(jst, name)), err_msg=name)
        np.testing.assert_allclose(tst.mean.numpy(), np.asarray(jst.mean), rtol=1e-4, atol=1e-3)
        n_out += int(tout.mask.sum())
    assert n_out > 10


def test_tracker_step_defaults_match_jax():
    """`present` and `det_order` left out: any(det_valid) and slot order."""
    k = 8
    tp = TrackerParams(capacity=k, feat_dim=16, budget=4, max_age=3, n_init=2)
    jtp = JTP(capacity=k, feat_dim=16, budget=4, max_age=3, n_init=2)
    jstep = jax.jit(j_tracker_step, static_argnames=("hp",))
    jst, tst = j_init_state(jtp), init_state(tp)
    rng = np.random.default_rng(5)
    xy = rng.uniform(10, 200, (k, 2)).astype(np.float32)
    for t in range(6):
        tlwh = np.concatenate([xy + 2 * t, np.full((k, 2), 30, np.float32)], -1).astype(np.float32)
        conf = rng.uniform(0.3, 0.9, k).astype(np.float32)
        f = rng.normal(size=(k, 16)).astype(np.float32)
        ok = rng.uniform(size=k) < (0.0 if t == 3 else 0.7)
        jst, jout = jstep(jst, *(jnp.asarray(x) for x in (tlwh, conf, f, ok)), jtp, W, H)
        tst, tout = tracker_step(tst, *(torch.from_numpy(x) for x in (tlwh, conf, f, ok)), tp, W, H)
        _assert_outputs_equal_jax(tout, jout, f"frame {t}")
        for name in _INT_LEAVES:
            np.testing.assert_array_equal(getattr(tst, name).numpy(), np.asarray(getattr(jst, name)), err_msg=name)
    assert int(tst.next_id) > 1


_FACADE_TP = dict(capacity=8, feat_dim=512, budget=6, max_dist=0.5, max_iou_distance=0.7, max_age=5, n_init=2)


def _facade_models():
    rp, rs = j_init_reid(jax.random.PRNGKey(0))
    trp, trs = reid_params_from_jax(jax.tree.map(np.asarray, rp), jax.tree.map(np.asarray, rs))
    return (rp, rs), (trp, trs)


def _facade_case(rng, case):
    """The two cases of tests/test_deepsort_facade.py: per step (boxes,
    scores, classes, valid)."""
    if case == "end_to_end":
        boxes = np.zeros((8, 4), np.float32)
        boxes[0], boxes[1] = [40, 40, 90, 110], [200, 100, 260, 180]
        scores = np.zeros((8,), np.float32)
        scores[:2] = [0.9, 0.8]
        classes = np.zeros((8,), np.int32)
        classes[:2] = [0, 2]
        valid = np.zeros((8,), bool)
        valid[:2] = True
        steps = []
        for _ in range(3):
            b = boxes.copy()
            b[:2] += rng.normal(0, 1, size=(2, 4)).astype(np.float32)
            steps.append((b, scores, classes, valid))
        return steps
    boxes = np.zeros((4, 4), np.float32)
    boxes[0] = [40, 40, 90, 110]
    classes = np.zeros((4,), np.int32)
    valid = np.array([True, False, False, False])
    hi, lo = np.array([0.9, 0, 0, 0], np.float32), np.array([0.1, 0, 0, 0], np.float32)
    return [(boxes, hi, classes, valid), (boxes, hi, classes, valid), (boxes, lo, classes, valid)]


@pytest.mark.parametrize("class_mode", ["batched", "scan"])
@pytest.mark.parametrize("case", ["end_to_end", "low_conf"])
def test_deepsort_frame_matches_jax(case, class_mode):
    """`deepsort_frame` (crop + ReID embed + step) on the facade test's
    cases, both class modes of the port against JAX's batched facade:
    outputs and integer state equal; the facade test's own assertions."""
    (rp, rs), (trp, trs) = _facade_models()
    jhp = JDP(tracker=JTP(pending_cap=8, **_FACADE_TP), num_classes=3)
    thp = DeepSortParams(tracker=TrackerParams(**_FACADE_TP), num_classes=3, class_mode=class_mode)
    rng = np.random.default_rng(1702)
    frame = rng.integers(0, 255, size=(240, 320, 3), dtype=np.uint8)
    jst, tst = j_init(jhp), init_states(thp)
    for t, (b, s, c, v) in enumerate(_facade_case(rng, case)):
        jst, jout = j_deepsort_frame(jst, jnp.asarray(frame), *(jnp.asarray(x) for x in (b, s, c, v)), rp, rs, jhp)
        tst, tout = deepsort_frame(tst, torch.from_numpy(frame), *(torch.from_numpy(x) for x in (b, s, c, v)),
                                   trp, trs, thp)
        _assert_outputs_equal_jax(tout, jout, f"step {t}")
        for name in _INT_LEAVES:
            np.testing.assert_array_equal(getattr(tst, name).numpy(), np.asarray(getattr(jst, name)), err_msg=name)
    if case == "end_to_end":
        mask = tout.mask.numpy()
        assert mask[0].sum() == 1 and mask[2].sum() == 1 and mask[1].sum() == 0
        assert int(tst.next_id[1]) == 1
    else:
        assert int(tst.tsu[0, 0]) == 1 and tout.mask[0].sum() == 1


@pytest.mark.parametrize("route", ["auto", "staged"])
def test_runner_scan_equals_plain_loop(route, monkeypatch):
    """`FrameRunner(hp_scan, hw, "cpu")` (the scan-mode step over the
    runner's static buffers, the graph's body) == the plain loop on every
    state leaf and output, and == the batched runner."""
    if route == "staged":
        monkeypatch.setattr(trk, "FORCE_PALLAS_CASCADE", False)
    hp_scan = _hp()._replace(class_mode="scan")
    runner, runner_bat = tgraph.FrameRunner(hp_scan, OUT_HW, "cpu"), tgraph.FrameRunner(_hp(), OUT_HW, "cpu")
    st_plain, st_run, st_bat = init_states(hp_scan), init_states(hp_scan), init_states(_hp())
    n_out = 0
    for feats, det in _batches(33, frames=32):
        det, feats = _t(det), torch.from_numpy(feats)
        st_plain, out_plain = step_mod.tracker_scan(st_plain, det, feats, hp=hp_scan, src_hw=OUT_HW)
        inp = frame_inputs(feats, det["boxes"], det["scores"], det["classes"], det["valid"], hp_scan)
        st_run, out_run = runner.run(st_run, inp)
        st_bat, out_bat = runner_bat.run(st_bat, inp)
        _assert_trees_equal(out_run, out_plain, "outputs")
        _assert_trees_equal(st_run, st_plain, "state")
        _assert_trees_equal(out_run, out_bat, "scan vs batched outputs")
        n_out += int(out_plain.mask.sum())
    assert n_out > 50


def test_frame_runner_keys_on_class_mode():
    """The runner cache keys on hp, so the class mode is part of the key."""
    step_mod.free_frame_runners()
    try:
        a = step_mod.frame_runner(_hp(), OUT_HW, "cpu")
        b = step_mod.frame_runner(_hp()._replace(class_mode="scan"), OUT_HW, "cpu")
        assert a is not b and b.hp.class_mode == "scan"
        assert step_mod.frame_runner(_hp()._replace(class_mode="scan"), OUT_HW, "cpu") is b
    finally:
        step_mod.free_frame_runners()


def test_unknown_class_mode_raises():
    with pytest.raises(ValueError, match="class_mode"):
        init_states(_hp()._replace(class_mode="vmap"))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["auto", "staged"])
def test_scan_graph_equals_eager_on_card(route, monkeypatch):
    """On the card: the scan-mode frame graph == the eager scan loop ==
    the batched graph on the outputs; K3 launched C times per frame on the
    K2 route, K2 never."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the association kernel is CUDA C++ with no CPU mode")
    from vehicle_counting_tpu_torch.ops import cascade

    if route == "staged":
        monkeypatch.setattr(trk, "FORCE_PALLAS_CASCADE", False)
    hp = _hp()._replace(class_mode="scan")
    outs = {}
    for graph in (False, True):
        monkeypatch.setattr(step_mod, "USE_FRAME_GRAPH", None if graph else False)
        cascade.cascade_match_batched.launches = cascade.cascade_match_classparallel.launches = 0
        st, per = init_states(hp, "cuda"), []
        for feats, det in _batches(34, frames=16):
            det = {k: v.cuda() for k, v in _t(det).items()}
            st, out = step_mod.tracker_scan(st, det, torch.from_numpy(feats).cuda(), hp=hp, src_hw=OUT_HW)
            per.append((TrackerState(*(t.clone() for t in st)), out))
        torch.cuda.synchronize()
        outs[graph] = per
        assert cascade.cascade_match_classparallel.launches == 0
        assert cascade.cascade_match_batched.launches == (0 if route == "staged" else hp.num_classes * 16)
    for (se, oe), (sg, og) in zip(outs[False], outs[True]):
        _assert_trees_equal(og, oe, "graph vs eager outputs")
        _assert_trees_equal(sg, se, "graph vs eager state")
    step_mod.free_frame_runners()
