"""PyTorch port, the frame scan's launch path: `tracking/graph.py::FrameRunner`
(the per-frame tracker step over static buffers; eager here, a CUDA graph on
the card) against the plain `tracker_scan` loop and against the JAX
`tracker_scan` (`lax.scan`), the staged route's fixed stage schedule, the
fused stage's plain version against the JAX `_match_stage`, kernel K2's new
interface, and `CountingPipeline.frames_done`. Bitwise unless said."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_pipeline import N_FRAMES, _synthetic_video, fake_pipeline_batch_step
from test_torch_tracking import NAMES, _scenario
from vehicle_counting_tpu.configs import Config, config_from_dict, default_cam_config, default_config
from vehicle_counting_tpu.pipeline.step import tracker_scan as j_scan
from vehicle_counting_tpu.tracking import tracker as jtrk
from vehicle_counting_tpu.tracking.deepsort import DeepSortParams as JDP
from vehicle_counting_tpu.tracking.deepsort import init_states as j_init
from vehicle_counting_tpu.tracking.tracker import TrackerParams as JTP
from vehicle_counting_tpu_torch.ops import assignment as tasg
from vehicle_counting_tpu_torch.ops import cascade as tcas
from vehicle_counting_tpu_torch.pipeline import CountingPipeline
from vehicle_counting_tpu_torch.pipeline import step as step_mod
from vehicle_counting_tpu_torch.testing import association_problem, one_torch_thread
from vehicle_counting_tpu_torch.tracking import graph as tgraph
from vehicle_counting_tpu_torch.tracking import tracker as trk
from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, frame_inputs, init_states
from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams, TrackerState

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

OUT_HW = (260, 300)
C, K, MAX_AGE, FEAT = 3, 12, 3, 32


def _hp(k=K, c=C, max_age=MAX_AGE, feat=FEAT, budget=6):
    return DeepSortParams(tracker=TrackerParams(capacity=k, max_age=max_age, n_init=3, feat_dim=feat, budget=budget),
                          num_classes=c)


def _batches(seed, frames=48, batch=8, c=C, feat=FEAT, absent=(14, 24)):
    """`_scenario` in batches of `batch` frames as numpy (feats, det dict).
    Objects are born, missed (15 % per frame) and, with MAX_AGE = 3, deleted;
    class 2 has no raw detection in frames [absent), so it does not advance."""
    fr = _scenario(seed, frames=frames, c=c, feat=feat)
    out = []
    for s in range(0, frames, batch):
        feats, boxes, scores, classes, valid = (np.stack(x) for x in zip(*fr[s : s + batch]))
        for i in range(batch):
            if absent[0] <= s + i < absent[1]:
                valid[i] &= classes[i] != 2
        out.append((feats, {"boxes": boxes, "scores": scores, "classes": classes, "valid": valid}))
    return out


def _t(det):
    return {k: torch.from_numpy(v) for k, v in det.items()}


def _assert_trees_equal(got, want, what):
    for name, g, w in zip(type(want)._fields, got, want):
        assert torch.equal(g, w), f"{what}: {name} differs"


@pytest.mark.parametrize("route", ["auto", "staged"])
def test_runner_eager_equals_plain_loop(route, monkeypatch):
    """The runner's static-buffer logic == the plain per-frame loop on every
    state leaf and output, over 48 seeded frames in 6 batches, with births,
    misses, deletions and a class absent for ten frames."""
    if route == "staged":
        monkeypatch.setattr(trk, "FORCE_PALLAS_CASCADE", False)
    hp = _hp()
    runner = tgraph.FrameRunner(hp, OUT_HW, "cpu")
    assert runner.graph is None  # no graph on the CPU
    st_plain, st_run = init_states(hp), init_states(hp)
    n_out, ids_seen, deleted = 0, set(), 0
    for feats, det in _batches(30):
        det, feats = _t(det), torch.from_numpy(feats)
        prev_state = st_plain.state.clone()
        st_plain, out_plain = step_mod.tracker_scan(st_plain, det, feats, hp=hp, src_hw=OUT_HW)
        inp = frame_inputs(feats, det["boxes"], det["scores"], det["classes"], det["valid"], hp)
        st_run, out_run = runner.run(st_run, inp)
        _assert_trees_equal(out_run, out_plain, "outputs")
        _assert_trees_equal(st_run, st_plain, "state")
        n_out += int(out_plain.mask.sum())
        ids_seen |= set(out_plain.ids[out_plain.mask].tolist())
        deleted += int(((prev_state > 0) & (st_plain.state == 0)).sum())
    assert n_out > 100 and len(ids_seen) > 5 and deleted > 0  # the scenario really tracks, and deletes
    assert int(st_plain.next_id.max()) > 5


@pytest.mark.parametrize("mode", ["staged", "pallas_interpret"])
def test_runner_matches_jax_tracker_scan(mode, monkeypatch):
    """Against the JAX frame scan (`lax.scan` inside `jit`), on its staged
    route and through its Pallas cascade kernel in interpret mode: ids,
    mask and the integer state exactly, boxes atol 1e-4, scores 1e-6,
    Kalman means to f32 rounding (rtol 1e-4, atol 1e-3)."""
    monkeypatch.setattr(jtrk, "FORCE_PALLAS_CASCADE", mode == "pallas_interpret")
    frames, batch, c, k = (16, 8, 2, 8) if mode == "pallas_interpret" else (40, 8, C, K)
    hp = _hp(k=k, c=c)
    jhp = JDP(tracker=JTP(capacity=k, max_age=MAX_AGE, n_init=3, feat_dim=FEAT, budget=6), num_classes=c)
    jscan = jax.jit(lambda st, det, feats: j_scan(st, det, feats, hp=jhp, src_hw=OUT_HW))
    runner = tgraph.FrameRunner(hp, OUT_HW, "cpu")
    jst, tst = j_init(jhp), init_states(hp)
    n_out = 0
    for feats, det in _batches(31, frames=frames, batch=batch, c=c, absent=(4, 9)):
        jst, jo = jscan(jst, {k_: jnp.asarray(v) for k_, v in det.items()}, jnp.asarray(feats))
        td, tf = _t(det), torch.from_numpy(feats)
        tst, to = runner.run(tst, frame_inputs(tf, td["boxes"], td["scores"], td["classes"], td["valid"], hp))
        np.testing.assert_array_equal(to.mask.numpy(), np.asarray(jo.mask))
        np.testing.assert_array_equal(to.ids.numpy(), np.asarray(jo.ids))
        np.testing.assert_allclose(to.boxes.numpy(), np.asarray(jo.boxes), atol=1e-4)
        np.testing.assert_allclose(to.scores.numpy(), np.asarray(jo.scores), atol=1e-6)
        for name in ("track_id", "state", "hits", "age", "tsu", "gallery_count", "pending_count", "next_id"):
            np.testing.assert_array_equal(getattr(tst, name).numpy(), np.asarray(getattr(jst, name)), err_msg=name)
        np.testing.assert_allclose(tst.mean.numpy(), np.asarray(jst.mean), rtol=1e-4, atol=1e-3)
        n_out += int(np.asarray(jo.mask).sum())
    assert n_out > 10


def test_runner_copies_a_foreign_state_in_and_keeps_its_own():
    """A state the runner does not own is copied in and left untouched (the
    plain loop updates its gallery in place); the state the runner returns
    is fed back without a copy; a state from before another load raises."""
    hp = _hp()
    (feats, det), (feats2, det2) = _batches(32, frames=16)
    inp = frame_inputs(torch.from_numpy(feats), *(_t(det)[n] for n in ("boxes", "scores", "classes", "valid")), hp)
    inp2 = frame_inputs(torch.from_numpy(feats2), *(_t(det2)[n] for n in ("boxes", "scores", "classes", "valid")), hp)
    runner = tgraph.FrameRunner(hp, OUT_HW, "cpu")
    mine = init_states(hp)
    mine.gallery.fill_(0.25)
    before = TrackerState(*(t.clone() for t in mine))
    loads = []
    load_state = runner.load_state
    runner.load_state = lambda st: loads.append(1) or load_state(st)
    st1, out1 = runner.run(mine, inp)
    _assert_trees_equal(mine, before, "the caller's state")
    assert all(a is not b for a, b in zip(st1, mine)) and len(loads) == 1
    assert not torch.equal(st1.gallery, before.gallery)  # the runner's own gallery moved on
    st2, _ = runner.run(st1, inp2)
    assert len(loads) == 1  # its own state: nothing copied
    # the same two batches from a fresh state through the plain loop
    ref = TrackerState(*(t.clone() for t in before))
    ref, ref_out1 = step_mod.tracker_scan(ref, _t(det), torch.from_numpy(feats), hp=hp, src_hw=OUT_HW)
    _assert_trees_equal(out1, ref_out1, "outputs")
    ref, _ = step_mod.tracker_scan(ref, _t(det2), torch.from_numpy(feats2), hp=hp, src_hw=OUT_HW)
    _assert_trees_equal(st2, ref, "state after two batches")
    # outputs are the caller's: a later run does not write into them
    kept = out1.ids.clone()
    runner.run(init_states(hp), inp2)
    assert torch.equal(out1.ids, kept) and len(loads) == 2
    with pytest.raises(RuntimeError, match="handed out"):
        runner.run(st2, inp)  # st2's buffers now hold the other caller's state


def test_runner_takes_a_rewrapped_state_as_its_own():
    """The current state re-wrapped (`TrackerState(*st)`) is the buffers
    still: nothing is copied. With one leaf replaced it is copied in leaf by
    leaf, the replaced leaf included. Another runner's state is foreign."""
    hp = _hp()
    (feats, det), (feats2, det2) = _batches(34, frames=16)
    inp = frame_inputs(torch.from_numpy(feats), *(_t(det)[n] for n in ("boxes", "scores", "classes", "valid")), hp)
    inp2 = frame_inputs(torch.from_numpy(feats2), *(_t(det2)[n] for n in ("boxes", "scores", "classes", "valid")), hp)
    runner = tgraph.FrameRunner(hp, OUT_HW, "cpu")
    loads = []
    load_state = runner.load_state
    runner.load_state = lambda st: loads.append(1) or load_state(st)
    st1, _ = runner.run(init_states(hp), inp)
    assert isinstance(st1, TrackerState) and len(loads) == 1
    st2, _ = runner.run(TrackerState(*st1), inp2)
    assert len(loads) == 1
    ref, _ = step_mod.tracker_scan(init_states(hp), _t(det), torch.from_numpy(feats), hp=hp, src_hw=OUT_HW)
    ref, _ = step_mod.tracker_scan(ref, _t(det2), torch.from_numpy(feats2), hp=hp, src_hw=OUT_HW)
    _assert_trees_equal(st2, ref, "state after a re-wrapped hand-back")
    bumped = st2._replace(next_id=st2.next_id + 100)
    st3, _ = runner.run(bumped, inp)
    assert len(loads) == 2
    ref, _ = step_mod.tracker_scan(ref._replace(next_id=ref.next_id + 100), _t(det), torch.from_numpy(feats),
                                   hp=hp, src_hw=OUT_HW)
    _assert_trees_equal(st3, ref, "state after a replaced leaf")
    other = tgraph.FrameRunner(hp, OUT_HW, "cpu")
    st4, _ = other.run(st3, inp2)  # st3 belongs to `runner`: foreign here, whatever its generation
    ref, _ = step_mod.tracker_scan(ref, _t(det2), torch.from_numpy(feats2), hp=hp, src_hw=OUT_HW)
    _assert_trees_equal(st4, ref, "state through another runner")
    assert all(a is not b for a, b in zip(st4, st3))


def test_warmup_on_scratch_state_does_not_leak():
    """The warm-up steps a capture needs run on the runner's scratch state
    and DO change its gallery in place; a run afterwards starts from the
    caller's state all the same."""
    hp = _hp()
    feats, det = _batches(33, frames=8)[0]
    td, tf = _t(det), torch.from_numpy(feats)
    inp = frame_inputs(tf, td["boxes"], td["scores"], td["classes"], td["valid"], hp)
    runner = tgraph.FrameRunner(hp, OUT_HW, "cpu")
    for dst, src in zip(runner.inp, inp):
        dst.copy_(src[0])
    for _ in range(tgraph._WARMUP_STEPS):
        runner._body()
    assert float(runner.state.gallery.abs().sum()) > 0 and int(runner.state.next_id.max()) > 1
    st, out = runner.run(init_states(hp), inp)
    ref, ref_out = step_mod.tracker_scan(init_states(hp), td, tf, hp=hp, src_hw=OUT_HW)
    _assert_trees_equal(out, ref_out, "outputs")
    _assert_trees_equal(st, ref, "state")


def test_frame_graph_flag(monkeypatch):
    """None: on for CUDA tensors, never for the CPU; False: the eager loop."""
    assert step_mod.USE_FRAME_GRAPH is None
    assert not step_mod.use_frame_graph("cpu") and step_mod.use_frame_graph("cuda:0")
    monkeypatch.setattr(step_mod, "USE_FRAME_GRAPH", True)
    assert not step_mod.use_frame_graph(torch.device("cpu"))
    monkeypatch.setattr(step_mod, "USE_FRAME_GRAPH", False)
    assert not step_mod.use_frame_graph("cuda")


def test_frame_runner_cache_keys_on_route(monkeypatch):
    hp = _hp()
    step_mod.free_frame_runners()
    built = []
    monkeypatch.setattr(step_mod, "FrameRunner", lambda *a: built.append(a) or object())
    a = step_mod.frame_runner(hp, OUT_HW, "cpu")
    assert step_mod.frame_runner(hp, OUT_HW, "cpu") is a and len(built) == 1
    monkeypatch.setattr(trk, "FORCE_PALLAS_CASCADE", False)
    assert step_mod.frame_runner(hp, OUT_HW, "cpu") is not a and len(built) == 2
    assert step_mod.frame_runner(_hp(max_age=5), OUT_HW, "cpu") is not a and len(built) == 3
    step_mod.free_frame_runner(hp, OUT_HW, "cpu")  # this configuration's, on both routes; no other
    assert len(step_mod._RUNNERS) == 1
    assert step_mod.frame_runner(_hp(max_age=5), OUT_HW, "cpu") is not a and len(built) == 3
    step_mod.free_frame_runners()
    assert not step_mod._RUNNERS


@pytest.mark.parametrize("kind", ["random", "ties", "empty"])
def test_fixed_stage_schedule_equals_data_dependent(kind, monkeypatch):
    """min(max_age, K) cascade stages always (the card's schedule, no host
    read) == only the occupied levels (the CPU's)."""
    k, c, max_age = 12, 4, 5
    hp = TrackerParams(capacity=k, max_age=max_age)
    rng = np.random.default_rng({"random": 40, "ties": 41, "empty": 42}[kind])
    for _ in range(6):
        pr = association_problem(rng, c, k, max_age, kind)
        args = [torch.from_numpy(pr[n]) for n in NAMES]
        fixed = trk._associate_staged(*args, hp, fixed_schedule=True)
        dyn = trk._associate_staged(*args, hp, fixed_schedule=False)
        for f, d in zip(fixed, dyn):
            assert torch.equal(f, d)
    calls = []
    stage = trk.match_stage_batched
    monkeypatch.setattr(trk, "match_stage_batched", lambda *a: calls.append(1) or stage(*a))
    trk._associate_staged(*args, hp, fixed_schedule=True)
    assert len(calls) == min(max_age, k) + 1


@pytest.mark.parametrize("kind", ["random", "ties", "empty"])
def test_match_stage_plain_equals_jax_stage_by_stage(kind):
    """The fused stage's plain version against the JAX `_match_stage`, class
    by class, chained over cascade levels 0 and 1 and the IoU stage; the
    det keys are offset past 2^22 (any int32 key must do)."""
    k, c, max_age = 12, 4, 5
    rng = np.random.default_rng({"random": 43, "ties": 44, "empty": 45}[kind])
    jstage = jax.jit(jtrk._match_stage, static_argnums=(4,))
    for _ in range(4):
        pr = association_problem(rng, c, k, max_age, kind)
        pr["det_order"] = pr["det_order"] + (1 << 23)
        t = {n: torch.from_numpy(pr[n]) for n in NAMES}
        det_free, det_key = t["det_valid"].clone(), t["det_order"].clone()
        track_col = torch.full((c, k), -1, dtype=torch.int32)
        j = [(pr["det_valid"][ci], np.full(k, -1, np.int32), pr["det_order"][ci]) for ci in range(c)]
        stages = [("gated", pr["lvl_of"] == lv, 0.2, "track_id", 1 + lv) for lv in (0, 1)]
        for name, rows, thr, order, base in stages + [("iou", None, 0.6, "iou_order", 1 + max_age)]:
            if rows is None:
                rows = pr["tentative"] | ((pr["lvl_of"] == 0) & (track_col.numpy() < 0))
            det_free, track_col, det_key = tasg.match_stage_plain(
                t[name], torch.from_numpy(rows), det_free, track_col, thr, t[order], det_key,
                torch.full((c,), base, dtype=torch.int32))
            for ci in range(c):
                jf, jcol, jkey = j[ci]
                j[ci] = tuple(np.asarray(x) for x in jstage(
                    jnp.asarray(pr[name][ci]), jnp.asarray(rows[ci]), jnp.asarray(jf), jnp.asarray(jcol), thr,
                    jnp.asarray(pr[order][ci]), jnp.asarray(jkey), jnp.int32(base)))
                np.testing.assert_array_equal(det_free[ci].numpy(), j[ci][0])
                np.testing.assert_array_equal(track_col[ci].numpy(), j[ci][1])
                np.testing.assert_array_equal(det_key[ci].numpy(), j[ci][2])


@pytest.mark.parametrize("k,hi", [(16, 10), (12, 13), (40, 41)])
def test_stage_problems_batched_plain_equals_one_class_plain(k, hi):
    """The chip check's seeded stages (normal, flipped, empty, all-rejected,
    keys past 2^22): the batched plain stage == the one-class stage of
    `ops/cascade.py` (Python control flow, its own compaction), class by
    class; a class with an empty side is left as it was."""
    from vehicle_counting_tpu_torch.testing import stage_problems

    n = 24
    pr = stage_problems(np.random.default_rng(50 + k), n, k, hi)
    t = {name: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for name, v in pr.items()}
    assert int(t["det_key"].min()) >= 1 << 22
    free, col, key = tasg.match_stage_batched(**t)
    kinds = set()
    for i in range(n):
        nr, nc = int(pr["rows"][i].sum()), int(pr["det_free"][i].sum())
        kinds.add("empty" if min(nr, nc) == 0 else "flipped" if nr > nc else "normal")
        f1, c1, k1 = tcas._match_stage(t["cost"][i], t["rows"][i], t["det_free"][i], t["track_col"][i], 0.2,
                                       t["row_order"][i], t["det_key"][i], int(pr["stage_base"][i]))
        assert torch.equal(free[i], f1) and torch.equal(col[i], c1) and torch.equal(key[i], k1), i
        if min(nr, nc) == 0:
            assert torch.equal(col[i], t["track_col"][i]) and torch.equal(key[i], t["det_key"][i])
    assert kinds >= {"normal", "flipped"}
    assert torch.equal(free[0], t["det_free"][0])  # problem 0 is all above the threshold: nothing accepted


def test_cascade_wrapper_checks_dtypes_and_fills_out():
    """K2's wrapper casts nothing: a wrong dtype raises, and so does K past
    the kernel's width; the outputs come in the dtypes the tracker reads,
    track_col the inverse of out_row."""
    pr = association_problem(np.random.default_rng(46), 3, 8, 4, "random")
    args = [torch.from_numpy(pr[n]) for n in NAMES]
    bad = list(args)
    bad[2] = bad[2].long()
    with pytest.raises(ValueError, match="lvl_of must be contiguous torch.int32"):
        tcas._launch(*bad, 0.2, 0.6, 4)
    bad = list(args)
    bad[6] = bad[6].to(torch.int32)
    with pytest.raises(ValueError, match="det_valid must be contiguous torch.bool"):
        tcas._launch(*bad, 0.2, 0.6, 4)
    big = tcas.MAX_K + 1
    with pytest.raises(ValueError, match=f"K <= {tcas.MAX_K}"):
        tcas._launch(torch.zeros((1, big, big)), torch.zeros((1, big, big)),
                     *(torch.zeros((1, big), dtype=a.dtype) for a in args[2:]), 0.2, 0.6, 4)
    got = tcas.cascade_match_classparallel(*args, 0.2, 0.6, max_age=4)
    assert isinstance(got, tcas.CascadeOut)
    assert got.det_free.dtype == torch.bool and got.track_col.dtype == torch.int32
    assert got.det_key.dtype == torch.int32 and got.out_row.dtype == torch.int32
    for ci in range(3):
        col = got.track_col[ci]
        m = col >= 0
        assert torch.equal(got.out_row[ci][col[m].long()], torch.nonzero(m).flatten().to(torch.int32))
        assert int((got.out_row[ci] >= 0).sum()) == int(m.sum())


def test_match_stage_wrapper_checks_operands():
    c, k = 2, 8
    z = torch.zeros((c, k), dtype=torch.int32)
    ok = dict(cost=torch.zeros((c, k, k)), rows=z.bool(), det_free=z.bool(), track_col=z.clone(), threshold=0.2,
              row_order=z, det_key=z.clone(), stage_base=torch.ones(c, dtype=torch.int32))
    for name, value, msg in (("rows", z, "rows must be contiguous torch.bool"),
                             ("det_key", z.long(), "det_key must be contiguous torch.int32"),
                             ("stage_base", torch.ones(c, dtype=torch.int64), "stage_base must be contiguous int32"),
                             ("cost", torch.zeros((c, k, k), dtype=torch.float64), "cost must be contiguous float32")):
        with pytest.raises(ValueError, match=msg):
            tasg._launch_stage(**{**ok, name: value})
    big = tasg.MAX_S + 1
    with pytest.raises(ValueError, match=f"K <= {tasg.MAX_S}"):
        tasg._launch_stage(**{**ok, "cost": torch.zeros((1, big, big))})


def test_frames_done_is_published(tmp_path, monkeypatch):
    """`run_video` resets `frames_done` and sets it after every drained
    batch (40 frames in batches of 16: a batch is drained one step late)."""
    video_path, zone_dir = _synthetic_video(tmp_path)
    cfg = config_from_dict(default_config(), {
        "detect_batch": 16, "max_tracks_per_class": 16, "image_size": [160, 160],
        "model_name": "yolov5n", "compute_dtype": "float32",
    })
    cam = default_cam_config().to_dict()
    cam["zone_path"] = zone_dir
    args = types.SimpleNamespace(weight=None, input_path=video_path, output_path=str(tmp_path / "out"), device="cpu",
                                 mapping_dict={0: 0, 1: 0, 2: 1, 3: 0, 5: 2, 7: 3}, check_numerics=True)
    pipe = CountingPipeline(args, cfg, Config(_settings=cam))
    assert pipe.frames_done == 0
    pipe.frames_done = 999
    seen = []

    def step(*a, **kw):
        seen.append(pipe.frames_done)
        return fake_pipeline_batch_step(*a, **kw)

    monkeypatch.setattr(step_mod, "pipeline_batch_step", step)
    result = pipe.run_video(video_path, visualize=False)
    assert seen == [0, 0, 16]
    assert pipe.frames_done == result["frames"] == N_FRAMES


def _cuda_scan(states, batches, hp, graph):
    old = step_mod.USE_FRAME_GRAPH
    step_mod.USE_FRAME_GRAPH = None if graph else False
    try:
        outs = []
        for feats, det in batches:
            det = {k: v.cuda() for k, v in _t(det).items()}
            states, out = step_mod.tracker_scan(states, det, torch.from_numpy(feats).cuda(), hp=hp, src_hw=OUT_HW)
            outs.append(TrackerState(*(t.clone() for t in states)) + tuple(out))
        return outs
    finally:
        step_mod.USE_FRAME_GRAPH = old


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["auto", "staged"])
def test_graph_equals_eager_on_card(route, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph and the association kernels exist only on the card")
    if route == "staged":
        monkeypatch.setattr(trk, "FORCE_PALLAS_CASCADE", False)
    hp = _hp()
    batches = _batches(34)
    step_mod.free_frame_runners()
    eager = _cuda_scan(init_states(hp, "cuda"), batches, hp, graph=False)
    graph = _cuda_scan(init_states(hp, "cuda"), batches, hp, graph=True)
    step_mod.free_frame_runners()
    for e, g in zip(eager, graph):
        for a, b in zip(e, g):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_new_kernel_entries_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the association kernels are CUDA C++ with no CPU mode")
    rng = np.random.default_rng(47)
    for k, max_age in ((64, 30), (320, 4)):
        hp = TrackerParams(capacity=k, max_age=max_age)
        for kind in ("random", "ties", "empty"):
            pr = association_problem(rng, 4, k, max_age, kind)
            pr["det_order"] = pr["det_order"] + (1 << 23)
            cpu = [torch.from_numpy(pr[n]) for n in NAMES]
            got = trk._associate_staged(*(x.cuda() for x in cpu), hp)
            want = trk._associate_staged(*cpu, hp)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)
    pr = association_problem(rng, 4, 64, 30, "random")
    cpu = [torch.from_numpy(pr[n]) for n in NAMES]
    gpu = [x.cuda() for x in cpu]
    want = tcas.cascade_match_classparallel(*cpu, 0.2, 0.6, max_age=30)
    for g, w in zip(tcas.cascade_match_classparallel(*gpu, 0.2, 0.6, max_age=30), want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
