"""PyTorch port, kernels K9 and K10 (`ops/track_frame.py`): the tracker's
frame step around the association. On the CPU the new module's entry
points run the plain versions, the op chain's pieces, and
`tracking/deepsort.py::frame_update` through them equals the op chain as
it was composed before the kernels (`_op_chain`) bitwise, over random
states and frames; the launch wrappers refuse what the kernels cannot
take. On the card (marked `cuda`) the kernels against the op chain. No
jax import: on a card run this file with
`python -m pytest --noconftest tests/test_torch_track_frame.py`."""

import numpy as np
import pytest
import torch

from vehicle_counting_tpu_torch.ops import track_frame as tf
from vehicle_counting_tpu_torch.testing import one_torch_thread, tracker_frame_case
from vehicle_counting_tpu_torch.tracking import deepsort as ds
from vehicle_counting_tpu_torch.tracking import tracker as trk
from vehicle_counting_tpu_torch.tracking.tracker import CONFIRMED, TENTATIVE, TrackerOutputs, TrackerState

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

FRAMES = 3  # frames chained per seed: each frame's state feeds the next
INTEGER = ("track_id", "state", "hits", "age", "tsu", "gallery_count", "pending_count", "next_id", "overflow")


def _clone(st):
    return TrackerState(*(t.clone() for t in st))


def _op_chain(states, inp, hp, out_hw):
    """The frame step as PyTorch's op chain was composed before kernels K9
    and K10, through the JAX package's names: `tracker_precompute` for all
    classes; `tracker_step_core` for all classes at once, or class by class
    on [1, ...] slices in class_mode "scan"; `tracker_feature_post` on the
    features normalised anew."""
    h, w = out_hw
    tp = hp.tracker
    pre = trk.tracker_precompute(states, inp.tlwh, inp.feats, inp.valid, tp)
    parts = []
    for one in ([slice(c, c + 1) for c in range(hp.num_classes)] if hp.class_mode == "scan" else [slice(None)]):
        parts.append(trk.tracker_step_core(TrackerState(*(x[one] for x in states)), tuple(p[one] for p in pre),
                                           inp.tlwh[one], inp.scores[one], inp.valid[one], tp, w, h,
                                           inp.present[one], inp.order[one]))
    news, outs, flags = zip(*parts)
    new_st = states._replace(**{f: torch.cat([getattr(n, f) for n in news]) for f in trk.SMALL_FIELDS})
    flags = type(flags[0])(*(torch.cat(leaf) for leaf in zip(*flags)))
    gallery, gallery_count, pending_count = trk.tracker_feature_post(
        states.gallery, states.gallery_count, states.pending_count, flags, trk.l2_normalize(inp.feats), tp)
    return (new_st._replace(gallery=gallery, gallery_count=gallery_count, pending_count=pending_count),
            TrackerOutputs(*(torch.cat(leaf) for leaf in zip(*outs))))


def _assert_equal(got, want, what):
    for name, g, w in zip(type(want)._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what}: {name} {g.dtype} {tuple(g.shape)}"
        assert torch.equal(g, w), f"{what}: {name} differs"


def _next_frame(rng, hp, st, inp):
    """A fresh frame's detections for the state `st` (the case generator's
    inputs over the carried state's classes)."""
    c, k = st.state.shape
    _, _, nxt, _ = tracker_frame_case(rng, c, k, budget=hp.tracker.budget, feat=hp.tracker.feat_dim,
                                      gallery_dtype=hp.tracker.feat_dtype, absent=bool((~inp.present).any()))
    return nxt


def _events(before, after, budget):
    """What a frame did, counted over all classes."""
    was, now = before.state, after.state
    matched = (was > 0) & (after.tsu == 0) & (after.track_id == before.track_id) & (after.hits == before.hits + 1)
    return {
        "matched": int(matched.sum()),
        "deleted_tentative": int(((was == TENTATIVE) & (now == 0)).sum()),
        "expired_confirmed": int(((was == CONFIRMED) & (now == 0)).sum()),
        "initiated": int((after.track_id >= before.next_id[:, None]).sum()),
        "overflow": int((after.overflow - before.overflow).sum()),
        "ring_wrap": int((matched & (before.gallery_count + before.pending_count >= budget)).sum()),
    }


@pytest.mark.parametrize("gallery", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [8, 64])
@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("mode", ["batched", "scan"])
def test_plain_entry_points_equal_the_chain(mode, c, k, gallery):
    """`frame_update` on the CPU (K9's and K10's plain versions around the
    association) == the op chain, bitwise, on every state leaf
    (the gallery included) and every output, over 4 seeds x 3 chained
    frames: matches, deletions of tentative tracks, expiry of confirmed
    ones, initiations, ring wrap of the gallery, and for C = 4 a class
    with no raw detection."""
    seen = {}
    for seed in range(4):
        rng = np.random.default_rng(1000 * c + 10 * k + seed)
        hp, st, inp, hw = tracker_frame_case(rng, c, k, gallery_dtype=gallery)
        hp = hp._replace(class_mode=mode)
        st_chain, st_step = _clone(st), _clone(st)
        for _ in range(FRAMES):
            before = _clone(st_chain)
            st_chain, out_chain = _op_chain(st_chain, inp, hp, hw)
            st_step, out_step = ds.frame_update(st_step, inp, hp, hw)
            _assert_equal(st_step, st_chain, f"state, seed {seed}")
            _assert_equal(out_step, out_chain, f"outputs, seed {seed}")
            for name, n in _events(before, st_chain, hp.tracker.budget).items():
                seen[name] = seen.get(name, 0) + n
            if c > 1:  # the absent class kept its state and output nothing
                assert torch.equal(st_chain.mean[-1], before.mean[-1]) and not out_chain.mask[-1].any()
            inp = _next_frame(rng, hp, st_chain, inp)
    if k == 64:
        for name in ("matched", "deleted_tentative", "expired_confirmed", "initiated", "ring_wrap"):
            assert seen[name] > 0, (name, seen)


@pytest.mark.parametrize("gallery", ["float32", "bfloat16"])
def test_initiation_past_the_free_slots(gallery):
    """Crowded frames: more unmatched detections than free slots, so the
    initiations stop at the last free slot and the rest count as
    overflow; `frame_update` == the op chain, bitwise."""
    rng = np.random.default_rng(7)
    overflow = 0
    for _ in range(3):
        hp, st, inp, hw = tracker_frame_case(rng, 4, 64, gallery_dtype=gallery, crowded=True)
        want_st, want_out = _op_chain(_clone(st), inp, hp, hw)
        got_st, got_out = ds.frame_update(_clone(st), inp, hp, hw)
        _assert_equal(got_st, want_st, "state")
        _assert_equal(got_out, want_out, "outputs")
        overflow += int((want_st.overflow - st.overflow).sum())
        assert bool(((want_st.state == 0).sum(-1)[:-1] == 0).any())  # some class filled every slot
    assert overflow > 0


def test_frame_step_in_place():
    """With `out_state` the state itself and `out` given buffers (what the
    frame runner passes), `frame_update` writes the same values into them
    and returns them."""
    rng = np.random.default_rng(11)
    hp, st, inp, hw = tracker_frame_case(rng, 4, 64, gallery_dtype="bfloat16")
    want_st, want_out = _op_chain(_clone(st), inp, hp, hw)
    mine = _clone(st)
    out = TrackerOutputs(*(torch.empty_like(o) for o in want_out))
    got_st, got_out = ds.frame_update(mine, inp, hp, hw, out_state=mine, out=out)
    assert all(g is m for g, m in zip(got_st, mine)) and all(g is o for g, o in zip(got_out, out))
    _assert_equal(mine, want_st, "state")
    _assert_equal(out, want_out, "outputs")


def test_frame_update_on_the_cpu_is_the_chain(monkeypatch):
    """On CPU tensors `frame_update` runs K9's and K10's plain versions,
    once each, and launches nothing."""
    rng = np.random.default_rng(12)
    hp, st, inp, hw = tracker_frame_case(rng, 4, 64)
    calls = []
    for name in ("track_frame_pre_plain", "track_frame_post_plain"):
        plain = getattr(tf, name)
        monkeypatch.setattr(tf, name, lambda *a, _f=plain, _n=name, **kw: calls.append(_n) or _f(*a, **kw))
    pre, post = tf.track_frame_pre.launches, tf.track_frame_post.launches
    got_st, got_out = ds.frame_update(_clone(st), inp, hp, hw)
    want_st, want_out = _op_chain(_clone(st), inp, hp, hw)
    _assert_equal(got_st, want_st, "state")
    _assert_equal(got_out, want_out, "outputs")
    assert calls == ["track_frame_pre_plain", "track_frame_post_plain"]
    assert (tf.track_frame_pre.launches, tf.track_frame_post.launches) == (pre, post)


def _one_class(st, inp):
    """Class 0 of a [C]-batched case as `tracker_step`'s unbatched
    operands: (state, (tlwh, conf, feat, det_valid), present, det_order)."""
    return (TrackerState(*(t[0] for t in st)), (inp.tlwh[0], inp.scores[0], inp.feats[0], inp.valid[0]),
            inp.present[0], inp.order[0])


def _given_pre(st, inp, tp):
    """`tracker_precompute` for class 0, unbatched: the `pre` a caller of
    `tracker_step` hands in."""
    return tuple(p[0] for p in trk.tracker_precompute(st, inp.tlwh, inp.feats, inp.valid, tp))


@pytest.mark.parametrize("present", [True, False])
@pytest.mark.parametrize("gallery", ["float32", "bfloat16"])
def test_tracker_step_with_a_given_pre(gallery, present):
    """`tracker_step` with a given `pre` (the predict and gated cost) ==
    without it, bitwise, on the CPU: the association's other operands come
    from it and K10's plain version runs; a class not present keeps its
    state and outputs nothing."""
    for seed in range(3):
        hp, st, inp, (h, w) = tracker_frame_case(np.random.default_rng(300 + seed), 1, 64, gallery_dtype=gallery,
                                                 crowded=seed == 2)
        one, dets, _, order = _one_class(st, inp)
        pre = _given_pre(st, inp, hp.tracker)
        want_st, want_out = trk.tracker_step(_clone(one), *dets, hp.tracker, w, h, present=present, det_order=order)
        got_st, got_out = trk.tracker_step(_clone(one), *dets, hp.tracker, w, h, present=present, det_order=order,
                                           pre=pre)
        _assert_equal(got_st, want_st, f"state, seed {seed}")
        _assert_equal(got_out, want_out, f"outputs, seed {seed}")
        if not present:
            assert torch.equal(got_st.mean, one.mean) and not got_out.mask.any()


def _launch_operands(c=2, k=8, budget=4, feat=8, gallery="float32"):
    rng = np.random.default_rng(5)
    hp, st, inp, hw = tracker_frame_case(rng, c, k, budget=budget, feat=feat, gallery_dtype=gallery)
    f_n = trk.l2_normalize(inp.feats)
    sims = trk.gallery_sims(st.gallery, f_n)
    pre = tf.track_frame_pre_plain(st, inp.tlwh, inp.valid, sims, hp.tracker)
    det_free = inp.valid.clone()
    track_col = torch.full((c, k), -1, dtype=torch.int32)
    det_key = inp.order.clone()
    out = TrackerOutputs(torch.empty((c, k, 4), dtype=torch.int32), torch.empty((c, k), dtype=torch.int32),
                         torch.empty((c, k)), torch.empty((c, k), dtype=torch.bool))
    return hp, st, inp, f_n, sims, pre, det_free, track_col, det_key, out, hw


def test_wrappers_refuse_what_the_kernels_cannot_take():
    """The launch wrappers raise before any build or launch, naming the
    operand and its shape: CPU tensors, a wrong dtype, a non-contiguous
    leaf, K past the association's width (the staged route's 1023)."""
    hp, st, inp, f_n, sims, pre, det_free, track_col, det_key, out, (h, w) = _launch_operands()
    tp = hp.tracker

    def pre_call(**kw):
        a = dict(st=st, tlwh=inp.tlwh, det_valid=inp.valid, sims=sims, hp=tp)
        a.update(kw)
        return tf._launch_pre(**a)

    def post_call(**kw):
        a = dict(st=st, pre=pre, tlwh=inp.tlwh, conf=inp.scores, det_valid=inp.valid, present=inp.present, f_n=f_n,
                 det_free=det_free, track_col=track_col, det_key=det_key, hp=tp, width=w, height=h, out_state=st,
                 out=out)
        a.update(kw)
        return tf._launch_post(**a)

    with pytest.raises(ValueError, match="take CUDA tensors, got cpu"):
        pre_call()
    with pytest.raises(ValueError, match="take CUDA tensors, got cpu"):
        post_call()
    with pytest.raises(ValueError, match=r"state.mean must be contiguous torch.float32 \[2, 8, 8\], got "
                                         r"torch.float64 \[2, 8, 8\]"):
        pre_call(st=st._replace(mean=st.mean.double()))
    with pytest.raises(ValueError, match=r"det_valid must be contiguous torch.bool \[2, 8\], got torch.uint8"):
        post_call(det_valid=inp.valid.to(torch.uint8))
    with pytest.raises(ValueError, match=r"track_col must be contiguous torch.int32 \[2, 8\], got torch.int64"):
        post_call(track_col=track_col.long())
    with pytest.raises(ValueError, match=r"tlwh must be contiguous .* \[2, 8, 4\] with strides"):
        pre_call(tlwh=inp.tlwh.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match=r"state.cov must be contiguous .* with strides"):
        post_call(st=st._replace(cov=st.cov.transpose(-1, -2)))
    with pytest.raises(ValueError, match=r"sims must be contiguous torch.float32 \[2, 8, 4, 8\], got "
                                         r"torch.float32 \[2, 32, 8\]"):
        pre_call(sims=sims.reshape(2, 32, 8))
    with pytest.raises(ValueError, match=r"gallery must be contiguous float32 or bfloat16 \[2, 8, budget, F\], "
                                         r"got torch.float16"):
        pre_call(st=st._replace(gallery=st.gallery.half()))
    with pytest.raises(ValueError, match=r"out_state.hits must be contiguous torch.int32 \[2, 8\]"):
        post_call(out_state=st._replace(hits=st.hits[:, :4]))
    with pytest.raises(ValueError, match=r"leaves must carry a class axis \[C, K, ...\], got state \[8\]"):
        pre_call(st=TrackerState(*(t[0] for t in st)))
    # K = 1024: wider than any association route takes
    hp2, wide, winp, _ = tracker_frame_case(np.random.default_rng(6), 1, 1024, budget=1, feat=4)
    wsims = trk.gallery_sims(wide.gallery, trk.l2_normalize(winp.feats))
    with pytest.raises(ValueError, match=r"K = 1024 \(state \[1, 1024\]\) is wider than the association takes "
                                         r"\(K <= 1023\)"):
        tf._launch_pre(wide, winp.tlwh, winp.valid, wsims, hp2.tracker)
    with pytest.raises(ValueError, match="unsupported device meta"):
        tf.track_frame_pre(TrackerState(*(t.to("meta") for t in st)), inp.tlwh, inp.valid, sims, tp)


def test_runner_counts_the_kernels():
    """The frame runner counts K9 and K10 per replay, as it counts K2."""
    from vehicle_counting_tpu_torch.tracking import graph as tgraph

    assert tf.track_frame_pre in tgraph._COUNTED and tf.track_frame_post in tgraph._COUNTED


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernels K9 and K10 are CUDA C++ with no CPU mode")
    return torch.device("cuda", 0)


def _assert_close(got, want, what):
    """Every leaf bitwise equal but mean and cov, which pass through
    kalman.update's contractions and gating_distance's sum (reductions
    whose order the chain leaves to cuBLAS and a reduction kernel): those
    within 1e-5 relative, |a - b| <= 1e-5 |b|, so zeros are exact."""
    for name, g, w in zip(type(want)._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what}: {name} {g.dtype} {tuple(g.shape)}"
        if name in ("mean", "cov"):
            assert bool(((g - w).abs() <= 1e-5 * w.abs()).all()), f"{what}: {name} beyond 1e-5 relative"
        else:
            assert torch.equal(g, w), f"{what}: {name} differs"


@pytest.mark.cuda
@pytest.mark.parametrize("gallery", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["batched", "scan"])
def test_kernels_against_the_chain_on_the_card(mode, gallery):
    """K9 + K10 (`frame_update` on the card) against the op chain on the
    card, over random states: every leaf bitwise but mean and cov, those
    within 1e-5 relative; one launch of each per frame."""
    dev = _card()
    for c, k in ((1, 8), (4, 64)):
        for seed in range(3):
            hp, st, inp, hw = tracker_frame_case(np.random.default_rng(seed), c, k, gallery_dtype=gallery,
                                                 crowded=seed == 2, device=dev)
            hp = hp._replace(class_mode=mode)
            pre, post = tf.track_frame_pre.launches, tf.track_frame_post.launches
            got_st, got_out = ds.frame_update(_clone(st), inp, hp, hw)
            assert (tf.track_frame_pre.launches - pre, tf.track_frame_post.launches - post) == (1, 1)
            want_st, want_out = _op_chain(_clone(st), inp, hp, hw)
            _assert_close(got_st, want_st, f"state C={c} K={k} seed {seed}")
            _assert_close(got_out, want_out, f"outputs C={c} K={k} seed {seed}")


@pytest.mark.cuda
@pytest.mark.parametrize("gallery", ["float32", "bfloat16"])
def test_tracker_step_with_a_given_pre_on_the_card(gallery, monkeypatch):
    """`tracker_step` on the card: without `pre` one launch each of K9 and
    K10, with a given `pre` one of K10 and none of K9; each against the
    same call with K9 and K10 swapped for their plain versions (every leaf
    bitwise but mean and cov, those within 1e-5 relative)."""
    dev = _card()
    for seed in range(3):
        hp, st, inp, (h, w) = tracker_frame_case(np.random.default_rng(300 + seed), 1, 64, gallery_dtype=gallery,
                                                 crowded=seed == 2, device=dev)
        tp = hp.tracker
        one, dets, present, order = _one_class(st, inp)
        for pre in (None, _given_pre(st, inp, tp)):
            def call():
                return trk.tracker_step(_clone(one), *dets, tp, w, h, present=present, det_order=order, pre=pre)

            launches = tf.track_frame_pre.launches, tf.track_frame_post.launches
            got_st, got_out = call()
            assert (tf.track_frame_pre.launches - launches[0], tf.track_frame_post.launches - launches[1]) == (
                int(pre is None), 1)
            with monkeypatch.context() as m:
                for mod in (ds, tf):
                    m.setattr(mod, "track_frame_pre", tf.track_frame_pre_plain)
                    m.setattr(mod, "track_frame_post", tf.track_frame_post_plain)
                want_st, want_out = call()
            what = f"{'given' if pre is not None else 'no'} pre, seed {seed}"
            _assert_close(got_st, want_st, f"state, {what}")
            _assert_close(got_out, want_out, f"outputs, {what}")
