"""PyTorch port, the multi-camera step (`parallel/cameras.py`): against the
JAX `multicam_batch_step` on a one-device 'cam' mesh, and against the
port's own serial `pipeline_batch_step` camera by camera. f32 on the CPU,
yolov5n with JAX-seeded weights converted by `models/convert.py`, 3 cameras
of B = 2 host-packed I420 frames (72x128 -> 96x128, content rows), C = 2
tracked classes, K = 8 slots, two chained batches; in the second, camera 1
is exhausted (all its frames invalid)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_slice import make_models
from vehicle_counting_tpu.models.yolo import YoloConfig as JYoloConfig
from vehicle_counting_tpu.parallel.cameras import make_multicam_step as j_make_step
from vehicle_counting_tpu.parallel.cameras import multicam_batch_step as j_multicam
from vehicle_counting_tpu.parallel.mesh import make_mesh
from vehicle_counting_tpu.tracking import DeepSortParams as JDP
from vehicle_counting_tpu.tracking import TrackerParams as JTP
from vehicle_counting_tpu.tracking import init_states as j_init
from vehicle_counting_tpu_torch.models.yolo import YoloConfig, decode_predictions, yolov5_forward_nchw
from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw, content_upload_exact, host_letterbox_yuv420
from vehicle_counting_tpu_torch.ops.letterbox import yuv420_content_to_full, yuv420_to_rgb_u8_planar
from vehicle_counting_tpu_torch.parallel import make_multicam_step, multicam_batch_step
from vehicle_counting_tpu_torch.parallel.cameras import camera_params, regroup_states
from vehicle_counting_tpu_torch.pipeline import step as step_mod
from vehicle_counting_tpu_torch.tracking import graph as tgraph
from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, init_states
from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams, TrackerState

N_CAM, B, C, K = 3, 2, 2, 8
SRC = (72, 128)
MARGIN = 1e-4
# float state leaves against JAX: the tolerance test_torch_slice.py holds
# boxes to (XLA and PyTorch sum the convolutions in different orders)
FLOAT_ATOL = 1e-3
TRACKER = dict(capacity=K, budget=4, max_age=4, n_init=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small ops, which spin
    8 threads against the other test workers' for nothing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """Weights, two rounds of every camera's I420 batches (a near-static
    scene per camera), a threshold in a gap of every anchor score and a
    LUT for the 2 dominant classes above it."""
    jcfg, jparams, tparams = make_models()
    net = autoshape_hw(SRC, 128)
    exact = content_upload_exact(SRC, net)
    rng = np.random.default_rng(5)
    bases = [np.random.default_rng(40 + i).integers(0, 256, SRC + (3,)).astype(np.int16) for i in range(N_CAM)]
    rounds = []
    for _ in range(2):
        cams = [host_letterbox_yuv420(np.clip(bg + rng.integers(-3, 4, (B,) + SRC + (3,)), 0, 255).astype(np.uint8),
                                      net, content_only=exact) for bg in bases]
        rounds.append(np.stack(cams))
    valid = [np.ones((N_CAM, B), bool), np.ones((N_CAM, B), bool)]
    valid[1][1] = False  # camera 1 ran out of frames
    with torch.no_grad():
        yuv = torch.from_numpy(np.concatenate([r.reshape((-1,) + r.shape[2:]) for r in rounds]))
        rgb = yuv420_to_rgb_u8_planar(yuv420_content_to_full(yuv, SRC, net)).float() / 255.0
        dec = decode_predictions([h.permute(0, 2, 3, 1) for h in yolov5_forward_nchw(tparams[0], rgb)],
                                 YoloConfig("yolov5n", 80))
    s_all, c_all = dec["scores"].numpy().ravel(), dec["classes"].numpy().ravel()
    s = np.sort(np.unique(s_all))[::-1]
    n = 6 * yuv.shape[0]
    gaps = s[n // 3 : 3 * n] - s[n // 3 + 1 : 3 * n + 1]
    i = n // 3 + int(np.argmax(gaps))
    conf = float((s[i] + s[i + 1]) / 2)
    assert np.abs(s_all - conf).min() > MARGIN
    top = np.bincount(c_all[s_all > conf], minlength=80).argsort()[::-1][:C]
    lut = np.full(80, -1, np.int32)
    lut[top] = np.arange(C)
    kw = dict(image_size=net, src_hw=SRC, conf_thres=conf, iou_thres=0.45, max_det=32,
              frames_format="letterboxed_yuv420")
    return jcfg, jparams, tparams, rounds, valid, lut, kw


def _thp():
    return DeepSortParams(tracker=TrackerParams(**TRACKER), num_classes=C, min_confidence=0.0)


def _port_multicam(world):
    """The port's two chained multi-camera batches. Returns [(state snapshot,
    outputs)] per batch and the last state as returned."""
    _, _, (tp, trp, trs), rounds, valid, lut, kw = world
    hp = _thp()
    states = regroup_states(init_states(camera_params(hp, N_CAM)), (N_CAM, C))
    got = []
    with torch.no_grad():
        for frames, v in zip(rounds, valid):
            states, outs = multicam_batch_step(
                None, tp, trp, trs, states, torch.from_numpy(frames), torch.from_numpy(v), torch.from_numpy(lut),
                ycfg=YoloConfig("yolov5n", 80), hp=hp, dtype=torch.float32, **kw)
            got.append((TrackerState(*(x.clone() for x in states)), outs))
    return got, states


def test_multicam_step_matches_jax(world):
    """Two chained batches at mesh size 1, camera 1 exhausted in the
    second: integer / bool state leaves and track outputs (ids, mask,
    boxes) equal, float ones (the Kalman state, the gallery, the scores)
    within FLOAT_ATOL."""
    jcfg, (yp, rp, rs), _, rounds, valid, lut, kw = world
    jhp = JDP(tracker=JTP(**TRACKER), num_classes=C, min_confidence=0.0)
    one = j_init(jhp)
    jst = jax.tree.map(lambda x: jnp.broadcast_to(x, (N_CAM,) + x.shape).copy(), one)
    mesh = make_mesh(1, axis_names=("cam",))
    got, _ = _port_multicam(world)
    tracked = 0
    for (tst, tout), frames, v in zip(got, rounds, valid):
        jst, jout = j_multicam(mesh, yp, rp, rs, jst, jnp.asarray(frames), jnp.asarray(v), jnp.asarray(lut),
                               ycfg=jcfg, hp=jhp, dtype=jnp.float32, **kw)
        assert tout.mask.shape == (N_CAM, B, C, K)
        for name, have, want in zip(tst._fields + tout._fields, tuple(tst) + tuple(tout), tuple(jst) + tuple(jout)):
            have, want = have.numpy(), np.asarray(want)
            assert have.shape == want.shape, name
            if np.issubdtype(want.dtype, np.floating):
                np.testing.assert_allclose(have, want, rtol=0, atol=FLOAT_ATOL, err_msg=name)
            else:
                np.testing.assert_array_equal(have, want, err_msg=name)
        tracked += int(np.asarray(jout.mask).sum())
    assert tracked > 0  # tracks were confirmed and output
    # the exhausted camera did not advance in the second batch
    for name in ("next_id", "age", "tsu"):
        assert torch.equal(getattr(got[1][0], name)[1], getattr(got[0][0], name)[1]), name


@pytest.mark.parametrize("runner", [False, True], ids=["plain_loop", "frame_runner"])
def test_multicam_equals_serial_steps(runner, world, monkeypatch):
    """N_cam = 3, C = 2: the multi-camera step against `pipeline_batch_step`
    per camera (the plain loop), bitwise on every state leaf and output over
    two chained batches. With the frame runner (the card's path, run
    eagerly here) the state it returns is its own buffers seen per camera:
    fed back, it is not copied in (one load, for the initial state)."""
    _, _, (tp, trp, trs), rounds, valid, lut, kw = world
    hp = _thp()
    serial, want = [init_states(hp) for _ in range(N_CAM)], []
    with torch.no_grad():
        for frames, v in zip(rounds, valid):
            outs = []
            for i in range(N_CAM):
                serial[i], _, out = step_mod.pipeline_batch_step(
                    tp, trp, trs, serial[i], torch.from_numpy(frames[i]), torch.from_numpy(v[i]),
                    torch.from_numpy(lut), ycfg=YoloConfig("yolov5n", 80), hp=hp, dtype=torch.float32, **kw)
                outs.append(out)
            want.append(([TrackerState(*(x.clone() for x in s)) for s in serial], outs))

    loads = []
    if runner:
        monkeypatch.setattr(step_mod, "use_frame_graph", lambda device: True)
        load = tgraph.FrameRunner.load_state
        monkeypatch.setattr(tgraph.FrameRunner, "load_state", lambda self, st: loads.append(1) or load(self, st))
    try:
        got, last = _port_multicam(world)
        if runner:
            assert len(loads) == 1
            owned = step_mod.frame_runner(camera_params(hp, N_CAM), SRC, "cpu").state
            assert all(tgraph._same_memory(a.reshape(b.shape), b) for a, b in zip(last, owned))
    finally:
        step_mod.free_frame_runners()
    for (st, outs), (w_states, w_outs) in zip(got, want):
        for i in range(N_CAM):
            for name in TrackerState._fields:
                assert torch.equal(getattr(st, name)[i], getattr(w_states[i], name)), (i, name)
            for name in outs._fields:
                assert torch.equal(getattr(outs, name)[i], getattr(w_outs[i], name)), (i, name)
    assert sum(int(o.mask.sum()) for _, o in got) > 0


def test_regrouped_state_is_a_view_and_keeps_its_generation():
    hp = _thp()
    flat = tgraph.OwnedState(*init_states(camera_params(hp, N_CAM)))
    flat.generation = 3
    per_cam = regroup_states(flat, (N_CAM, C))
    assert per_cam.generation == 3 and per_cam.gallery.shape == (N_CAM, C, K, 4, 512)
    back = regroup_states(per_cam, (N_CAM * C,))
    assert back.generation == 3
    assert all(tgraph._same_memory(a, b) for a, b in zip(back, flat))
    assert not tgraph._same_memory(flat.mean.clone(), flat.mean)


def test_step_builder_is_memoized():
    """The same static config gives the same callable (the JAX package's
    `test_step_builders_are_memoized`, multi-camera half); another config
    another one."""
    kw = dict(ycfg=YoloConfig("yolov5n", 8), hp=DeepSortParams(tracker=TrackerParams(capacity=8), num_classes=2),
              image_size=(96, 96), src_hw=(80, 160))
    assert make_multicam_step(None, **kw) is make_multicam_step(None, **dict(kw, ycfg=YoloConfig("yolov5n", 8)))
    assert make_multicam_step(None, **kw) is not make_multicam_step(None, **kw, dtype=torch.float32)
    jkw = dict(ycfg=JYoloConfig("yolov5n", 8), hp=JDP(tracker=JTP(capacity=8), num_classes=2), image_size=(96, 96), src_hw=(80, 160))
    assert j_make_step(make_mesh(1, axis_names=("cam",)), **jkw) is j_make_step(make_mesh(1, axis_names=("cam",)), **jkw)
