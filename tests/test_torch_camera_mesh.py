"""PyTorch port, the camera-sharded step (`parallel/cameras.py` over a
`DeviceMesh`): against the JAX `multicam_batch_step` on 'cam' meshes of
the same size (the JAX tests run with 8 CPU devices), and bitwise against
the port's own `mesh=None` step. f32 on the CPU, yolov5n with JAX-seeded
weights converted by `models/convert.py`, B = 2 host-packed I420 frames
(72x128 -> 96x128, content rows) per camera, C = 2 tracked classes, K = 8
slots, two chained batches; in the second, camera 1 is exhausted (all its
frames invalid). The port's CPU mesh repeats the CPU device, so a shard's
device is the CPU and the shards' separation (their own state, their own
frame runner) is what these tests can hold here; the cards run the same
in `chip_smoke.py`."""

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_multicam import FLOAT_ATOL, MARGIN, TRACKER
from test_torch_slice import make_models
from vehicle_counting_tpu.parallel.cameras import multicam_batch_step as j_multicam
from vehicle_counting_tpu.parallel.mesh import make_mesh as j_make_mesh
from vehicle_counting_tpu.tracking import DeepSortParams as JDP
from vehicle_counting_tpu.tracking import TrackerParams as JTP
from vehicle_counting_tpu.tracking import init_states as j_init
from vehicle_counting_tpu_torch import graft_entry
from vehicle_counting_tpu_torch.models.yolo import YoloConfig, decode_predictions, yolov5_forward_nchw
from vehicle_counting_tpu_torch.ops.letterbox import autoshape_hw, content_upload_exact, host_letterbox_yuv420
from vehicle_counting_tpu_torch.ops.letterbox import yuv420_content_to_full, yuv420_to_rgb_u8_planar
from vehicle_counting_tpu_torch.parallel import cameras, make_multicam_step, multicam_batch_step
from vehicle_counting_tpu_torch.parallel import mesh as mesh_mod
from vehicle_counting_tpu_torch.parallel.cameras import camera_params, join_shards, regroup_states
from vehicle_counting_tpu_torch.parallel.mesh import make_mesh
from vehicle_counting_tpu_torch.pipeline import step as step_mod
from vehicle_counting_tpu_torch.tracking import graph as tgraph
from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, init_states
from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams, TrackerState

N_MAX, B, C, K = 8, 2, 2, 8
SRC = (72, 128)


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
    """Weights, two rounds of 8 cameras' I420 batches (a near-static scene
    per camera), a threshold in a gap of every anchor score and a LUT for
    the 2 dominant classes above it."""
    jcfg, jparams, tparams = make_models()
    net = autoshape_hw(SRC, 128)
    exact = content_upload_exact(SRC, net)
    rng = np.random.default_rng(15)
    bases = [np.random.default_rng(60 + i).integers(0, 256, SRC + (3,)).astype(np.int16) for i in range(N_MAX)]
    rounds = []
    for _ in range(2):
        cams = [host_letterbox_yuv420(np.clip(bg + rng.integers(-3, 4, (B,) + SRC + (3,)), 0, 255).astype(np.uint8),
                                      net, content_only=exact) for bg in bases]
        rounds.append(np.stack(cams))
    valid = [np.ones((N_MAX, B), bool), np.ones((N_MAX, B), bool)]
    valid[1][1] = False  # camera 1 ran out of frames
    with torch.no_grad():
        yuv = torch.from_numpy(np.concatenate([r.reshape((-1,) + r.shape[2:]) for r in rounds]))
        rgb = yuv420_to_rgb_u8_planar(yuv420_content_to_full(yuv, SRC, net)).float() / 255.0
        dec = decode_predictions([h.permute(0, 2, 3, 1) for h in yolov5_forward_nchw(tparams[0], rgb)],
                                 YoloConfig("yolov5n", 80))
    s_all, c_all = dec["scores"].numpy().ravel(), dec["classes"].numpy().ravel()
    s = np.sort(np.unique(s_all))[::-1]
    n = 2 * yuv.shape[0]  # ~2 candidates a frame: eight cameras' scores are dense, their gaps narrow at 6
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


def _run_port(world, n_cam, mesh):
    """The port's two chained batches of the first n_cam cameras: [(joined
    state snapshot, joined outputs)] per batch, and the last state as
    returned."""
    _, _, (tp, trp, trs), rounds, valid, lut, kw = world
    hp = _thp()
    states = regroup_states(init_states(camera_params(hp, n_cam)), (n_cam, C))
    got, lut = [], torch.from_numpy(lut)  # the same weight objects every batch, as the pipeline passes them
    with torch.no_grad():
        for frames, v in zip(rounds, valid):
            states, outs = multicam_batch_step(
                mesh, tp, trp, trs, states, torch.from_numpy(frames[:n_cam]), torch.from_numpy(v[:n_cam]),
                lut, ycfg=YoloConfig("yolov5n", 80), hp=hp, dtype=torch.float32, **kw)
            snap = join_shards(states, "cpu")
            got.append((TrackerState(*(x.clone() for x in snap)), join_shards(outs, "cpu")))
    return got, states


def _assert_bitwise(a, b):
    for (sa, oa), (sb, ob) in zip(a, b):
        for name, x, y in zip(sa._fields + oa._fields, tuple(sa) + tuple(oa), tuple(sb) + tuple(ob)):
            assert torch.equal(x, y), name


@pytest.mark.parametrize("n_mesh,n_cam", [(2, 4), (4, 8)])
def test_mesh_step_matches_jax_and_the_unsharded_step(world, n_mesh, n_cam):
    """n_cam cameras over n_mesh shards, two chained batches, camera 1
    exhausted in the second: against JAX's step on a 'cam' mesh of n_mesh
    CPU devices (integer and bool leaves equal, floats within FLOAT_ATOL),
    and bitwise against the port's `mesh=None` step. The state and the
    outputs come back as one tree per shard, each of n_cam / n_mesh
    cameras."""
    jcfg, (yp, rp, rs), _, rounds, valid, lut, kw = world
    mesh = make_mesh(n_mesh, ("cam",), "cpu")
    got, last = _run_port(world, n_cam, mesh)
    assert isinstance(last, tuple) and len(last) == n_mesh
    assert all(s.mean.shape[:2] == (n_cam // n_mesh, C) for s in last)
    _assert_bitwise(got, _run_port(world, n_cam, None)[0])

    jhp = JDP(tracker=JTP(**TRACKER), num_classes=C, min_confidence=0.0)
    jst = jax.tree.map(lambda x: jnp.broadcast_to(x, (n_cam,) + x.shape).copy(), j_init(jhp))
    jmesh = j_make_mesh(n_mesh, axis_names=("cam",))
    tracked = 0
    for (tst, tout), frames, v in zip(got, rounds, valid):
        jst, jout = j_multicam(jmesh, yp, rp, rs, jst, jnp.asarray(frames[:n_cam]), jnp.asarray(v[:n_cam]),
                               jnp.asarray(lut), ycfg=jcfg, hp=jhp, dtype=jnp.float32, **kw)
        assert tout.mask.shape == (n_cam, B, C, K)
        for name, have, want in zip(tst._fields + tout._fields, tuple(tst) + tuple(tout), tuple(jst) + tuple(jout)):
            have, want = have.numpy(), np.asarray(want)
            assert have.shape == want.shape, name
            if np.issubdtype(want.dtype, np.floating):
                np.testing.assert_allclose(have, want, rtol=0, atol=FLOAT_ATOL, err_msg=name)
            else:
                np.testing.assert_array_equal(have, want, err_msg=name)
        tracked += int(np.asarray(jout.mask).sum())
    assert tracked > 0
    for name in ("next_id", "age", "tsu"):  # the exhausted camera did not advance
        assert torch.equal(getattr(got[1][0], name)[1], getattr(got[0][0], name)[1]), name


def test_indivisible_camera_count_raises(world):
    _, _, (tp, trp, trs), rounds, valid, lut, kw = world
    hp = _thp()
    with pytest.raises(ValueError, match="3 cameras do not split over the mesh 'cam' axis of size 2"):
        multicam_batch_step(make_mesh(2, ("cam",), "cpu"), tp, trp, trs,
                            regroup_states(init_states(camera_params(hp, 3)), (3, C)), torch.from_numpy(rounds[0][:3]),
                            torch.from_numpy(valid[0][:3]), torch.from_numpy(lut), ycfg=YoloConfig("yolov5n", 80),
                            hp=hp, dtype=torch.float32, **kw)
    with pytest.raises(ValueError, match="shards for a mesh of 2"):
        multicam_batch_step(make_mesh(2, ("cam",), "cpu"), tp, trp, trs,
                            (regroup_states(init_states(camera_params(hp, 2)), (2, C)),),
                            torch.from_numpy(rounds[0][:4]), torch.from_numpy(valid[0][:4]), torch.from_numpy(lut),
                            ycfg=YoloConfig("yolov5n", 80), hp=hp, dtype=torch.float32, **kw)


def test_weights_are_copied_once_per_device(world, monkeypatch):
    """Two batches over a 4-entry mesh: the weight trees are copied once
    for the one device the CPU mesh repeats, not per shard or per batch
    (`mesh.py::weight_replicas`)."""
    _, _, (tp, trp, trs), _, _, _, _ = world
    copies, real = [], mesh_mod.tree_to
    weights = {id(tp): "yolo", id(trp): "reid", id(trs): "reid_stats"}

    def counted(tree, device):
        if id(tree) in weights:  # a whole tree, not the copy's recursion into it
            copies.append((weights[id(tree)], str(device)))
        return real(tree, device)

    monkeypatch.setattr(mesh_mod, "tree_to", counted)
    make_multicam_step.cache_clear()  # a fresh step: its replicas start empty
    try:
        _run_port(world, 4, make_mesh(4, ("cam",), "cpu"))
    finally:
        make_multicam_step.cache_clear()
    assert sorted(copies) == [("reid", "cpu"), ("reid_stats", "cpu"), ("yolo", "cpu")]


def test_repeated_device_mesh_keeps_each_shards_state(world, monkeypatch):
    """The frame runner (the card's path, run eagerly here) on a mesh that
    repeats its device: each shard replays a runner of its own (slot i),
    hands out that runner's buffers as its state and gets them back
    without a copy; the result is bitwise the unsharded step's. One runner
    for both shards would hand the second shard's state out as the
    first's."""
    loads = []
    load = tgraph.FrameRunner.load_state
    monkeypatch.setattr(step_mod, "use_frame_graph", lambda device: True)
    monkeypatch.setattr(tgraph.FrameRunner, "load_state", lambda self, st: loads.append(self) or load(self, st))
    hp_local = camera_params(_thp(), 2)
    try:
        got, last = _run_port(world, 4, make_mesh(2, ("cam",), "cpu"))
        runners = [step_mod.frame_runner(hp_local, SRC, "cpu", slot) for slot in (0, 1)]
        assert runners[0] is not runners[1]
        assert loads == runners  # each shard's initial state, once; fed back, never again
        for state, runner in zip(last, runners):
            assert all(tgraph._same_memory(a.reshape(b.shape), b) for a, b in zip(state, runner.state))
        want, _ = _run_port(world, 4, None)
    finally:
        step_mod.free_frame_runners()
    _assert_bitwise(got, want)
    assert sum(int(o.mask.sum()) for _, o in got) > 0


def test_one_entry_mesh_returns_one_tree(world):
    got, last = _run_port(world, 3, make_mesh(1, ("cam",), "cpu"))
    assert isinstance(last, TrackerState) and last.mean.shape[:2] == (3, C)
    _assert_bitwise(got, _run_port(world, 3, None)[0])


def test_one_thread_dispatches_the_shards_in_three_passes(world, monkeypatch):
    """Over a mesh of 2: every camera's detector on every shard, then every
    camera's embed (its host read waits only for its card's detectors),
    then every shard's frame scan, all from the caller's thread."""
    import threading

    seen = []

    def recorded(name, fn):
        return lambda *a, **k: seen.append((name, threading.current_thread().name)) or fn(*a, **k)

    for name in ("detect_front", "embed_front", "scan_frame_inputs"):
        monkeypatch.setattr(cameras, name, recorded(name, getattr(cameras, name)))
    make_multicam_step.cache_clear()  # a fresh step: it binds the recorded detector
    try:
        _run_port(world, 4, make_mesh(2, ("cam",), "cpu"))
    finally:
        make_multicam_step.cache_clear()
    assert [n for n, _ in seen] == (["detect_front"] * 4 + ["embed_front"] * 4 + ["scan_frame_inputs"] * 2) * 2
    assert {t for _, t in seen} == {threading.current_thread().name}


def test_join_shards_concatenates_on_the_camera_axis():
    hp = _thp()
    shards = tuple(regroup_states(init_states(camera_params(hp, 2)), (2, C)) for _ in range(3))
    shards[1].next_id.fill_(7)
    joined = join_shards(shards, "cpu")
    assert joined.next_id.shape[:2] == (6, C) and bool((joined.next_id[2:4] == 7).all())
    assert join_shards(shards[0]) is shards[0]


def test_multicam_check_on_a_cpu_mesh():
    """`graft_entry.multicam_check`: two cameras sharded over a 2-entry CPU
    mesh against each camera's serial step, at the production tracker
    shapes."""
    out = graft_entry.multicam_check(make_mesh(2, ("cam",), "cpu"))
    assert out["cameras"] == 2 and out["devices"] == ["cpu", "cpu"]
    assert out["tracks"] > 0 and out["capacity"] == 64


def test_pipeline_over_a_mesh_pads_and_matches_jax_and_serial(tmp_path):
    """`MultiCamCountingPipeline(mesh=<2-entry CPU mesh>)` on 3 ragged videos
    (padded to 4 cameras): the CSVs equal the serial `CountingPipeline`'s
    and the JAX `MultiCamCountingPipeline(mesh=make_mesh(2))`'s, on the
    same seeded checkpoints (test_torch_csv.py's kind), field by field with `color` left out (boxes
    and points within test_torch_csv.py's 1e-3 px)."""
    import ast
    import types

    import vehicle_counting_tpu.configs as jcfg
    import vehicle_counting_tpu_torch.configs as pcfg
    from test_convert_ultralytics import _build_fake_checkpoint
    from test_reid import TorchReidNet
    from test_torch_csv import BOX_ATOL
    from test_torch_multicam_pipeline import _cams
    from vehicle_counting_tpu.pipeline.multicam import MultiCamCountingPipeline as JaxMultiCam
    from vehicle_counting_tpu_torch.pipeline import CountingPipeline
    from vehicle_counting_tpu_torch.pipeline.multicam import MultiCamCountingPipeline

    yolo_pt, _ = _build_fake_checkpoint(tmp_path, np.random.default_rng(1702))
    torch.manual_seed(7)
    net = TorchReidNet()
    reid_t7 = str(tmp_path / "ckpt.t7")
    torch.save({"net_dict": net.state_dict(), "acc": 0.5, "epoch": 3}, reid_t7)
    specs = [("cam_r1", 21, 12), ("cam_r2", 22, 5), ("cam_r3", 23, 9)]
    vids, zones = _cams(tmp_path, specs)

    def configs(mod):
        cfg = mod.config_from_dict(mod.default_config(), {
            "detect_batch": 4, "max_tracks_per_class": 8, "image_size": [96, 96], "model_name": "yolov5n",
            "min_conf": 1e-4, "max_det": 8, "compute_dtype": "float32"})
        cam = mod.default_cam_config().to_dict()
        cam["zone_path"] = zones
        cam["checkpoint"] = reid_t7
        cam["cam"]["default"]["tracking_config"].update({"MIN_CONFIDENCE": 0.0, "N_INIT": 2, "MAX_AGE": 5})
        return cfg, mod.Config(_settings=cam)

    def args(out):
        return types.SimpleNamespace(weight=yolo_pt, input_path=vids, output_path=str(tmp_path / out),
                                     device="cpu", mapping_dict=None, debug=False)

    port = MultiCamCountingPipeline(args("mesh"), *configs(pcfg), mesh=make_mesh(2, ("cam",), "cpu")).run(
        visualize=False)
    serial = CountingPipeline(args("serial"), *configs(pcfg)).run(visualize=False)
    jres = JaxMultiCam(args("jax"), *configs(jcfg), mesh=j_make_mesh(2, axis_names=("cam",))).run(visualize=False)
    assert [r["error"] for r in port] == [None] * 3 and [r["frames"] for r in port] == [n for _, _, n in specs]
    assert all(r.get("csv") for r in serial + jres)
    rows = 0
    for name, _, _ in specs:
        have = pd.read_csv(tmp_path / "mesh" / f"{name}.csv")
        cols = [c for c in have.columns if c != "color"]
        pd.testing.assert_frame_equal(have[cols], pd.read_csv(tmp_path / "serial" / f"{name}.csv")[cols])
        want = pd.read_csv(tmp_path / "jax" / f"{name}.csv")
        assert list(want.columns) == list(have.columns) and len(want) == len(have), name
        for col in ("track_id", "frame_id", "label", "direction", "fframe", "lframe"):
            assert have[col].tolist() == want[col].tolist(), (name, col)
        for col in ("box", "fpoint", "lpoint"):
            got = np.asarray([ast.literal_eval(v) for v in have[col]], np.float64)
            exp = np.asarray([ast.literal_eval(v) for v in want[col]], np.float64)
            np.testing.assert_allclose(got, exp, rtol=0, atol=BOX_ATOL, err_msg=f"{name} {col}")
        rows += len(have)
    assert rows > 0
