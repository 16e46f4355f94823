"""PyTorch port, serving artifacts (`serving/`): export -> save -> load ->
call, on the CPU (the cases of the JAX package's tests/test_serving.py).

A CPU artifact records no kernels and runs the plain versions; what it
must give is the live port step's outputs array-equal over chained
batches, its config, weights and LUT back from the manifest alone, and
refusals of anything that does not match: a changed file, a newer format,
another source revision, a kernel library of another source, a card
artifact on a host without a card. The whole slice against JAX: the
artifact's pipeline_step on JAX-seeded weights carried by
`models/convert.py` has JAX's `pipeline_batch_step`'s discrete outputs at
f32. yolov5n, 2 tracked classes, K = 8, B = 2 I420 frames of 72x128
(96x128 content rows).
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_framedp import gap_threshold, scene_batches
from test_torch_slice import make_models
from vehicle_counting_tpu.pipeline.step import pipeline_batch_step as j_step
from vehicle_counting_tpu.serving import save_weights_bundle as j_save_weights_bundle
from vehicle_counting_tpu.serving import serving_frames_shape as j_serving_frames_shape
from vehicle_counting_tpu.tracking import DeepSortParams as JDP
from vehicle_counting_tpu.tracking import TrackerParams as JTP
from vehicle_counting_tpu.tracking import init_states as j_init
from vehicle_counting_tpu_torch import _build
from vehicle_counting_tpu_torch.models.convert import reid_params_from_jax, yolo_params_from_jax
from vehicle_counting_tpu_torch.models.yolo import YoloConfig, cast_params
from vehicle_counting_tpu_torch.ops.letterbox import content_upload_exact
from vehicle_counting_tpu_torch.parallel import make_framedp_step, make_mesh, make_multicam_step
from vehicle_counting_tpu_torch.parallel.cameras import camera_params, join_shards, regroup_states
from vehicle_counting_tpu_torch.pipeline.step import detect_only_step, pipeline_batch_step
from vehicle_counting_tpu_torch.serving import (
    ServingArtifact,
    export_detect_step,
    export_framedp_step,
    export_multicam_step,
    export_pipeline_step,
    load_weights_bundle,
    save_artifact,
    save_weights_bundle,
    serving_frames_shape,
)
from vehicle_counting_tpu_torch.serving import artifact as art_mod
from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, init_states
from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams, TrackerState

SRC, NET, B, C = (72, 128), (96, 128), 2, 2
SEED = 5  # the scene's
TRACKER = dict(capacity=8, budget=4, max_age=4, n_init=2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """JAX-seeded yolov5n + ReID weights (both trees), the chained batches
    of one near-static scene, a threshold in a gap of their scores and a
    2-class LUT."""
    jcfg, jparams, tparams = make_models()
    batches = scene_batches(SEED, 3, B)
    conf, lut = gap_threshold(tparams[0], batches)
    kw = dict(image_size=NET, src_hw=SRC, conf_thres=conf, iou_thres=0.45, max_det=16)
    return jcfg, jparams, tparams, lut, kw


def _hp(class_mode="batched"):
    return DeepSortParams(tracker=TrackerParams(**TRACKER), num_classes=C, min_confidence=0.0, max_embed=16,
                          class_mode=class_mode)


def _batches(n_batches=3, n=B):
    """Chained batches of the calibrated scene, as tensors."""
    return [torch.from_numpy(x) for x in scene_batches(SEED, n_batches, n)]


def _snap(states):
    return TrackerState(*(x.clone() for x in states))


def _export_pipeline(tiny, tmp_path, hp, name="art"):
    _, _, (tp, trp, trs), lut, kw = tiny
    exp = export_pipeline_step(tp, trp, trs, ycfg=YoloConfig("yolov5n", 80), hp=hp, batch=B, dtype=torch.float32,
                               **kw)
    return save_artifact(
        str(tmp_path / name), exported={"pipeline_step": exp}, ycfg=YoloConfig("yolov5n", 80), hp=hp, class_lut=lut,
        config=dict(batch=B, src_hw=list(SRC), image_size=list(NET), frames_format="letterboxed_yuv420"),
        weights={"yolo": tp, "reid": trp, "reid_stats": trs})


def test_weights_bundle_roundtrip(tiny, tmp_path):
    """Every leaf back bitwise, bf16 leaves included, in the same tree."""
    _, _, (tp, trp, trs), _, _ = tiny
    trees = {"yolo": cast_params(tp, torch.bfloat16), "reid": trp, "reid_stats": trs}
    path = str(tmp_path / "w.npz")
    save_weights_bundle(path, trees)
    back = load_weights_bundle(path)
    for name, tree in trees.items():
        want, got = art_mod._leaves(tree), art_mod._leaves(back[name])
        assert len(want) == len(got) > 0
        assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(want, got)), name
    assert back["yolo"]["24"]["m"][2]["w"].dtype == torch.bfloat16


def test_jax_bundle_loads_through_the_port(tiny, tmp_path):
    """A bundle written by the JAX package's `save_weights_bundle`, read by
    the port's loader and converted by `models/convert.py`, is the tensors
    `models/convert.py` makes of the live JAX trees."""
    _, (yp, rp, rs), _, _, _ = tiny
    path = str(tmp_path / "jax_w.npz")
    j_save_weights_bundle(path, {"yolo": yp, "reid": rp, "reid_stats": rs})
    back = load_weights_bundle(path)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    got = (yolo_params_from_jax(back["yolo"]),) + reid_params_from_jax(back["reid"], back["reid_stats"])
    want = (yolo_params_from_jax(np_tree(yp)),) + reid_params_from_jax(np_tree(rp), np_tree(rs))
    for g, w in zip(got, want):
        gl, wl = art_mod._leaves(g), art_mod._leaves(w)
        assert len(gl) == len(wl) > 0
        assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(gl, wl))


@pytest.mark.parametrize("fmt", ["raw_rgb", "letterboxed_rgb", "letterboxed_yuv420"])
@pytest.mark.parametrize("geom", [((720, 1280), (384, 640)), ((72, 128), (96, 128)), ((88, 160), (96, 160))])
def test_serving_frames_shape_matches_jax(fmt, geom):
    src, net = geom
    for batch, content_only in ((128, True), (4, False)):
        assert serving_frames_shape(fmt, batch, src, net, content_only) == j_serving_frames_shape(
            fmt, batch, src, net, content_only)
    with pytest.raises(ValueError):
        serving_frames_shape("nope", 1, src, net)


@pytest.mark.parametrize("class_mode", ["batched", "scan"])
def test_pipeline_step_export_matches_live(tiny, tmp_path, class_mode):
    """The loaded artifact's pipeline_step, through its self-contained
    closure, array-equal to the live port step over three chained batches
    (every det and track output, every state leaf); the manifest gives
    back the config, the LUT and the weights."""
    _, _, (tp, trp, trs), lut, kw = tiny
    hp = _hp(class_mode)
    art = ServingArtifact.load(_export_pipeline(tiny, tmp_path, hp))
    step = art.bound_pipeline_step()
    live_st, art_st = init_states(hp), art.init_states()
    tracked = 0
    with torch.no_grad():
        for frames in _batches(3):
            valid = torch.ones(B, dtype=torch.bool)
            live_st, det_l, t_l = pipeline_batch_step(
                tp, trp, trs, live_st, frames, valid, torch.from_numpy(lut), ycfg=YoloConfig("yolov5n", 80), hp=hp,
                dtype=torch.float32, frames_format="letterboxed_yuv420", **kw)
            art_st, det_a, t_a = step(art_st, frames, valid)
            assert sorted(det_l) == sorted(det_a)
            assert all(torch.equal(det_l[k], det_a[k]) for k in det_l)
            assert all(torch.equal(a, b) for a, b in zip(t_l, t_a))
            assert all(torch.equal(a, b) for a, b in zip(live_st, art_st))
            tracked += int(t_a.mask.sum())
    assert tracked > 0
    m = art.manifest
    assert m["functions"]["pipeline_step"]["platforms"] == ["cpu"] and m["functions"]["pipeline_step"]["nr_devices"] == 1
    assert m["kernels"] == {} and m["kernel_modes"] == {"crops": "plain", "cascade": "plain", "reid_epilogue": "plain",
                                                        "track_frame": "plain"}
    assert art.ycfg == YoloConfig("yolov5n", 80) and art.hp == hp
    assert torch.equal(art.class_lut(), torch.from_numpy(lut))
    assert m["source_sha256"] == art_mod.source_sha256() and m["torch_version"] == torch.__version__


def test_artifact_pipeline_step_matches_jax(tiny, tmp_path):
    """The slice as a whole against JAX: two chained batches through the
    CPU artifact and through JAX's live `pipeline_batch_step` at f32, the
    same weights (JAX's, converted) and frames: detections' classes and
    valid, track ids and mask and the integer state leaves equal; boxes
    within 1e-3 px (test_torch_slice.py's bound)."""
    jcfg, (yp, rp, rs), _, lut, kw = tiny
    art = ServingArtifact.load(_export_pipeline(tiny, tmp_path, _hp()))
    step = art.bound_pipeline_step()
    jhp = JDP(tracker=JTP(**TRACKER), num_classes=C, min_confidence=0.0, max_embed=16)
    jst, st, tracked = j_init(jhp), art.init_states(), 0
    for yuv in scene_batches(SEED, 3, B):
        jst, jdet, jout = j_step(yp, rp, rs, jst, jnp.asarray(yuv), jnp.ones(B, bool), jnp.asarray(lut), ycfg=jcfg,
                                 hp=jhp, dtype=jnp.float32, frames_format="letterboxed_yuv420", **kw)
        with torch.no_grad():
            st, det, out = step(st, torch.from_numpy(yuv), torch.ones(B, dtype=torch.bool))
        for k in ("valid", "classes"):
            np.testing.assert_array_equal(det[k].numpy(), np.asarray(jdet[k]), err_msg=k)
        np.testing.assert_allclose(det["boxes"].numpy(), np.asarray(jdet["boxes"]), atol=1e-3, rtol=0)
        for name in ("mask", "ids"):
            np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(jout, name)), err_msg=name)
        np.testing.assert_allclose(out.boxes.numpy(), np.asarray(jout.boxes), atol=1e-3, rtol=0)
        for name, have, want in zip(st._fields, st, jst):
            if not have.is_floating_point():
                np.testing.assert_array_equal(have.numpy(), np.asarray(want), err_msg=name)
        tracked += int(out.mask.sum())
    assert tracked > 0


def test_detect_step_export_matches_live(tiny, tmp_path):
    _, _, (tp, _, _), _, kw = tiny
    exp = export_detect_step(tp, ycfg=YoloConfig("yolov5n", 80), batch=B, dtype=torch.float32, **kw)
    art = ServingArtifact.load(save_artifact(
        str(tmp_path / "det"), exported={"detect_step": exp}, ycfg=YoloConfig("yolov5n", 80),
        config={"batch": B, "src_hw": list(SRC), "image_size": list(NET)}, weights={"yolo": tp}))
    frames = _batches(1)[0]
    with torch.no_grad():
        want = detect_only_step(tp, frames, ycfg=YoloConfig("yolov5n", 80), dtype=torch.float32,
                                content_only=content_upload_exact(SRC, NET), **kw)
        got = art.detect_step(art.load_weights()["yolo"], frames)
    assert int(got["valid"].sum()) > 0
    assert all(torch.equal(want[k], got[k]) for k in want)
    with pytest.raises(ValueError, match="no tracker config"):
        art.hp
    with pytest.raises(ValueError, match="do not match"):  # another batch than the export's
        art.detect_step(tp, frames[:1])


def test_multicam_export_roundtrip(tiny, tmp_path):
    """The one-card multi-camera step, 3 cameras x B: the artifact's
    multicam_step equals the live `make_multicam_step` over two chained
    batches."""
    _, _, (tp, trp, trs), lut, kw = tiny
    hp, n_cam = _hp(), 3
    skw = dict(ycfg=YoloConfig("yolov5n", 80), hp=hp, dtype=torch.float32, frames_format="letterboxed_yuv420", **kw)
    exp = export_multicam_step(tp, trp, trs, n_cameras=n_cam, batch=B, **skw)
    art = ServingArtifact.load(save_artifact(str(tmp_path / "mc"), exported={"multicam_step": exp},
                                             ycfg=YoloConfig("yolov5n", 80), hp=hp))
    live = make_multicam_step(None, **skw)
    fresh = lambda: regroup_states(init_states(camera_params(hp, n_cam)), (n_cam, C))
    st_l, st_a, tracked = fresh(), fresh(), 0
    lut_t = torch.from_numpy(lut)
    scene = _batches(n_cam * 2)  # camera i's batch r is the scene's batch r * n_cam + i
    with torch.no_grad():
        for r in range(2):
            frames, valid = torch.stack(scene[r * n_cam:(r + 1) * n_cam]), torch.ones((n_cam, B), dtype=torch.bool)
            st_l, out_l = live(tp, trp, trs, lut_t, st_l, frames, valid)
            st_l = _snap(st_l)
            st_a, out_a = art.call("multicam_step", tp, trp, trs, lut_t, st_a, frames, valid)
            st_a = _snap(st_a)
            assert all(torch.equal(a, b) for a, b in zip(out_l, out_a))
            assert all(torch.equal(a, b) for a, b in zip(st_l, st_a))
            tracked += int(out_a.mask.sum())
    assert tracked > 0
    assert art.manifest["functions"]["multicam_step"]["in_avals"][4][0][0][:2] == [n_cam, C]


def test_multicam_export_over_a_mesh_roundtrip(tiny, tmp_path):
    """The camera-sharded step over a 2-entry CPU mesh, 4 cameras x B: the
    artifact records 2 devices, rebuilds its mesh at load and equals the
    live step over the same mesh, fed its per-shard states back; 3 cameras
    do not split over 2 devices and the export raises."""
    _, _, (tp, trp, trs), lut, kw = tiny
    hp, n_cam = _hp(), 4
    skw = dict(ycfg=YoloConfig("yolov5n", 80), hp=hp, dtype=torch.float32, frames_format="letterboxed_yuv420", **kw)
    mesh = make_mesh(2, ("cam",), "cpu")
    exp = export_multicam_step(tp, trp, trs, n_cameras=n_cam, batch=B, devices=mesh.devices, **skw)
    art = ServingArtifact.load(save_artifact(str(tmp_path / "mcm"), exported={"multicam_step": exp},
                                             ycfg=YoloConfig("yolov5n", 80), hp=hp))
    assert art.manifest["functions"]["multicam_step"]["nr_devices"] == 2
    live = make_multicam_step(mesh, **skw)
    fresh = lambda: regroup_states(init_states(camera_params(hp, n_cam)), (n_cam, C))
    st_l, st_a, tracked = fresh(), fresh(), 0
    lut_t = torch.from_numpy(lut)
    scene = _batches(n_cam * 2)  # camera i's batch r is the scene's batch r * n_cam + i
    with torch.no_grad():
        for r in range(2):
            frames, valid = torch.stack(scene[r * n_cam:(r + 1) * n_cam]), torch.ones((n_cam, B), dtype=torch.bool)
            st_l, out_l = live(tp, trp, trs, lut_t, st_l, frames, valid)
            st_a, out_a = art.call("multicam_step", tp, trp, trs, lut_t, st_a, frames, valid)
            assert isinstance(st_a, tuple) and len(st_a) == 2
            assert all(torch.equal(a, b) for a, b in zip(join_shards(out_l), join_shards(out_a)))
            assert all(torch.equal(a, b) for a, b in zip(join_shards(st_l), join_shards(st_a)))
            tracked += int(join_shards(out_a).mask.sum())
    assert tracked > 0
    with pytest.raises(ValueError, match="not divisible by 2 devices"):
        export_multicam_step(tp, trp, trs, n_cameras=3, batch=B, devices=mesh.devices, **skw)


def test_framedp_export_roundtrip(tiny, tmp_path):
    """The frame-parallel step on a 2-entry CPU mesh: the artifact records
    2 devices, rebuilds its mesh at load and equals the live step."""
    _, _, (tp, trp, trs), lut, kw = tiny
    hp, b = _hp(), 2 * B
    skw = dict(ycfg=YoloConfig("yolov5n", 80), hp=hp, dtype=torch.float32, frames_format="letterboxed_yuv420", **kw)
    mesh = make_mesh(2, ("frame",), "cpu")
    exp = export_framedp_step(tp, trp, trs, batch=b, devices=mesh.devices, **skw)
    art = ServingArtifact.load(save_artifact(str(tmp_path / "fp"), exported={"framedp_step": exp},
                                             ycfg=YoloConfig("yolov5n", 80), hp=hp))
    assert art.manifest["functions"]["framedp_step"]["nr_devices"] == 2
    live = make_framedp_step(mesh, **skw)
    lut_t = torch.from_numpy(lut)
    st_l, st_a, tracked = init_states(hp), init_states(hp), 0
    with torch.no_grad():
        for frames in _batches(2, b):
            valid = torch.ones(b, dtype=torch.bool)
            st_l, det_l, out_l = live(tp, trp, trs, lut_t, st_l, frames, valid)
            st_l = _snap(st_l)
            st_a, det_a, out_a = art.call("framedp_step", tp, trp, trs, lut_t, st_a, frames, valid)
            st_a = _snap(st_a)
            assert all(torch.equal(det_l[k], det_a[k]) for k in det_l)
            assert all(torch.equal(a, b) for a, b in zip(out_l, out_a))
            assert all(torch.equal(a, b) for a, b in zip(st_l, st_a))
            tracked += int(out_a.mask.sum())
    assert tracked > 0
    with pytest.raises(ValueError, match="not divisible"):
        export_framedp_step(tp, trp, trs, batch=3, devices=mesh.devices, **skw)


def _tamper(art_dir, case):
    """Break one thing of a saved CPU artifact; -> (exception, match)."""
    man_path = os.path.join(art_dir, "manifest.json")
    with open(man_path) as f:
        man = json.load(f)
    if case == "file":
        with open(os.path.join(art_dir, "weights.npz"), "r+b") as f:
            f.seek(200)
            byte = f.read(1)
            f.seek(200)
            f.write(bytes([byte[0] ^ 0xFF]))
        return ValueError, "sha256 mismatch"
    if case == "function":
        with open(os.path.join(art_dir, "pipeline_step.json"), "a") as f:
            f.write(" ")
        return ValueError, "sha256 mismatch"
    if case == "format":
        man["format_version"] = 999
        err = (ValueError, "newer")
    elif case == "source":
        man["source_sha256"] = "0" * 64
        err = (ValueError, "0" * 64 + ".*" + art_mod.source_sha256())
    elif case == "no_card":
        man["export_backend"] = "cuda"  # a card artifact, on a host without a card
        err = (RuntimeError, "no CUDA device")
    else:  # a kernel library of another source, or whose bytes changed
        lib = os.path.join(art_dir, "kernels", f"libcrops_{'f' * 16}.so" if case == "kernel_key"
                           else os.path.basename(_build.library_path("crops")))
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        with open(lib, "wb") as f:
            f.write(b"not a library")
        man["export_backend"] = "cuda"
        man["kernels"] = {"crops": {"file": os.path.relpath(lib, art_dir), "key": "f" * 16,
                                    "sha256": art_mod._file_sha256(lib) if case == "kernel_key" else "0" * 64}}
        err = (ValueError, "not the crops kernel library" if case == "kernel_key" else "sha256 mismatch")
    with open(man_path, "w") as f:
        json.dump(man, f)
    return err


@pytest.mark.parametrize("case", ["file", "function", "format", "source", "no_card", "kernel_key", "kernel_sha"])
def test_artifact_refusals(tiny, tmp_path, case):
    """A changed file, a newer format, another source revision, a card
    artifact without a card, a kernel library of another source or with
    other bytes: each raises at load, and nothing falls back."""
    art_dir = _export_pipeline(tiny, tmp_path, _hp())
    ServingArtifact.load(art_dir)
    exc, match = _tamper(art_dir, case)
    with pytest.raises(exc, match=match):
        ServingArtifact.load(art_dir)


def test_kernel_routes_and_libraries():
    """On the card a step records the routes its configuration takes and
    ships the libraries of their kernels; on the CPU none."""
    from vehicle_counting_tpu_torch.models import reid
    from vehicle_counting_tpu_torch.tracking import tracker

    hp = _hp()
    assert art_mod._kernel_modes(hp, "cuda") == {"crops": "K1", "cascade": "K2", "reid_epilogue": "K8",
                                                 "track_frame": "K9+K10"}
    assert art_mod._kernel_modes(hp._replace(class_mode="scan"), "cuda")["cascade"] == "K3"
    assert art_mod._kernel_modes(hp, "cpu") == {"crops": "plain", "cascade": "plain", "reid_epilogue": "plain",
                                                "track_frame": "plain"}
    big = hp._replace(tracker=TrackerParams(capacity=300))
    assert art_mod._kernel_modes(big, "cuda")["cascade"] == "staged-K4"
    old = reid.FORCE_PALLAS_REID_BLOCK
    reid.FORCE_PALLAS_REID_BLOCK = True
    try:
        modes = art_mod._kernel_modes(hp, "cuda")
    finally:
        reid.FORCE_PALLAS_REID_BLOCK = old
    step = art_mod.ExportedStep(entry="m:f", static={}, in_specs=[], platform="cuda", kernel_modes=modes)
    assert step.kernels == ["cascade", "crops", "reid_block", "reid_epilogue", "track_frame"]
    assert art_mod.ExportedStep(entry="m:f", static={}, in_specs=[], platform="cuda",
                                kernel_modes=art_mod._kernel_modes(big, "cuda")).kernels == ["assignment", "crops",
                                                                                             "reid_epilogue",
                                                                                             "track_frame"]
    assert tracker.FORCE_PALLAS_CASCADE is None
    _build.check_prebuilt("crops", _build.library_path("crops"))
    with pytest.raises(ValueError, match="not the cascade kernel library"):
        _build.check_prebuilt("cascade", _build.library_path("crops"))


def test_cli_export_smoke_verify(tmp_path, capsys):
    """`export` -> `smoke` in this process, then `verify` in a fresh one, at
    the smallest size the flags allow, on the CPU."""
    import subprocess

    from vehicle_counting_tpu_torch.serving.cli import main

    out = str(tmp_path / "cli_art")
    main(["export", "--out", out, "--variant", "yolov5n", "--batch", "2", "--image_size", "96",
          "--src_hw", "80", "160", "--device", "cpu"])
    for name in ("manifest.json", "pipeline_step.json", "detect_step.json", "weights.npz"):
        assert os.path.exists(os.path.join(out, name)), name
    main(["smoke", "--artifact", out, "--batches", "2"])
    smoke = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert smoke["smoke"] == "pipeline_step" and smoke["frames"] == 4
    proc = subprocess.run([sys.executable, "-m", "vehicle_counting_tpu_torch.serving.cli", "verify", "--artifact", out,
                           "--batches", "2"], cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["verify"] == "pipeline_step" and report["bit_exact"] and report["mismatched_arrays"] == 0
    assert report["backend"] == "cpu" and report["kernels_from"] == {} and report["card"] is None
    shutil.rmtree(out)
    main(["export", "--out", out, "--variant", "yolov5n", "--batch", "2", "--image_size", "96",
          "--src_hw", "80", "160", "--device", "cpu", "--detect_only"])
    main(["smoke", "--artifact", out, "--batches", "1"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["smoke"] == "detect_step"
