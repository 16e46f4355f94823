"""PyTorch port: the JAX package's public names, used on the port as JAX's
own code uses them, on the same numpy inputs as JAX.

- The two A/B switches, set by JAX's names: `tracker.FORCE_PALLAS_CASCADE
  = False` takes the staged route (and equals JAX's step under the same
  switch), `reid.FORCE_PALLAS_REID_BLOCK = True` takes the fused block.
- `TrackerParams` has JAX's fields, `pending_cap` among them.
- The converters under JAX's names (`yolov5_state_dict_to_pytree`,
  `reid_state_dict_to_pytree`), `oihw_to_hwio`, `IMAGENET_MEAN` /
  `IMAGENET_STD` and `conv2d` with JAX's call.

Tolerances: the tracker's integer state and outputs exactly, boxes and
scores as `test_torch_class_scan.py` holds them; the fused block within
1e-4 of the cuDNN / oneDNN route at f32, as K5's tests hold it; the
converters bitwise; `conv2d` within 1e-5 at f32."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vehicle_counting_tpu.models import convert as jconvert
from vehicle_counting_tpu.models import layers as jlayers
from vehicle_counting_tpu.models import reid as jreid
from vehicle_counting_tpu.tracking import tracker as jtrk
from vehicle_counting_tpu_torch.models import reid as treid
from vehicle_counting_tpu_torch.models.convert import reid_params_from_jax, yolo_params_from_jax
from vehicle_counting_tpu_torch.testing import fake_reid_state_dict, fake_yolov5_state_dict, one_torch_thread
from vehicle_counting_tpu_torch.tracking import tracker as trk

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

W, H = 320, 240
_INT_LEAVES = ("track_id", "state", "hits", "age", "tsu", "gallery_count", "pending_count", "next_id", "overflow")


def _frames(seed, n_frames, k, feat):
    """One class's detections over frames: objects moving steadily with a
    stable appearance, one missed now and then, in slots of a K capacity."""
    rng = np.random.default_rng(seed)
    n_obj = 6
    pos = rng.uniform(20, 200, (n_obj, 2))
    vel = rng.uniform(-3, 3, (n_obj, 2))
    size = rng.uniform(20, 40, (n_obj, 2))
    base = rng.standard_normal((n_obj, feat))
    out = []
    for t in range(n_frames):
        tlwh = np.zeros((k, 4), np.float32)
        conf = np.zeros(k, np.float32)
        feats = np.zeros((k, feat), np.float32)
        valid = np.zeros(k, bool)
        for j, o in enumerate(rng.permutation(n_obj)):
            if rng.random() < 0.15:
                continue
            tlwh[j] = [*(pos[o] + vel[o] * t + rng.normal(0, 0.5, 2)), *size[o]]
            conf[j] = rng.uniform(0.4, 0.95)
            f = base[o] + rng.normal(0, 0.2, feat)
            feats[j] = f / np.linalg.norm(f)
            valid[j] = True
        out.append((tlwh, conf, feats, valid))
    return out


def _port_steps(hp, frames):
    st, outs = trk.init_state(hp), []
    for x in frames:
        st, out = trk.tracker_step(st, *(torch.from_numpy(a) for a in x), hp, W, H)
        outs.append(out)
    return st, outs


@pytest.mark.parametrize("switch", [None, False, True])
def test_cascade_switch_by_jax_name(switch, monkeypatch):
    """F1: `FORCE_PALLAS_CASCADE` set on the port's module as JAX's tests set
    it on JAX's. False takes the staged route and never the K2 / K3
    entries; None and True take the kernel's entry (K3 for one class). At
    the default TrackerParams each step equals JAX's with its switch False."""
    monkeypatch.setattr(trk, "FORCE_PALLAS_CASCADE", switch)
    monkeypatch.setattr(jtrk, "FORCE_PALLAS_CASCADE", False)
    calls = {"staged": 0, "kernel": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(trk, "_associate_staged", spy("staged", trk._associate_staged))
    monkeypatch.setattr(trk, "cascade_match_batched", spy("kernel", trk.cascade_match_batched))
    monkeypatch.setattr(trk, "cascade_match_classparallel", spy("kernel", trk.cascade_match_classparallel))
    hp, jhp = trk.TrackerParams(), jtrk.TrackerParams()
    frames = _frames(3, 5, hp.capacity, hp.feat_dim)
    jstep = jax.jit(lambda st, *a: jtrk.tracker_step(st, *a, jhp, W, H))  # a fresh trace under the switch
    jst, n_out = jtrk.init_state(jhp), 0
    st, outs = _port_steps(hp, frames)
    for x, out in zip(frames, outs):
        jst, jout = jstep(jst, *(jnp.asarray(a) for a in x))
        np.testing.assert_array_equal(out.mask.numpy(), np.asarray(jout.mask))
        np.testing.assert_array_equal(out.ids.numpy(), np.asarray(jout.ids))
        np.testing.assert_allclose(out.boxes.numpy(), np.asarray(jout.boxes), atol=1e-4)
        np.testing.assert_allclose(out.scores.numpy(), np.asarray(jout.scores), atol=1e-6)
        n_out += int(out.mask.sum())
    for name in _INT_LEAVES:
        np.testing.assert_array_equal(getattr(st, name).numpy(), np.asarray(getattr(jst, name)), err_msg=name)
    np.testing.assert_allclose(st.mean.numpy(), np.asarray(jst.mean), rtol=1e-4, atol=1e-3)
    assert n_out > 0 and int(st.next_id) > 1  # tracks were born and confirmed
    assert calls == ({"staged": 5, "kernel": 0} if switch is False else {"staged": 0, "kernel": 5})


def test_cascade_switch_has_one_name():
    """The switch has JAX's name only: no second module flag for it."""
    assert trk.FORCE_PALLAS_CASCADE is None
    assert not [n for n in vars(trk) if n.startswith("FORCE_") and n != "FORCE_PALLAS_CASCADE"]
    assert not [n for n in vars(treid) if n.startswith("FORCE_") and n != "FORCE_PALLAS_REID_BLOCK"]


@pytest.fixture(scope="module")
def reid_weights():
    return treid.reid_state_dict_to_pytree(fake_reid_state_dict(np.random.default_rng(61)))


def test_reid_block_switch_by_jax_name(reid_weights, monkeypatch):
    """F1: `FORCE_PALLAS_REID_BLOCK = True` on the port's module routes the
    embed's two stage-1 blocks through the fused block (its plain version
    on the CPU), within 1e-4 of the oneDNN route at f32; None leaves it off."""
    tp, ts = reid_weights
    crops = torch.from_numpy(np.random.default_rng(62).standard_normal((4, 50, 50, 3)).astype(np.float32))
    monkeypatch.delenv("FORCE_PALLAS_REID_BLOCK", raising=False)
    calls = []
    fused = treid._block_fused
    monkeypatch.setattr(treid, "_block_fused", lambda *a: calls.append(1) or fused(*a))
    off = treid.reid_embed(tp, ts, crops)
    assert not calls
    monkeypatch.setattr(treid, "FORCE_PALLAS_REID_BLOCK", True)
    on = treid.reid_embed(tp, ts, crops)
    assert len(calls) == 2 and on.dtype == torch.float32 and on.shape == (4, 512)
    np.testing.assert_allclose(on.numpy(), off.numpy(), atol=1e-4, rtol=0)


def test_tracker_params_fields_are_jax_fields():
    """F2: the port's TrackerParams fields equal JAX's in name, order and default."""
    want = [(f.name, f.default) for f in dataclasses.fields(jtrk.TrackerParams)]
    assert [(f.name, f.default) for f in dataclasses.fields(trk.TrackerParams)] == want
    assert [n for n, _ in want][3] == "pending_cap"
    hp = trk.TrackerParams(capacity=8, pending_cap=4)
    assert (hp.capacity, hp.pending_cap, hp.max_dist) == (8, 4, 0.2)
    assert trk.TrackerParams(64, 512, 60, 8, 0.3).max_dist == 0.3  # JAX's positional order


def test_pending_cap_changes_nothing():
    """F2: `pending_cap` allocates and bounds nothing, as in JAX: the steps
    with pending_cap=4 equal those with the default, bitwise."""
    hp = trk.TrackerParams(capacity=8, feat_dim=16, budget=6, max_age=4, n_init=2)
    frames = _frames(4, 8, hp.capacity, hp.feat_dim)
    st_a, outs_a = _port_steps(hp, frames)
    st_b, outs_b = _port_steps(dataclasses.replace(hp, pending_cap=4), frames)
    for a, b in zip(list(st_a) + [o for out in outs_a for o in out], list(st_b) + [o for out in outs_b for o in out]):
        assert torch.equal(a, b)
    assert int(st_a.next_id) > 1


def _assert_bitwise(have, want, path=""):
    if isinstance(want, dict):
        assert sorted(have) == sorted(want), path
        for k in want:
            _assert_bitwise(have[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(have) == len(want), path
        for i, (h, w) in enumerate(zip(have, want)):
            _assert_bitwise(h, w, f"{path}[{i}]")
    else:
        assert have.dtype == want.dtype == torch.float32 and torch.equal(have, want), path


@pytest.mark.parametrize("form", ["hub_f32", "fp16"])
def test_yolov5_state_dict_to_pytree_is_jax_call(form):
    """F3: JAX's call `yolov5_state_dict_to_pytree(state_dict)` (as
    tests/test_yolo.py makes it on a `model.`-prefixed f32 dict, and
    tests/test_convert_ultralytics.py on an fp16 one) gives the port's
    params, bitwise those of JAX's result carried across."""
    from vehicle_counting_tpu_torch.models.convert import yolov5_state_dict_to_pytree

    sd = fake_yolov5_state_dict(np.random.default_rng(63), "yolov5n", 4)
    if form == "fp16":
        sd = {k: v.astype(np.float16) for k, v in sd.items()}
    have = yolov5_state_dict_to_pytree(sd)
    want = yolo_params_from_jax(jax.tree.map(np.asarray, jconvert.yolov5_state_dict_to_pytree(sd)))
    _assert_bitwise(have, want)
    assert have["0"]["w"].shape[1] == 3  # OIHW


def test_reid_state_dict_to_pytree_is_jax_call():
    """F3: JAX's call `reid_state_dict_to_pytree(sd)` (tests/test_reid.py)
    gives the port's (params, stats), bitwise JAX's carried across."""
    from vehicle_counting_tpu_torch.models.reid import reid_state_dict_to_pytree

    sd = fake_reid_state_dict(np.random.default_rng(64))
    params, stats = reid_state_dict_to_pytree(sd)
    jp, js = jreid.reid_state_dict_to_pytree(sd)
    wp, ws = reid_params_from_jax(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))
    _assert_bitwise(params, wp)
    _assert_bitwise(stats, ws)


def test_oihw_to_hwio_and_imagenet_constants_are_jax_values():
    from vehicle_counting_tpu_torch.models.convert import oihw_to_hwio
    from vehicle_counting_tpu_torch.models.reid import IMAGENET_MEAN, IMAGENET_STD
    from vehicle_counting_tpu_torch.ops import crops
    from vehicle_counting_tpu_torch.train import augment

    w = np.random.default_rng(65).standard_normal((6, 4, 3, 5)).astype(np.float32)
    np.testing.assert_array_equal(oihw_to_hwio(w), jconvert.oihw_to_hwio(w))
    assert oihw_to_hwio(w).shape == (3, 5, 4, 6)
    assert (IMAGENET_MEAN, IMAGENET_STD) == (jreid.IMAGENET_MEAN, jreid.IMAGENET_STD)
    np.testing.assert_array_equal(crops._MEAN, np.float32(jreid.IMAGENET_MEAN))
    np.testing.assert_array_equal(crops._STD, np.float32(jreid.IMAGENET_STD))
    x = torch.full((1, 2, 2, 3), 255.0)
    np.testing.assert_allclose(augment.normalize(x)[0, 0, 0].numpy(),
                               (1 - np.float32(IMAGENET_MEAN)) / np.float32(IMAGENET_STD), rtol=1e-6)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("groups", [1, 2])
def test_conv2d_is_jax_conv2d(stride, groups):
    """F3: `conv2d(x, w, *, stride, padding, groups, dtype)` on NHWC inputs,
    the port's weights OIHW (JAX's HWIO transposed): within 1e-5 of JAX's
    at f32, and f32 out at dtype=bfloat16, as JAX's
    preferred_element_type=float32 gives."""
    from vehicle_counting_tpu_torch.models.layers import conv2d

    rng = np.random.default_rng(66 + stride + 10 * groups)
    x = rng.standard_normal((2, 9, 11, 8)).astype(np.float32)
    w_hwio = (rng.standard_normal((3, 3, 8 // groups, 6)) * 0.2).astype(np.float32)
    w = torch.from_numpy(np.ascontiguousarray(np.transpose(w_hwio, (3, 2, 0, 1))))
    want = np.asarray(jlayers.conv2d(jnp.asarray(x), jnp.asarray(w_hwio), stride=stride, groups=groups))
    have = conv2d(torch.from_numpy(x), w, stride=stride, groups=groups)
    assert have.dtype == torch.float32 and have.shape == want.shape
    np.testing.assert_allclose(have.numpy(), want, atol=1e-5, rtol=0)
    want1 = np.asarray(jlayers.conv2d(jnp.asarray(x), jnp.asarray(w_hwio[1:2, 1:2]), stride=stride, padding=0,
                                      groups=groups))
    have1 = conv2d(torch.from_numpy(x), w[:, :, 1:2, 1:2], stride=stride, padding=0, groups=groups)
    np.testing.assert_allclose(have1.numpy(), want1, atol=1e-5, rtol=0)
    low = conv2d(torch.from_numpy(x), w, stride=stride, groups=groups, dtype=torch.bfloat16)
    jlow = jlayers.conv2d(jnp.asarray(x), jnp.asarray(w_hwio), stride=stride, groups=groups, dtype=jnp.bfloat16)
    assert low.dtype == torch.float32 and jlow.dtype == jnp.float32 and low.shape == want.shape
