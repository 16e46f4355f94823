"""PyTorch port, ReID crops (kernel K1's plain version) and the batch embed,
against the JAX package; the CUDA kernel against its plain version."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vehicle_counting_tpu.models.reid import init_reid
from vehicle_counting_tpu.ops.crops import gather_crops_batch as j_gather
from vehicle_counting_tpu.tracking import deepsort as jds
from vehicle_counting_tpu.tracking.tracker import TrackerParams as JTP
from vehicle_counting_tpu_torch.models.convert import reid_params_from_jax
from vehicle_counting_tpu_torch.ops import crops as tcrops
from vehicle_counting_tpu_torch.testing import crop_boxes, one_torch_thread
from vehicle_counting_tpu_torch.tracking import deepsort as tds
from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def _inputs(seed, b=3, h=40, w=64, d=64):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (b, 3, h, w), dtype=np.uint8)
    boxes = crop_boxes(rng, d, h, w)
    fidx = rng.integers(0, b, d).astype(np.int32)
    valid = rng.random(d) < 0.8
    return frames, fidx, boxes, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_crops_match_jax(seed):
    """Tolerance 1e-6: XLA:CPU contracts the two column-tap products of its
    one-hot einsum into an FMA (one rounding instead of two), so a pixel
    can differ by one f32 ulp on the 0..255 scale (~3e-7 after /255 and
    /std). Run op by op: jit fusion of the whole JAX function rounds the
    einsum differently again (up to ~2e-5 measured)."""
    frames, fidx, boxes, valid = _inputs(seed)
    with jax.disable_jit():
        j = np.asarray(j_gather(jnp.asarray(frames.transpose(0, 2, 3, 1)), jnp.asarray(fidx),
                                jnp.asarray(boxes), jnp.asarray(valid)))
    t = tcrops.gather_crops_batch_plain(torch.from_numpy(frames), torch.from_numpy(fidx),
                                        torch.from_numpy(boxes), torch.from_numpy(valid)).numpy()
    assert t.shape == j.shape == (64, 50, 50, 3)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t[~valid], 0.0)


def test_bilinear_coords_array_equal():
    from vehicle_counting_tpu.ops.crops import _bilinear_coords as jbc

    _, _, boxes, _ = _inputs(2)
    j = jbc(jnp.asarray(boxes), 40, 64, (50, 50))
    t = tcrops._bilinear_coords(torch.from_numpy(boxes), 40, 64, (50, 50))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _kernel_coords_np(boxes, h, w, out=50):
    """The in-kernel coordinate recipe of csrc/crops.cu::axis_coords,
    restated with numpy f32 scalars, one operation and one rounding at a
    time in the kernel's order: truncating float -> int, the clamps,
    crop / 50 as a division, (d + 0.5) * q - 0.5 as a separately rounded
    multiply and subtract, floor, f = s - i0."""
    f32 = np.float32

    def axis(lo, hi, size, i):
        a = max(int(np.trunc(lo)), 0)
        b = min(int(np.trunc(hi)), size - 1)
        c = f32(max(b - a, 1))
        q = f32(c / f32(out))
        t = f32(f32(f32(f32(i) + f32(0.5)) * q) - f32(0.5))
        t = min(max(t, f32(0.0)), f32(c - f32(1.0)))
        s = f32(f32(a) + t)
        i0 = int(np.floor(s))
        return min(max(i0, 0), size - 1), min(max(i0 + 1, 0), size - 1), f32(s - f32(i0))

    d = boxes.shape[0]
    res = [np.zeros((d, out), np.int32), np.zeros((d, out), np.int32), np.zeros((d, out), np.float32),
           np.zeros((d, out), np.int32), np.zeros((d, out), np.int32), np.zeros((d, out), np.float32)]
    for n, (x1, y1, x2, y2) in enumerate(boxes):
        for i in range(out):
            res[0][n, i], res[1][n, i], res[2][n, i] = axis(y1, y2, h, i)
            res[3][n, i], res[4][n, i], res[5][n, i] = axis(x1, x2, w, i)
    return res


def _coord_boxes(kind, h, w):
    if kind == "seeded":  # the boxes of test_bilinear_coords_array_equal
        return _inputs(2)[2]
    if kind == "one_pixel":
        return np.asarray([[0, 0, 1, 1], [w - 1, h - 1, w, h], [10.7, 20.2, 11.9, 21.1], [5, 5, 5, 5]], np.float32)
    if kind == "edge_clamped":
        return np.asarray([[-20.5, -3.25, 12.5, 9.75], [w - 3.5, h - 2.2, w + 40.0, h + 30.0],
                           [-5, 10, w + 5, 20], [30, 40, 10, 20], [w + 3, h + 3, w + 9, h + 9]], np.float32)
    assert kind == "frame_sized"
    return np.asarray([[0, 0, w, h], [0, 0, w - 1, h - 1], [-1, -1, w + 1, h + 1], [0.5, 0.5, w - 0.5, h - 0.5]],
                      np.float32)


@pytest.mark.parametrize("hw", [(40, 64), (384, 640)])
@pytest.mark.parametrize("kind", ["seeded", "one_pixel", "edge_clamped", "frame_sized"])
def test_kernel_coordinate_recipe_array_equal(kind, hw):
    """The kernel computes its own sample coordinates: its recipe, restated
    in numpy, equals the port's `_bilinear_coords` and the JAX package's."""
    from vehicle_counting_tpu.ops.crops import _bilinear_coords as jbc

    h, w = hw
    boxes = _coord_boxes(kind, h, w)
    k = _kernel_coords_np(boxes, h, w)
    t = tcrops._bilinear_coords(torch.from_numpy(boxes), h, w, (50, 50))
    j = jbc(jnp.asarray(boxes), h, w, (50, 50))
    for a, b, c in zip(k, t, j):
        np.testing.assert_array_equal(a, b.numpy())
        np.testing.assert_array_equal(a, np.asarray(c))


@pytest.mark.parametrize("kind", ["seeded", "one_pixel", "edge_clamped", "frame_sized"])
def test_band_corners_cover_every_tap(kind):
    """The kernel stages rows y0c[0] .. y1c[49] and columns x0c[0] .. x1c[49]
    (from the 16-byte boundary below): taps are monotone along each axis,
    so that band holds every tap, and it stays inside the row."""
    h, w = 384, 640
    y0c, y1c, _, x0c, x1c, _ = (t.numpy() for t in tcrops._bilinear_coords(
        torch.from_numpy(_coord_boxes(kind, h, w)), h, w, (50, 50)))
    for lo, hi in ((y0c, y1c), (x0c, x1c)):
        assert (np.diff(lo, axis=1) >= 0).all() and (np.diff(hi, axis=1) >= 0).all()
        assert (lo.min(axis=1) == lo[:, 0]).all() and (hi.max(axis=1) == hi[:, -1]).all()
        assert (lo[:, 0] <= hi[:, 0]).all()
    xa = x0c[:, 0] & ~15
    pitch = ((x1c[:, -1] - xa) // 16 + 1) * 16
    assert (xa + pitch <= w).all() and (xa + pitch > x1c[:, -1]).all()


def test_coincident_taps_fold_into_one_formula():
    """The kernel mixes columns as p0 * wa + p1 * wb with (wa, wb) =
    ((1 - fx) + fx, 0) where the clamp taps coincide: bit for bit the plain
    version's p0 * ((1 - fx) + fx)."""
    rng = np.random.default_rng(7)
    p = rng.integers(0, 256, 4096).astype(np.float32)
    fx = rng.random(4096).astype(np.float32)
    wa = (np.float32(1.0) - fx) + fx
    np.testing.assert_array_equal(p * wa + p * np.float32(0.0), p * wa)


def _rn32(fr):
    """A Fraction rounded to the nearest float32, ties to even."""
    from fractions import Fraction

    if fr == 0:
        return np.float32(0)
    a, e = abs(fr), 0
    while a >= Fraction(2) ** (e + 1):
        e += 1
    while a < Fraction(2) ** e:
        e -= 1
    scale = Fraction(2) ** (max(e, -126) - 23)
    m = a / scale
    fl = m.numerator // m.denominator
    if m - fl > Fraction(1, 2) or (m - fl == Fraction(1, 2) and fl % 2):
        fl += 1
    return np.float32(float(fl * scale) * (1 if fr > 0 else -1))


@pytest.mark.parametrize("divisor", [255.0, 0.229, 0.224, 0.225])
def test_division_by_reciprocal_and_residual_is_ieee_division(divisor):
    """csrc/crops.cu::div_by, in exact rational arithmetic: q = RN(x rc),
    r = x - q c (one FMA, exact), RN(q + r rc) equals RN(x / c) for the
    kernel's four divisors, on pixel-scale and normalised-scale values."""
    from fractions import Fraction as Fr

    c = np.float32(divisor)
    rc = _rn32(1 / Fr(float(c)))
    rng = np.random.default_rng(8)
    xs = np.concatenate([np.arange(256, dtype=np.float32), rng.uniform(0, 255, 600).astype(np.float32),
                         rng.uniform(-3, 3, 600).astype(np.float32), np.float32([1e-9, -1e-9, 3e-7])])
    for x in xs:
        x = Fr(float(x))
        q = _rn32(x * Fr(float(rc)))
        r = _rn32(x - Fr(float(q)) * Fr(float(c)))
        assert Fr(float(r)) == x - Fr(float(q)) * Fr(float(c))  # the residual is exact
        assert _rn32(Fr(float(r)) * Fr(float(rc)) + Fr(float(q))) == _rn32(x / Fr(float(c)))


def test_wrapper_takes_plain_version_on_cpu():
    frames, fidx, boxes, valid = _inputs(3)
    args = (torch.from_numpy(frames), torch.from_numpy(fidx), torch.from_numpy(boxes), torch.from_numpy(valid))
    before = tcrops.gather_crops_batch.launches
    np.testing.assert_array_equal(tcrops.gather_crops_batch(*args).numpy(),
                                  tcrops.gather_crops_batch_plain(*args).numpy())
    assert tcrops.gather_crops_batch.launches == before  # no kernel on the CPU


def test_wrapper_checks_reject_bad_operands():
    frames, fidx, boxes, valid = (torch.from_numpy(x) for x in _inputs(4))
    with pytest.raises(ValueError):
        tcrops._check_cuda_args(frames.float(), fidx, boxes, valid)
    with pytest.raises(ValueError):
        tcrops._check_cuda_args(frames, fidx, boxes[:5], valid)
    with pytest.raises(ValueError):
        tcrops._check_cuda_args(frames, fidx, boxes.double(), valid)
    with pytest.raises(ValueError):
        tcrops._check_cuda_args(frames.permute(0, 1, 3, 2), fidx, boxes, valid)


def test_batch_embed_matches_jax():
    """Chunked batch embed with the letterbox crop transform, f32."""
    rng = np.random.default_rng(5)
    b, n, h, w = 2, 12, 48, 64
    frames = rng.integers(0, 256, (b, 3, h, w), dtype=np.uint8)
    boxes = crop_boxes(rng, b * n, h, w).reshape(b, n, 4)
    valid = rng.random((b, n)) < 0.7
    jp, js = jax.jit(init_reid)(jax.random.PRNGKey(1))
    tp, ts = reid_params_from_jax(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))
    kw = dict(crop_gain=0.75, crop_pad=(2.0, 5.0))
    jhp = jds.DeepSortParams(tracker=JTP(capacity=16), num_classes=2, max_embed=8)
    thp = tds.DeepSortParams(tracker=TrackerParams(capacity=16), num_classes=2, max_embed=8)
    j = jds.embed_detections_batch(jnp.asarray(frames), jnp.asarray(boxes), jnp.asarray(valid), jp, js, jhp,
                                   planar=True, **kw)
    t = tds.embed_detections_batch(torch.from_numpy(frames), torch.from_numpy(boxes), torch.from_numpy(valid),
                                   tp, ts, thp, **kw)
    assert t.shape == (b, n, 512)
    np.testing.assert_array_equal(t[~torch.from_numpy(valid)].numpy(), 0.0)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the crop kernel is CUDA C++ with no CPU mode")
    for h, w in ((96, 128), (96, 120), (384, 640)):  # 120: rows not 16-byte multiples, the direct route only
        frames, fidx, boxes, valid = _inputs(6, b=4, h=h, w=w, d=200)
        boxes[-8:] = np.concatenate([_coord_boxes("frame_sized", h, w), _coord_boxes("one_pixel", h, w)])
        valid[-8:] = True
        frames, fidx, boxes, valid = (torch.from_numpy(x).cuda() for x in (frames, fidx, boxes, valid))
        staged = torch.zeros((), dtype=torch.int32, device="cuda")
        k = tcrops._launch(frames, fidx.long(), boxes, valid, staged_count=staged)
        torch.cuda.synchronize()
        assert torch.equal(k, tcrops.gather_crops_batch_plain(frames, fidx, boxes, valid))
        assert torch.equal(k, tcrops.gather_crops_batch(frames, fidx, boxes, valid))
        n_valid = int(valid.sum())
        assert (0 < int(staged) < n_valid) if w % 16 == 0 else int(staged) == 0  # both routes ran
