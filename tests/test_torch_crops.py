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
from vehicle_counting_tpu_torch.testing import crop_boxes
from vehicle_counting_tpu_torch.tracking import deepsort as tds
from vehicle_counting_tpu_torch.tracking.tracker import TrackerParams


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
    frames, fidx, boxes, valid = (torch.from_numpy(x).cuda() for x in _inputs(6, b=4, h=96, w=128, d=200))
    k = tcrops.gather_crops_batch(frames, fidx, boxes, valid)
    torch.cuda.synchronize()
    assert torch.equal(k, tcrops.gather_crops_batch_plain(frames, fidx, boxes, valid))
