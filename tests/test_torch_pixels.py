"""PyTorch port, pixel path: host letterbox/I420 packing and the device
I420 -> planar RGB conversion, array-equal to the JAX package."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vehicle_counting_tpu_torch.testing import one_torch_thread

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

# both ops packages re-export a `letterbox` function under the module's name
jlb = importlib.import_module("vehicle_counting_tpu.ops.letterbox")
tlb = importlib.import_module("vehicle_counting_tpu_torch.ops.letterbox")

GEOMETRIES = [((72, 128), 128), ((88, 160), 128), ((70, 128), 128), ((720, 1280), 640), ((480, 640), 640)]


@pytest.mark.parametrize("src_hw,size", GEOMETRIES)
def test_geometry_helpers_match(src_hw, size):
    net = jlb.autoshape_hw(src_hw, size)
    assert tlb.autoshape_hw(src_hw, size) == net
    assert tlb.autoshape_hw(src_hw, [size, size]) == jlb.autoshape_hw(src_hw, [size, size])
    assert tlb.letterbox_params(src_hw, net) == jlb.letterbox_params(src_hw, net)
    assert tlb.content_rows(src_hw, net) == jlb.content_rows(src_hw, net)
    assert tlb.content_upload_exact(src_hw, net) == jlb.content_upload_exact(src_hw, net)


# content-only upload where it is exact (72x128), full frames where not (88x160)
@pytest.mark.parametrize("src_hw,content_only", [((72, 128), True), ((72, 128), False), ((88, 160), False)])
def test_host_i420_and_device_rgb_array_equal(src_hw, content_only):
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (3,) + src_hw + (3,), dtype=np.uint8)
    net = jlb.autoshape_hw(src_hw, 128)
    assert jlb.content_upload_exact(src_hw, net) == content_only or not content_only
    j_yuv = jlb.host_letterbox_yuv420(frames, net, content_only=content_only)
    t_yuv = tlb.host_letterbox_yuv420(frames, net, content_only=content_only)
    np.testing.assert_array_equal(t_yuv, j_yuv)

    j_full = jlb.yuv420_content_to_full(jnp.asarray(j_yuv), src_hw, net) if content_only else jnp.asarray(j_yuv)
    t_full = tlb.yuv420_content_to_full(torch.from_numpy(t_yuv), src_hw, net) if content_only else torch.from_numpy(t_yuv)
    np.testing.assert_array_equal(t_full.numpy(), np.asarray(j_full))
    np.testing.assert_array_equal(
        tlb.yuv420_to_rgb_u8_planar(t_full).numpy(), np.asarray(jlb.yuv420_to_rgb_u8_planar(j_full))
    )


def test_yuv_to_rgb_all_byte_values():
    """Every Y/U/V byte value through the conversion (clip edges included)."""
    rng = np.random.default_rng(4)
    h, w = 32, 64
    yuv = rng.integers(0, 256, (2, h * 3 // 2, w), dtype=np.uint8)
    yuv[0, :h].flat[:256] = np.arange(256)
    yuv[0, h:].flat[:256] = np.arange(256)
    np.testing.assert_array_equal(
        tlb.yuv420_to_rgb_u8_planar(torch.from_numpy(yuv)).numpy(),
        np.asarray(jlb.yuv420_to_rgb_u8_planar(jnp.asarray(yuv))),
    )


def test_content_to_full_rejects_wrong_geometry():
    with pytest.raises(ValueError):
        tlb.yuv420_content_to_full(torch.zeros((1, 60, 128), dtype=torch.uint8), (72, 128), (96, 128))


@pytest.mark.parametrize("src_hw", [(72, 128), (720, 1280), (88, 160)])
def test_restore_boxes_array_equal(src_hw):
    rng = np.random.default_rng(5)
    net = jlb.autoshape_hw(src_hw, 128 if src_hw[0] < 200 else 640)
    boxes = rng.uniform(-20, max(net) + 20, (4, 7, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tlb.restore_boxes(torch.from_numpy(boxes), src_hw, net).numpy(),
        np.asarray(jlb.restore_boxes(jnp.asarray(boxes), src_hw, net)),
    )
