"""PyTorch port, kernel K6: the layer-1 conv (3x3 stride 2, 32 -> 64,
bias, SiLU), plain version against the TPU kernel in interpret mode and
against JAX's `models/layers.py::conv_block` at stride 2, on the same numpy
inputs and weights (carried across by models/convert.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vehicle_counting_tpu.models.layers import conv_block as j_conv_block
from vehicle_counting_tpu.ops.pallas.conv_s2 import conv1_s2_silu_pallas
from vehicle_counting_tpu_torch.models.convert import conv1_s2_from_jax
from vehicle_counting_tpu_torch.ops import conv_s2 as tcs
from vehicle_counting_tpu_torch.testing import conv1_s2_inputs, one_torch_thread

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

# f32 on both sides; only the conv's summation order differs
TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 output: one bf16 ulp (2^-8 relative) where the f32 sums round apart
TOL_BF16 = dict(rtol=1.6e-2, atol=1e-2)


def _inputs(seed, shape=(1, 32, 64, 32)):
    return conv1_s2_inputs(np.random.default_rng(seed), shape)


@pytest.mark.parametrize("reference", ["pallas_interpret", "conv_block"])
def test_plain_matches_jax(reference):
    x, p = _inputs(40)
    if reference == "pallas_interpret":
        want = conv1_s2_silu_pallas(jnp.asarray(x), jnp.asarray(p["w"]), jnp.asarray(p["b"]), interpret=True)
    else:
        want = j_conv_block({"w": jnp.asarray(p["w"]), "b": jnp.asarray(p["b"])}, jnp.asarray(x), stride=2)
    w, b = conv1_s2_from_jax(p)
    got = tcs.conv1_s2_silu(torch.from_numpy(x), w, b)
    assert got.shape == (1, 16, 32, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_bf16_matches_pallas_interpret():
    x, p = _inputs(41, (2, 64, 128, 32))
    want = conv1_s2_silu_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(p["w"]), jnp.asarray(p["b"]),
                                interpret=True)
    w, b = conv1_s2_from_jax(p)
    got = tcs.conv1_s2_silu(torch.from_numpy(x).to(torch.bfloat16), w, b)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL_BF16)


@pytest.mark.parametrize("shape", [(1, 300, 320, 32), (1, 320, 300, 32), (1, 320, 320, 16)])
def test_shape_checks_match_the_tpu_kernel(shape):
    w = torch.zeros((3, 3, shape[-1], 64))
    with pytest.raises(ValueError):
        tcs.conv1_s2_silu(torch.zeros(shape), w, torch.zeros(64))


def test_pack_conv1_weights_is_a_permutation_of_hwio():
    """The bf16 kernel's packed slabs hold exactly the HWIO weights and
    zeros for the tenth tap: a numpy restatement of what the kernel reads.
    Slab s, row co, stored chunk c ^ (co % 8) holds k = 8 c .. 8 c + 8 of
    that row, k = (tap % 2) * 32 + ci with tap = 2 s + k // 32."""
    rng = np.random.default_rng(43)
    w = torch.from_numpy(rng.standard_normal((3, 3, 32, 64)).astype(np.float32))
    packed = tcs.pack_conv1_weights(w)
    assert packed.shape == (5, 64, 64) and packed.dtype == torch.bfloat16 and packed.is_contiguous()
    chunks = packed.view(torch.int16).numpy().reshape(5, 64, 8, 8)
    want = w.to(torch.bfloat16).view(torch.int16).numpy().reshape(9, 32, 64)
    seen = np.zeros((9, 32, 64), bool)
    for s in range(5):
        for co in range(64):
            for c in range(8):
                row = chunks[s, co, c ^ (co % 8)]
                for e in range(8):
                    k = 8 * c + e
                    tap, ci = 2 * s + k // 32, k % 32
                    if tap == 9:
                        assert row[e] == 0
                    else:
                        assert row[e] == want[tap, ci, co]
                        seen[tap, ci, co] = True
    assert seen.all()


def test_pack_index_is_built_once_per_device():
    w = torch.zeros((3, 3, 32, 64))
    tcs.pack_conv1_weights(w)
    idx = tcs._PACK_INDEX[w.device]
    tcs.pack_conv1_weights(w + 1)
    assert tcs._PACK_INDEX[w.device] is idx and idx.numel() == 5 * 64 * 64


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the conv kernel is CUDA C++ with no CPU mode")
    torch.backends.cudnn.allow_tf32 = False  # the plain version's f32 conv
    for shape, dt, tol in (((2, 64, 128, 32), torch.float32, TOL), ((4, 192, 320, 32), torch.bfloat16, TOL_BF16),
                           ((3, 64, 128, 32), torch.bfloat16, TOL_BF16), ((1, 32, 64, 32), torch.bfloat16, TOL_BF16)):
        x, p = _inputs(42, shape)
        w, b = (t.cuda() for t in conv1_s2_from_jax(p))
        xt = torch.from_numpy(x).to(dt).cuda()
        got = tcs.conv1_s2_silu(xt, w, b)
        torch.testing.assert_close(got.float(), tcs.conv1_s2_silu_plain(xt, w, b).float(), **tol)
