"""PyTorch port, ReID train-time augmentation (`train/augment.py`) against
the JAX package's (`vehicle_counting_tpu/train/augment.py`).

The port draws from a `torch.Generator` through `flip_mask` and
`rotation_degrees`; the tests replace those with the values JAX draws from
the same key (`jax.random.bernoulli` / `uniform`, replayed here), so each
op is held against JAX on JAX's own draws: the flip array-equal; the
rotation and the whole `augment_batch` from one key within ROT_ATOL. Both
are the same bilinear gather in f32, but XLA's and PyTorch's f32 sin and
cos of an angle can differ in the last bit, which moves a sample point by
~1e-6 px: measured up to 1.8e-5 on N(0, 1) pixels, where JAX's own eager
and jitted `augment_batch` differ by up to 2.1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vehicle_counting_tpu.train import augment as J
from vehicle_counting_tpu_torch.train import augment as P

ROT_ATOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six test workers at once, and
    more threads per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_draws(monkeypatch, flips=(), angles=()):
    fi, ai = iter(flips), iter(angles)
    monkeypatch.setattr(P, "flip_mask", lambda gen, n, device: torch.from_numpy(np.asarray(next(fi))).to(device))
    monkeypatch.setattr(P, "rotation_degrees",
                        lambda gen, n, max_deg, device: torch.from_numpy(np.asarray(next(ai))).to(device))


def test_normalize_roundtrip_and_matches_jax(rng):
    img = rng.integers(0, 255, size=(2, 16, 16, 3)).astype(np.float32)
    got = P.normalize(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(J.normalize(jnp.asarray(img))), rtol=1e-6, atol=1e-6)
    back = P.denormalize(got)
    np.testing.assert_allclose(back.numpy(), img, atol=1e-3)
    np.testing.assert_allclose(back.numpy(), np.asarray(J.denormalize(J.normalize(jnp.asarray(img)))), atol=1e-4)


def test_random_flip_equals_jax(rng, monkeypatch):
    img = rng.normal(size=(8, 8, 8, 3)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    _jax_draws(monkeypatch, flips=[jax.random.bernoulli(key, 0.5, (8,))])
    got = P.random_flip(torch.Generator(), torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(), np.asarray(J.random_flip(key, jnp.asarray(img))))


def test_flip_is_involution(rng):
    img = torch.from_numpy(rng.normal(size=(4, 8, 8, 3)).astype(np.float32))
    once = P.random_flip(torch.Generator().manual_seed(0), img)
    twice = P.random_flip(torch.Generator().manual_seed(0), once)
    assert torch.equal(twice, img)


@pytest.mark.parametrize("hw", [(21, 21), (50, 50), (16, 24)])
def test_random_rotate_matches_jax(rng, monkeypatch, hw):
    img = rng.normal(size=(3,) + hw + (3,)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    _jax_draws(monkeypatch, angles=[jax.random.uniform(key, (3,), minval=-10.0, maxval=10.0)])
    got = P.random_rotate(torch.Generator(), torch.from_numpy(img), max_deg=10.0)
    want = np.asarray(J.random_rotate(key, jnp.asarray(img), max_deg=10.0))
    assert got.shape == img.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ROT_ATOL)


def test_rotate_preserves_center(rng):
    img = torch.from_numpy(rng.normal(size=(3, 21, 21, 3)).astype(np.float32))
    out = P.random_rotate(torch.Generator().manual_seed(1), img, max_deg=10.0)
    np.testing.assert_allclose(out[:, 10, 10].numpy(), img[:, 10, 10].numpy(), atol=1e-4)


def test_augment_batch_matches_jax_from_one_key(rng, monkeypatch):
    img = rng.normal(size=(4, 50, 50, 3)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    k1, k2 = jax.random.split(key)
    _jax_draws(monkeypatch, flips=[jax.random.bernoulli(k1, 0.5, (4,))],
               angles=[jax.random.uniform(k2, (4,), minval=-10.0, maxval=10.0)])
    got = P.augment_batch(torch.Generator(), torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, np.asarray(J.augment_batch(key, jnp.asarray(img))), rtol=0, atol=ROT_ATOL)


def test_draws_come_from_the_generator(rng):
    img = torch.from_numpy(rng.normal(size=(16, 50, 50, 3)).astype(np.float32))
    a = P.augment_batch(torch.Generator().manual_seed(3), img)
    b = P.augment_batch(torch.Generator().manual_seed(3), img)
    c = P.augment_batch(torch.Generator().manual_seed(4), img)
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a).all()
    deg = P.rotation_degrees(torch.Generator().manual_seed(0), 10000, 10.0, "cpu")
    assert -10.0 <= float(deg.min()) and float(deg.max()) < 10.0
    assert 0.45 < float(P.flip_mask(torch.Generator().manual_seed(0), 10000, "cpu").float().mean()) < 0.55
