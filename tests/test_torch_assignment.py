"""PyTorch port, kernel K4: batched JV row insertion and the batched
transpose rule, against the TPU kernel in interpret mode, the JAX XLA
solver and scipy, bitwise on the same numpy problems."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy.optimize import linear_sum_assignment

from vehicle_counting_tpu.ops.pallas.assignment import _insert_rows_pallas_batched
from vehicle_counting_tpu.tracking.assignment import _insert_rows as j_insert_rows
from vehicle_counting_tpu.tracking.assignment import solve_uniform as j_solve_uniform
from vehicle_counting_tpu_torch.ops import assignment as tas
from vehicle_counting_tpu_torch.testing import clamp_tie_problems
from vehicle_counting_tpu_torch.tracking.assignment import BIG

C, S = 3, 16


def _problems(kind, seed):
    """[C, S, S] compacted problems; class 0 has more rows than columns
    (the transposed solve), class 1 fewer."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        costs, nr, nc = clamp_tie_problems(rng, C, S, hi=S + 1)
    else:
        nr = rng.integers(1, S + 1, C).astype(np.int32)
        nc = rng.integers(1, S + 1, C).astype(np.int32)
        costs = np.full((C, S, S), BIG, np.float32)
        for i in range(C):
            costs[i, : nr[i], : nc[i]] = rng.random((nr[i], nc[i]))
    for i, (r, c) in enumerate(((S - 2, 5), (4, S - 1))):
        nr[i], nc[i] = r, c
        costs[i] = BIG
        costs[i, :r, :c] = (rng.choice([0.1, 0.3, 0.30001], (r, c)) if kind == "ties" else rng.random((r, c)))
    return costs.astype(np.float32), nr, nc


_j_solve = jax.jit(jax.vmap(lambda c, r, n: j_solve_uniform(j_insert_rows, c, r, n)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_insert_rows_matches_pallas_interpret(kind, seed):
    costs, nr, _ = _problems(kind, seed)
    want = np.asarray(_insert_rows_pallas_batched(jnp.asarray(costs), jnp.asarray(nr), interpret=True))
    got = tas.insert_rows_batched(torch.from_numpy(costs), torch.from_numpy(nr))
    assert got.dtype == torch.int32 and got.shape == (C, S + 1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_solve_uniform_batched_matches_jax(kind, seed):
    costs, nr, nc = _problems(kind, seed + 10)
    want = np.asarray(_j_solve(jnp.asarray(costs), jnp.asarray(nr), jnp.asarray(nc)))
    got = tas.solve_uniform_batched(torch.from_numpy(costs), torch.from_numpy(nr).long(),
                                    torch.from_numpy(nc).long()).numpy()
    np.testing.assert_array_equal(got, want)
    for i in range(C):
        r, c = linear_sum_assignment(costs[i, : nr[i], : nc[i]])
        rows = np.nonzero(got[i, : nr[i]] >= 0)[0]
        assert rows.size == min(nr[i], nc[i])
        # scipy's f64 duals may break f32 ties otherwise: the optimum's cost agrees
        np.testing.assert_allclose(costs[i, rows, got[i, rows]].sum(), costs[i, r, c].sum(), rtol=1e-6)


def test_n_ins_clamped_like_the_kernel():
    costs, nr, _ = _problems("random", 3)
    t = torch.from_numpy(costs)
    np.testing.assert_array_equal(
        tas.insert_rows_batched(t, torch.tensor([S + 5, -2, 0])).numpy(),
        tas.insert_rows_batched(t, torch.tensor([S, 0, 0])).numpy(),
    )


def test_kernel_rejects_past_size_limit():
    with pytest.raises(ValueError, match="S <= 1023"):
        tas._launch(torch.zeros((1, 1024, 1024)), torch.zeros(1, dtype=torch.int32))


@pytest.mark.cuda
def test_insert_rows_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the assignment kernel is CUDA C++ with no CPU mode")
    for n, s, hi in ((300, 64, 40), (4, 64, 65), (3, 256, 257)):
        costs, nr, nc = (torch.from_numpy(a) for a in clamp_tie_problems(np.random.default_rng(s + n), n, s, hi))
        got = tas.insert_rows_batched(costs.cuda(), nr.cuda())
        assert torch.equal(got.cpu(), tas.insert_rows_batched(costs, nr))
        got = tas.solve_uniform_batched(costs.cuda(), nr.cuda(), nc.cuda())
        assert torch.equal(got.cpu(), tas.solve_uniform_batched(costs, nr, nc))
