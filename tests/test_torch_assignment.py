"""PyTorch port, kernel K4: batched JV row insertion and the batched
transpose rule, against the TPU kernel in interpret mode, the JAX XLA
solver and scipy, bitwise on the same numpy problems; the full-matrix
`solve_assignment` and the device-routed `solve_assignment_sub_fast`
against JAX's on tests/test_assignment.py's cases."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy.optimize import linear_sum_assignment

from vehicle_counting_tpu.ops.pallas.assignment import _insert_rows_pallas_batched
from vehicle_counting_tpu.tracking import assignment as jas
from vehicle_counting_tpu.tracking.assignment import _insert_rows as j_insert_rows
from vehicle_counting_tpu.tracking.assignment import solve_uniform as j_solve_uniform
from vehicle_counting_tpu_torch.ops import assignment as tas
from vehicle_counting_tpu_torch.testing import clamp_tie_problems
from vehicle_counting_tpu_torch.tracking.assignment import (
    BIG,
    solve_assignment,
    solve_assignment_sub,
    solve_assignment_sub_fast,
)

C, S = 3, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six test workers at once, and
    more threads per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _total(cost, row_to_col):
    rows = np.nonzero(row_to_col >= 0)[0]
    return cost[rows, row_to_col[rows]].astype(np.float64).sum()


def _check_solve_assignment(cost):
    """The port's assignment equals JAX's (not only the total), all rows
    distinct, the total scipy's."""
    got = solve_assignment(torch.from_numpy(cost))
    want = np.asarray(jas.solve_assignment(jnp.asarray(cost)))
    assert got.dtype == torch.int64 and got.shape == (cost.shape[0],)
    np.testing.assert_array_equal(got.numpy(), want)
    assigned = got.numpy()[got.numpy() >= 0]
    assert len(set(assigned.tolist())) == assigned.size == min(cost.shape)
    return got.numpy()


# tests/test_assignment.py's shapes and the rectangular ones transposed
@pytest.mark.parametrize("n,m", [(1, 1), (3, 3), (5, 8), (8, 8), (16, 16), (32, 40), (8, 5), (40, 32)])
def test_solve_assignment_matches_jax(rng, n, m):
    for _ in range(8):
        cost = rng.uniform(0, 1, size=(n, m)).astype(np.float32)
        got = _check_solve_assignment(cost)
        ri, ci = linear_sum_assignment(cost)
        assert _total(cost, got) == pytest.approx(cost[ri, ci].astype(np.float64).sum(), abs=1e-5)


def test_solve_assignment_integer_costs_exact(rng):
    cost = rng.integers(0, 100, size=(12, 12)).astype(np.float32)
    got = _check_solve_assignment(cost)
    ri, ci = linear_sum_assignment(cost)
    assert _total(cost, got) == cost[ri, ci].sum()


def test_solve_assignment_masked_rows(rng):
    """2 real rows, 2 BIG rows, 3 real columns (clamped as min_cost_matching
    does): the real rows take the 2 x 3 optimum, as in JAX."""
    sub = np.minimum(rng.uniform(0, 0.5, size=(2, 3)).astype(np.float32), np.float32(0.2 + 1e-5))
    cost = np.full((4, 4), BIG, np.float32)
    cost[:2, :3] = sub
    got = _check_solve_assignment(cost)
    ri, ci = linear_sum_assignment(sub)
    assert (got[:2] < 3).all()
    assert _total(sub, got[:2]) == pytest.approx(sub[ri, ci].astype(np.float64).sum(), abs=1e-5)


def test_solve_assignment_loop_matches_vmap(rng):
    """JAX vmaps the solver over a batch; the port loops over it."""
    costs = rng.uniform(0, 1, size=(4, 10, 10)).astype(np.float32)
    want = np.asarray(jax.vmap(jas.solve_assignment)(jnp.asarray(costs)))
    got = np.stack([solve_assignment(torch.from_numpy(c)).numpy() for c in costs])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nr,nc", [(5, 11), (9, 9), (13, 6)])
def test_solve_assignment_sub_fast_matches_sub(nr, nc):
    """Compacted [S, S] costs with nr < nc, nr = nc and nr > nc (the
    transposed solve), clamp ties included: the routed solve equals the
    plain one and JAX's dispatcher."""
    rng = np.random.default_rng(nr * 31 + nc)
    cost = np.full((S, S), BIG, np.float32)
    cost[:nr, :nc] = rng.choice(np.float32([0.1, 0.3, 0.30001, 0.7]), (nr, nc))
    t = torch.from_numpy(cost)
    got = solve_assignment_sub_fast(t, nr, nc)
    assert got.dtype == torch.int64 and got.shape == (S,)
    np.testing.assert_array_equal(got.numpy(), solve_assignment_sub(t, nr, nc).numpy())
    np.testing.assert_array_equal(got.numpy(), solve_assignment_sub_fast(t, torch.tensor(nr), torch.tensor(nc)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jas.solve_assignment_sub_fast(jnp.asarray(cost), nr, nc)))


def test_solve_assignment_other_device_raises():
    """Off the CPU the solve goes to the kernel's wrapper, which launches or
    raises: it never falls back to the plain solver."""
    with pytest.raises(ValueError, match="unsupported device"):
        solve_assignment(torch.zeros((4, 4), device="meta"))


@pytest.mark.cuda
def test_solve_assignment_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the assignment kernel is CUDA C++ with no CPU mode")
    rng = np.random.default_rng(7)
    for shape in ((1, 1), (5, 8), (8, 5), (32, 40), (300, 1023), (1023, 300)):
        cost = torch.from_numpy(rng.random(shape, dtype=np.float32))
        before = tas.insert_rows_batched.launches
        got = solve_assignment(cost.cuda())
        assert tas.insert_rows_batched.launches == before + 1
        assert torch.equal(got.cpu(), solve_assignment(cost))
    with pytest.raises(ValueError, match="S <= 1023"):
        solve_assignment(torch.zeros((1024, 1024), device="cuda"))
