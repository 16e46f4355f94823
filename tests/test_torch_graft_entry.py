"""PyTorch port, `vehicle_counting_tpu_torch/graft_entry.py` (the
counterpart of the root `__graft_entry__.py`) in-process on the CPU:
`entry` gives the flagship detect step with the JAX entry's output
contract, and `dryrun_multichip(2, "cpu")` runs its three parts over a CPU
mesh of two entries, each held against its serial counterpart (the port's
CPU mesh repeats the CPU device; the cards run it in `chip_smoke.py
--multi-card`)."""

import jax
import pytest
import torch

import __graft_entry__ as j_graft
from vehicle_counting_tpu_torch import graft_entry


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six test workers at once, and
    more threads per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_matches_the_jax_entry_contract():
    fn, args = graft_entry.entry("cpu")
    out = fn(*args)
    jfn, jargs = j_graft.entry()
    want = jax.eval_shape(jfn, *jargs)  # shapes and dtypes, nothing compiled
    assert set(out) == set(want)
    for k, v in want.items():
        assert tuple(out[k].shape) == tuple(v.shape), k
        assert str(out[k].dtype).replace("torch.", "") == str(v.dtype), k
    assert tuple(args[1].shape) == tuple(jargs[1].shape) and args[1].dtype == torch.uint8


def test_dryrun_multichip_on_a_cpu_mesh(capsys):
    out = graft_entry.dryrun_multichip(2, "cpu")
    lines = capsys.readouterr().out
    assert "dp train step ok on 2 devices" in lines
    assert "camera-parallel step ok: 2 cameras" in lines
    assert "flagship yolov5s-640 detect step ok: 2 frames" in lines
    assert out["multicam"]["tracks"] > 0 and out["multicam"]["capacity"] == 64
    assert out["detect"]["detections"] > 0
    assert out["dp_train"]["loss_data_parallel"] == pytest.approx(out["dp_train"]["loss_one_device"], rel=1e-4)


def test_entry_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
