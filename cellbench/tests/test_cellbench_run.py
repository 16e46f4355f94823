"""The harness end to end at a CPU size: one contract line, the faults it
must catch, the control, the traced run's line."""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from cellbench import run
from cellbench.tests.tiny import make_root

ARGS = ["--workload", "tiny-dense", "--seed", str(2 ** 31 + 11), "--seconds", "1.5"]


def _line(root, trace=0, fault=None, args=ARGS):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(args + ["--trace", str(trace)], device="cpu", fault=fault, root=root)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("cellbench"))


def test_one_contract_line(root):
    res = _line(root)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    # the card's busy time per frame is read from a device trace: the CPU has none
    assert set(res["metrics"]) == {"setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())


def test_traced_line_holds_the_host_metrics(root):
    # a window of no length holds the harness's least number of batches,
    # two, however slow the CPU: the p90 reader has two batches to read
    res = _line(root, trace=1, args=ARGS[:-1] + ["0"])
    assert res["correct"] is True
    # on the CPU only the host clock's metrics have something to read
    assert set(res["metrics"]) == {"host_frames_per_s", "feed_wait_ms", "batch_latency_p90_ms"}


@pytest.mark.parametrize("fault", ["state", "half", "answer"])
def test_a_planted_fault_is_not_correct(root, fault):
    """A step that returns its state unchanged, half of each batch left
    out, one detection's feature altered where it is produced."""
    assert _line(root, fault=fault)["correct"] is False


def test_the_control_fails_a_limit(root):
    spec = run.Spec(root, "tiny-dense")
    res = run.run(spec, 2 ** 31 + 13, 1.0, 0, torch.device("cpu"), control=True, log=lambda *a, **k: None)
    assert any(res["control"][k] > c["limit"] for k, c in res["checks"].items()), res["control"]


@pytest.mark.cuda
def test_the_control_on_the_card_fails_every_seed():
    """The control at the cell's own size on three seeds (run on the chip:
    `python3 cellbench/calibrate.py --workload s640-dense --seeds ... --control`
    prints the same readings)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = run.Spec(run.ROOT, "s640-dense")
    for seed in (2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23):
        res = run.run(spec, seed, 3.0, 0, torch.device("cuda", 0), control=True, log=lambda *a, **k: None)
        assert any(res["control"][k] > c["limit"] for k, c in res["checks"].items()), res["control"]


@pytest.mark.parametrize("allowed, split", [
    ({0, 1, 2, 3, 4, 5, 6, 7}, ({7}, {0, 1, 2, 3, 4, 5, 6})),
    ({2, 5}, ({5}, {2})),
    ({3}, None),
])
def test_the_main_thread_gets_a_core_of_its_own(allowed, split):
    assert run.split_cores(allowed) == split
