"""Cells, configurations, traffic mixes and per-layer metrics are found by
the names in BENCHMARK.json; a new one is added by new files alone."""

import json
import os

import pytest

from cellbench import run
from cellbench.tests.tiny import make_root


def test_every_cell_of_the_benchmark_resolves():
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for cell in bench["workloads"]:
        spec = run.Spec(run.ROOT, cell["name"])
        assert spec.cfg["name"] == cell["config"] and spec.traffic["name"] == cell["traffic"]
        assert set(spec.readers) == {m["name"] for m in bench["per_layer"]}
        assert {m["name"] for m in spec.end_to_end} == {"device_busy_ms_per_frame", "setup_s"}


@pytest.mark.parametrize("what", ["workload", "config", "traffic", "limits", "metric"])
def test_an_unknown_name_is_refused(tmp_path, what):
    root = make_root(tmp_path)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    name = "tiny-dense"
    if what == "workload":
        name = "no-such-cell"
    elif what == "config":
        bench["workloads"][0]["config"] = "no-such-config"
    elif what == "traffic":
        bench["workloads"][0]["traffic"] = "no-such-mix"
    elif what == "limits":
        os.remove(os.path.join(root, "cellbench", "limits", "tiny-dense.json"))
    else:
        bench["per_layer"].append(dict(bench["per_layer"][0], name="no_such_metric"))
    with open(path, "w") as f:
        json.dump(bench, f)
    with pytest.raises((SystemExit, FileNotFoundError)):
        run.Spec(root, name)


def test_a_value_the_harness_cannot_run_is_refused(tmp_path):
    root = make_root(tmp_path)
    mix = os.path.join(root, "cellbench", "traffic", "tiny.json")
    with open(mix) as f:
        data = json.load(f)
    data["cameras"] = 4
    with open(mix, "w") as f:
        json.dump(data, f)
    with pytest.raises(SystemExit, match="cameras=4"):
        run.Spec(root, "tiny-dense")


def test_new_config_mix_and_metric_by_new_files_alone(tmp_path):
    """A throwaway configuration, mix and per-layer metric added to a copy
    as files and BENCHMARK.json entries, no existing file of cellbench/
    edited, run end to end at the CPU size."""
    import io
    from contextlib import redirect_stdout

    root = make_root(tmp_path)
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    cb = os.path.join(root, "cellbench")
    with open(os.path.join(cb, "tests", "data", "tiny.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny-b2"
    cfg["batch"] = 2
    with open(os.path.join(cb, "configs", "tiny-b2.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(cb, "traffic", "tiny.json")) as f:
        mix = json.load(f)
    mix["name"] = "tiny2"
    mix["calibration"]["per_frame"] = 2
    with open(os.path.join(cb, "traffic", "tiny2.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(cb, "limits", "tiny-dense.json")) as f:
        limits = f.read()
    with open(os.path.join(cb, "limits", "tiny2-b2.json"), "w") as f:
        f.write(limits)
    with open(os.path.join(cb, "metrics", "batches_per_s.py"), "w") as f:
        f.write("def read(r):\n    return len(r.feed_wait_s) / r.window_s\n")
    bench["configs"].append({"name": "tiny-b2", "source": "https://example.org", "file": "cellbench/configs/tiny-b2.json",
                             "reduced": [], "why": "a throwaway"})
    bench["workloads"].append({"name": "tiny2-b2", "config": "tiny-b2", "traffic": "tiny2", "chips": 1,
                               "why": "a throwaway"})
    bench["per_layer"].append({"name": "batches_per_s", "unit": "1/s", "better": "higher", "source": "host_clock",
                               "layer": "host feed", "moves": "device_busy_ms_per_frame", "workloads": ["tiny2-b2"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", "tiny2-b2", "--seed", "5", "--seconds", "1", "--trace", "1"], device="cpu",
                      root=root)
    assert rc == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["metrics"]["batches_per_s"]["value"] > 0
    assert res["attempted"] % 2 == 0
