"""A checkout in a temporary directory whose BENCHMARK.json holds one
CPU-sized cell, `tiny-dense`: the benchmark's own files, the tiny
configuration of `data/tiny.json`, the `dense` mix with the threshold at
the 3rd score, and the limits of `s640-dense`."""

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def make_root(tmp):
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(os.path.join(ROOT, "cellbench"), os.path.join(root, "cellbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "tiny", "source": "https://github.com/ultralytics/yolov5/blob/v6.0/models/yolov5n.yaml",
                         "file": "cellbench/tests/data/tiny.json", "reduced": [], "why": "a CPU test's size"}]
    bench["workloads"] = [{"name": "tiny-dense", "config": "tiny", "traffic": "tiny", "chips": 1,
                           "why": "a CPU test's size"}]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    traffic = os.path.join(root, "cellbench", "traffic")
    with open(os.path.join(traffic, "dense.json")) as f:
        mix = json.load(f)
    mix.update(name="tiny")
    mix["calibration"]["per_frame"] = 3
    with open(os.path.join(traffic, "tiny.json"), "w") as f:
        json.dump(mix, f)
    shutil.copy(os.path.join(root, "cellbench", "limits", "s640-dense.json"),
                os.path.join(root, "cellbench", "limits", "tiny-dense.json"))
    return root
