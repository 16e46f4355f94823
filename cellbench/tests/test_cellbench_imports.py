"""What the benchmark runs loads no JAX and not the JAX package; the
reference loads nothing of the port either."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _top_level_modules(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    mods = _top_level_modules(
        "import cellbench.run, cellbench.calibrate, cellbench.judge, cellbench.trace, cellbench.counts\n"
        "import vehicle_counting_tpu_torch.pipeline.step, vehicle_counting_tpu_torch.tracking.deepsort\n"
        "import vehicle_counting_tpu_torch.ops.letterbox, vehicle_counting_tpu_torch.utils.transfer")
    assert not mods & {"jax", "jaxlib", "flax", "vehicle_counting_tpu"}
    assert "vehicle_counting_tpu_torch" in mods


def test_the_reference_loads_nothing_of_the_port():
    mods = _top_level_modules("import cellbench.judge, cellbench.weights, cellbench.counts\n"
                              "from cellbench.reference import deepsort, pixels, reid, yolo")
    assert not mods & {"jax", "jaxlib", "flax", "vehicle_counting_tpu", "vehicle_counting_tpu_torch"}


def test_a_run_with_jax_loaded_prints_no_result():
    code = ("import sys, types\nsys.modules['jax'] = types.ModuleType('jax')\n"
            "from cellbench import run\nprint(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert "jax" in out.stdout
