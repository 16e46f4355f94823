"""The PyTorch port imports no JAX and nothing of the JAX package: every
module imports with `jax` and `vehicle_counting_tpu` blocked, and no source
file of the port names either in an import."""

import ast
import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "vehicle_counting_tpu_torch",
    "vehicle_counting_tpu_torch._build",
    "vehicle_counting_tpu_torch.testing",
    "vehicle_counting_tpu_torch.ops",
    "vehicle_counting_tpu_torch.ops.letterbox",
    "vehicle_counting_tpu_torch.ops.boxes",
    "vehicle_counting_tpu_torch.ops.nms",
    "vehicle_counting_tpu_torch.ops.crops",
    "vehicle_counting_tpu_torch.ops.cascade",
    "vehicle_counting_tpu_torch.ops.assignment",
    "vehicle_counting_tpu_torch.ops.reid_block",
    "vehicle_counting_tpu_torch.ops.conv_s2",
    "vehicle_counting_tpu_torch.models.layers",
    "vehicle_counting_tpu_torch.models.yolo",
    "vehicle_counting_tpu_torch.models.detector",
    "vehicle_counting_tpu_torch.models.reid",
    "vehicle_counting_tpu_torch.models.convert",
    "vehicle_counting_tpu_torch.tracking.kalman",
    "vehicle_counting_tpu_torch.tracking.assignment",
    "vehicle_counting_tpu_torch.tracking.tracker",
    "vehicle_counting_tpu_torch.tracking.deepsort",
    "vehicle_counting_tpu_torch.pipeline",
    "vehicle_counting_tpu_torch.pipeline.step",
    "vehicle_counting_tpu_torch.run",
    "vehicle_counting_tpu_torch.utils.profiling",
    "vehicle_counting_tpu_torch.utils.colors",
    "vehicle_counting_tpu_torch.utils.device",
    "vehicle_counting_tpu_torch.utils.transfer",
    "vehicle_counting_tpu_torch.configs",
    "vehicle_counting_tpu_torch.counting",
    "vehicle_counting_tpu_torch.counting.polygon",
    "vehicle_counting_tpu_torch.counting.counter",
    "vehicle_counting_tpu_torch.counting.visualize",
    "vehicle_counting_tpu_torch.data",
    "vehicle_counting_tpu_torch.data.video",
    "vehicle_counting_tpu_torch.ops.noop",
    "vehicle_counting_tpu_torch.tools.profile_summary",
    "vehicle_counting_tpu_torch.benchmarks.load",
    "vehicle_counting_tpu_torch.benchmarks.micro.noop_launch",
    "vehicle_counting_tpu_torch.bench",
    "vehicle_counting_tpu_torch.stage_bench",
]


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['vehicle_counting_tpu'] = None\n"
        "import importlib\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('jax', 'vehicle_counting_tpu') for k, v in sys.modules.items()"
        " if v is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def _port_sources():
    files = glob.glob(os.path.join(REPO, "vehicle_counting_tpu_torch", "**", "*.py"), recursive=True)
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py")]


def test_port_sources_found():
    names = {os.path.relpath(f, REPO) for f in _port_sources()}
    assert len(names) > 40
    for m in PORT_MODULES[1:]:
        base = m.replace(".", os.sep)
        assert base + ".py" in names or os.path.join(base, "__init__.py") in names, m


def test_no_source_imports_the_jax_package():
    """ast, not grep: strings such as chip_smoke's `replaces=` fields may
    name the JAX package, imports may not."""
    banned = ("jax", "jaxlib", "flax", "optax", "vehicle_counting_tpu")
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {m}" for m in mods if m.split(".")[0] in banned]
    assert not bad, bad


@pytest.mark.parametrize("flag", ["--multicam", "--frame_parallel", "--detect_only"])
def test_cli_unported_flags_raise(flag, tmp_path):
    from vehicle_counting_tpu_torch import run

    args = run.parser.parse_args(["--input_path", "v.mp4", "--output_path", str(tmp_path), flag])
    with pytest.raises(SystemExit, match="not yet ported"):
        run.main(args, None, None)
