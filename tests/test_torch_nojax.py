"""The PyTorch port imports no JAX: every module imports with jax blocked."""

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
]


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("flag", ["--multicam", "--frame_parallel", "--detect_only", "--check_numerics",
                                  "--profile", "--weight=x.pt"])
def test_cli_unported_flags_raise(flag, tmp_path):
    from vehicle_counting_tpu_torch import run

    args = run.parser.parse_args(["--input_path", "v.mp4", "--output_path", str(tmp_path), flag])
    with pytest.raises(SystemExit, match="not yet ported"):
        run.main(args, None, None)
