"""The PyTorch port imports no JAX and nothing of the JAX package: every
module imports with `jax` and `vehicle_counting_tpu` blocked, and no source
file of the port names either in an import."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from vehicle_counting_tpu_torch.testing import one_torch_thread

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

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
    "vehicle_counting_tpu_torch.evaluation",
    "vehicle_counting_tpu_torch.ops.fusion",
    "vehicle_counting_tpu_torch.tracking.graph",
    "vehicle_counting_tpu_torch.parallel",
    "vehicle_counting_tpu_torch.parallel.cameras",
    "vehicle_counting_tpu_torch.pipeline.multicam",
    "vehicle_counting_tpu_torch.parallel.mesh",
    "vehicle_counting_tpu_torch.parallel.frames",
    "vehicle_counting_tpu_torch.serving",
    "vehicle_counting_tpu_torch.serving.artifact",
    "vehicle_counting_tpu_torch.serving.cli",
    "vehicle_counting_tpu_torch.train",
    "vehicle_counting_tpu_torch.train.reid_train",
    "vehicle_counting_tpu_torch.train.augment",
    "vehicle_counting_tpu_torch.train.data",
    "vehicle_counting_tpu_torch.train.reid_cli",
    "vehicle_counting_tpu_torch.utils.seed",
    "vehicle_counting_tpu_torch.utils.registry",
    "vehicle_counting_tpu_torch.utils.debug_draw",
    "vehicle_counting_tpu_torch.utils.download",
    "vehicle_counting_tpu_torch.version",
    "vehicle_counting_tpu_torch.tools.convert_weights",
    "vehicle_counting_tpu_torch.tools.cocosplit",
    "vehicle_counting_tpu_torch.tools.split_csv",
    "vehicle_counting_tpu_torch.tools.split_images",
    "vehicle_counting_tpu_torch.tools.yolo2coco",
    "vehicle_counting_tpu_torch.tools.e2e_smoke",
    "vehicle_counting_tpu_torch.tools.egress_day",
    "vehicle_counting_tpu_torch.benchmarks.soak",
    "vehicle_counting_tpu_torch.graft_entry",
    "vehicle_counting_tpu_torch._lazy",
    "vehicle_counting_tpu_torch.models",
    "vehicle_counting_tpu_torch.tracking",
    "vehicle_counting_tpu_torch.utils",
]
# packages whose names resolve lazily (`_lazy.py`): each name of `__all__`,
# and the top level's CountingPipeline
PUBLIC_PACKAGES = [
    "vehicle_counting_tpu_torch",
    "vehicle_counting_tpu_torch.ops",
    "vehicle_counting_tpu_torch.models",
    "vehicle_counting_tpu_torch.tracking",
    "vehicle_counting_tpu_torch.utils",
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


def test_public_names_resolve_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['vehicle_counting_tpu'] = None\n"
        "import importlib\n"
        "n = 0\n"
        f"for m in {PUBLIC_PACKAGES!r}:\n"
        "    pkg = importlib.import_module(m)\n"
        "    for name in pkg.__all__:\n"
        "        getattr(pkg, name)\n"
        "        n += 1\n"
        "importlib.import_module('vehicle_counting_tpu_torch').CountingPipeline\n"
        "assert n == 48, n  # 47 re-exported names of the JAX inits, and ops.true_div\n"
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


def _tiny_videos(tmp_path, n_videos):
    """n_videos 3-frame 64x48 videos in one directory, with zone files."""
    import json

    import cv2
    import numpy as np

    vids, zones = tmp_path / "vids", tmp_path / "zones"
    vids.mkdir()
    zones.mkdir()
    for v in range(n_videos):
        writer = cv2.VideoWriter(str(vids / f"tiny{v}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (64, 48))
        for i in range(3):
            writer.write(np.full((48, 64, 3), 40 * i + v, np.uint8))
        writer.release()
        (zones / f"tiny{v}.json").write_text(json.dumps({"shapes": [
            {"label": "zone", "points": [[0, 0], [64, 0], [64, 48], [0, 48]]},
            {"label": "direction01", "points": [[0, 24], [64, 24]]}]}))
    return str(vids), str(zones)


def _tiny_run(run, tmp_path, flag):
    """`--detect_only` or `--frame_parallel` on one 3-frame 64x48 video, or
    `--multicam` on two, random-init yolov5n at 64x64 on the CPU: it runs
    and writes the detections CSV's header, or the counting CSV's."""
    from vehicle_counting_tpu_torch.configs import config_from_dict, default_cam_config, default_config

    vids, zones = _tiny_videos(tmp_path, 2 if flag == "--multicam" else 1)
    inp = vids if flag == "--multicam" else os.path.join(vids, "tiny0.mp4")
    args = run.parser.parse_args(["--input_path", inp, "--output_path", str(tmp_path / "out"), "--device", "cpu",
                                  "--no_visualize", flag])
    config = config_from_dict(default_config(), {"model_name": "yolov5n", "image_size": [64, 64], "detect_batch": 2,
                                                  "compute_dtype": "float32", "max_det": 8})
    cam_config = default_cam_config()
    cam_config.zone_path = zones
    results = run.main(args, config, cam_config)
    if flag == "--multicam":
        assert [r["camera"] for r in results] == ["tiny0", "tiny1"]
        for r in results:
            assert r["error"] is None and r["frames"] == 3
            with open(r["csv"]) as f:
                assert f.readline().strip().startswith("track_id,frame_id,box")
        return
    (res,) = results
    if flag == "--frame_parallel":
        assert res["frames"] == 3 and config.frame_parallel
        with open(res["csv"]) as f:
            assert f.readline().strip().startswith("track_id,frame_id,box")
        return
    assert res["frames"] == 3 and os.path.basename(res["csv"]) == "tiny0_detections.csv"
    with open(res["csv"]) as f:
        assert f.readline().strip() == "frame_id,x1,y1,x2,y2,score,label"


@pytest.mark.parametrize("flag", ["--multicam", "--frame_parallel", "--detect_only"])
def test_cli_unported_flags_raise(flag, tmp_path):
    """Every flag of the JAX CLI is ported now: each of them runs (none
    raises "not yet ported")."""
    from vehicle_counting_tpu_torch import run

    _tiny_run(run, tmp_path, flag)
