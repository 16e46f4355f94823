"""PyTorch port: every entry point that takes a device makes it the current
CUDA device around its launches (`utils/device.py::on_device`).

The kernel wrappers launch through `ctypes` on the thread's current CUDA
device with the stream of their tensors' device, so a run on `cuda:1`
outside the guard would launch with card 1's stream in card 0's context.
One card cannot show that, and the tests run without one: `torch.cuda.device`
is replaced by a recorder, the guard is told to enter it for the CPU device
too (`_needs_guard`), and each entry point's launching function is wrapped
to note which device was current when it ran. Each entry point must enter
the guard with its own device, and run its launches inside it.
(`chip_smoke.py --multi-card` runs the serial CLI on `cuda:1` against
`cuda:0` on the cards.)
"""

import contextlib
import types

import pytest
import torch

from test_torch_multicam_pipeline import _cams, _configs
from vehicle_counting_tpu_torch import bench, stage_bench
from vehicle_counting_tpu_torch.models.yolo import YoloConfig, init_yolov5
from vehicle_counting_tpu_torch.parallel import cameras
from vehicle_counting_tpu_torch.pipeline import CountingPipeline
from vehicle_counting_tpu_torch.pipeline import step as step_mod
from vehicle_counting_tpu_torch.pipeline.multicam import MultiCamCountingPipeline
from vehicle_counting_tpu_torch.serving.artifact import ServingArtifact, export_detect_step, save_artifact
from vehicle_counting_tpu_torch.utils import device as device_mod


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six test workers at once, and
    more threads per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Recorder:
    """Stands in for `torch.cuda.device`: records every device entered and
    keeps the stack of current ones."""

    def __init__(self):
        self.entered, self.stack, self.launches = [], [], []

    def __call__(self, device):
        rec = self

        @contextlib.contextmanager
        def ctx():
            rec.entered.append(str(device))
            rec.stack.append(str(device))
            try:
                yield
            finally:
                rec.stack.pop()

        return ctx()

    def probe(self, fn, name):
        def wrapped(*a, **k):
            self.launches.append((name, self.stack[-1] if self.stack else None))
            return fn(*a, **k)

        return wrapped


@pytest.fixture
def rec(monkeypatch):
    r = Recorder()
    monkeypatch.setattr(torch.cuda, "device", r)
    monkeypatch.setattr(device_mod, "_needs_guard", lambda device: True)
    return r


def _args(vids, out):
    return types.SimpleNamespace(weight=None, input_path=vids, output_path=str(out), device="cpu",
                                 mapping_dict=None, debug=False)


def test_guard_is_a_noop_on_the_cpu():
    assert isinstance(device_mod.on_device(torch.device("cpu")), contextlib.nullcontext)
    assert isinstance(device_mod.on_device("cpu"), contextlib.nullcontext)


def test_run_video_and_detect_only_enter_the_pipelines_device(rec, monkeypatch, tmp_path):
    vids, zones = _cams(tmp_path, [("cam_a", 1, 6)])
    cfg, cam = _configs(zones)
    pipe = CountingPipeline(_args(vids, tmp_path / "out"), cfg, cam)
    monkeypatch.setattr(step_mod, "pipeline_batch_step", rec.probe(step_mod.pipeline_batch_step, "step"))
    monkeypatch.setattr(step_mod, "detect_only_step", rec.probe(step_mod.detect_only_step, "detect"))
    pipe.run_video(pipe.all_video_paths[0], visualize=False)
    pipe.run_video_detect_only(pipe.all_video_paths[0])
    assert rec.entered == ["cpu", "cpu"]
    assert [n for n, _ in rec.launches] == ["step", "step", "detect", "detect"]  # 6 frames, batches of 4
    assert all(dev == "cpu" for _, dev in rec.launches)


def test_multicam_group_enters_the_pipelines_device(rec, monkeypatch, tmp_path):
    vids, zones = _cams(tmp_path, [("cam_a", 1, 4), ("cam_b", 2, 4)])
    cfg, cam = _configs(zones)
    real = cameras.make_multicam_step

    def make(mesh, **kw):
        return rec.probe(real(mesh, **kw), "multicam")

    monkeypatch.setattr(cameras, "make_multicam_step", make)
    res = MultiCamCountingPipeline(_args(vids, tmp_path / "out"), cfg, cam).run(visualize=False)
    assert all(r["error"] is None for r in res)
    assert rec.entered == ["cpu"] * 4  # one group, its mesh's device; the step's three passes, its shard's
    assert rec.launches == [("multicam", "cpu")]


def test_serving_step_enters_its_inputs_device(rec, monkeypatch, tmp_path):
    ycfg = YoloConfig("yolov5n", 80)
    yp = init_yolov5(torch.Generator().manual_seed(0), ycfg)
    kw = dict(image_size=(96, 96), src_hw=(48, 96), conf_thres=0.25, iou_thres=0.45, max_det=8)
    exp = export_detect_step(yp, ycfg=ycfg, batch=2, dtype=torch.float32, **kw)
    art = ServingArtifact.load(save_artifact(str(tmp_path / "det"), exported={"detect_step": exp}, ycfg=ycfg,
                                             config={"batch": 2, "src_hw": [48, 96], "image_size": [96, 96]},
                                             weights={"yolo": yp}))
    module, attr = exp.entry.split(":")
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, attr, rec.probe(getattr(mod, attr), "artifact"))
    yuv = torch.zeros((2, 72, 96), dtype=torch.uint8)
    art.detect_step(art.load_weights()["yolo"], yuv)
    assert rec.entered == ["cpu"]
    assert rec.launches == [("artifact", "cpu")]


@pytest.mark.parametrize("module", [bench, stage_bench])
def test_bench_entry_points_enter_their_device(rec, monkeypatch, module):
    seen = []
    monkeypatch.setattr(module, "_run", lambda args, dev, *a: seen.append((str(dev), list(rec.stack))))
    module.main(["--device", "cpu"])
    assert rec.entered == ["cpu"] and seen == [("cpu", ["cpu"])]


def test_on_device_passes_the_device_on(monkeypatch):
    """The guard hands its device to `torch.cuda.device` unchanged."""
    got = []
    monkeypatch.setattr(torch.cuda, "device", lambda d: got.append(d) or contextlib.nullcontext())
    with device_mod.on_device("cuda:1"):
        pass
    assert got == [torch.device("cuda", 1)]
