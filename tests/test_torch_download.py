"""The detector's weight resolution in the port against the JAX package:
--weight, else ./.cache/<variant>.pt, else one fetch of the COCO
checkpoint into it, else the seed-0 random init (`utils/download.py`,
`CountingPipeline.__init__`).

Every test runs in its own temporary working directory, since ./.cache is
relative to it: a checkpoint left in the repo root would be loaded by
every later pipeline test. Both packages' fetches are replaced in every
test, so none reaches the network."""

import os
import sys
import types
import urllib.request

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX and PyTorch in one process: both at the top)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_weights import assert_trees_bitwise_equal

import vehicle_counting_tpu
import vehicle_counting_tpu.configs as jcfg
import vehicle_counting_tpu_torch
import vehicle_counting_tpu_torch.configs as pcfg
from vehicle_counting_tpu.pipeline import CountingPipeline as JaxPipeline
from vehicle_counting_tpu.utils import download as jdownload
from vehicle_counting_tpu_torch.models.convert import yolo_params_from_jax
from vehicle_counting_tpu_torch.models.yolo import YoloConfig, cast_params, init_yolov5
from vehicle_counting_tpu_torch.pipeline import CountingPipeline as PortPipeline
from vehicle_counting_tpu_torch.pipeline.multicam import MultiCamCountingPipeline
from vehicle_counting_tpu_torch.testing import fake_yolov5_state_dict
from vehicle_counting_tpu_torch.utils import download
from vehicle_counting_tpu_torch.version import __version__

VARIANT = "yolov5n"
CACHED = os.path.join(".cache", f"{VARIANT}.pt")
PACKAGES = {"jax": jdownload, "port": download}


class Offline(Exception):
    """What the replaced fetches raise: no test reaches the network."""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six test workers at once, and
    more threads per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fetches(tmp_path, monkeypatch):
    """A fresh working directory, and both packages' fetches (JAX's
    `urlretrieve`, the port's `urlopen`) replaced by a recorder that
    raises. Returns the URLs asked for."""
    monkeypatch.chdir(tmp_path)
    asked = []

    def refuse(url, *args, **kwargs):
        asked.append(url)
        raise Offline(f"no network in the tests: {url}")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    return asked


def _write_checkpoint(path):
    """A hub dict of fp16 tensors named and shaped like yolov5n's."""
    sd = fake_yolov5_state_dict(np.random.default_rng(7), VARIANT, 80)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"model": {k: torch.from_numpy(v).half() for k, v in sd.items()}}, path)


def _pipeline(cls, cfg_mod, **settings):
    cfg = cfg_mod.config_from_dict(cfg_mod.default_config(), {
        "model_name": VARIANT, "compute_dtype": "float32", "image_size": [160, 160], **settings})
    args = types.SimpleNamespace(weight=None, input_path=os.getcwd(), output_path="out", debug=False)
    if cls is not JaxPipeline:
        args.device = "cpu"
    return cls(args, cfg, cfg_mod.default_cam_config())


def test_cached_checkpoint_is_loaded_by_both_packages(fetches):
    """No --weight and ./.cache/yolov5n.pt present: both pipelines load
    the file without a fetch, and the port's tree is bitwise JAX's."""
    _write_checkpoint(CACHED)
    jp = _pipeline(JaxPipeline, jcfg)
    pp = _pipeline(PortPipeline, pcfg)
    assert fetches == []
    assert_trees_bitwise_equal(pp.yolo_params, yolo_params_from_jax(jp.yolo_params))
    assert pp.ycfg.num_classes == jp.ycfg.num_classes == 80
    assert pp.num_classes == jp.num_classes == 4  # nc > 8: the COCO vehicle mapping, as for --weight
    # --multicam builds the same pipeline
    assert_trees_bitwise_equal(MultiCamCountingPipeline(pp.args, pp.config, pp.cam_config).base.yolo_params,
                               pp.yolo_params)


def test_no_cache_and_a_failed_fetch_give_the_seed_0_init(fetches, capsys):
    pp = _pipeline(PortPipeline, pcfg)
    assert fetches == [download.WEIGHT_URLS[VARIANT]]
    want = cast_params(init_yolov5(torch.Generator().manual_seed(0), YoloConfig(variant=VARIANT, num_classes=80),
                                   "cpu"), torch.float32)
    assert_trees_bitwise_equal(pp.yolo_params, want)
    assert "no weights available; using a random-init detector (seed 0)" in capsys.readouterr().out
    assert not os.path.exists(CACHED)
    assert os.listdir(".cache") == []  # no partial file either


def test_a_fetch_lands_in_the_cache(monkeypatch, tmp_path):
    """The fetched body is moved to ./.cache/<name>.pt and that path is
    returned; the next call returns it with no fetch."""
    src = tmp_path / "served.pt"
    _write_checkpoint(str(src))
    timeouts = []

    def serve(url, timeout=None):
        assert url == download.WEIGHT_URLS[VARIANT]
        timeouts.append(timeout)
        return open(src, "rb")

    monkeypatch.setattr(urllib.request, "urlopen", serve)
    assert download.download_pretrained_weights(VARIANT) == CACHED
    assert timeouts == [download.FETCH_TIMEOUT_S]
    with open(CACHED, "rb") as got, open(src, "rb") as want:
        assert got.read() == want.read()
    assert os.listdir(".cache") == [f"{VARIANT}.pt"]
    monkeypatch.setattr(urllib.request, "urlopen", None)  # a second fetch would fail
    assert download.get_model_weights(VARIANT) == CACHED


def test_a_transfer_cut_midway_leaves_nothing(monkeypatch, capsys):
    class Cut:
        """A response whose body breaks off after its first block."""

        def __init__(self):
            self.sent = False

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def read(self, n=-1):
            if self.sent:
                raise ConnectionResetError("connection reset mid-transfer")
            self.sent = True
            return b"\x80" * 4096

    monkeypatch.setattr(urllib.request, "urlopen", lambda url, timeout=None: Cut())
    assert download.download_pretrained_weights(VARIANT) is None
    assert not os.path.exists(CACHED)
    assert os.listdir(".cache") == []
    assert "could not fetch" in capsys.readouterr().out


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_an_explicit_path_wins(pkg, fetches):
    _write_checkpoint(CACHED)
    assert PACKAGES[pkg].get_model_weights(VARIANT, "mine.pt") == "mine.pt"
    assert fetches == []


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_an_unknown_name_raises(pkg, fetches):
    with pytest.raises(ValueError, match="unknown model 'yolov9'"):
        PACKAGES[pkg].download_pretrained_weights("yolov9")
    assert fetches == [] and not os.path.exists(".cache")


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_a_cached_file_is_returned_without_a_fetch(pkg, fetches):
    _write_checkpoint(CACHED)
    assert PACKAGES[pkg].get_model_weights(VARIANT) == CACHED
    assert PACKAGES[pkg].download_pretrained_weights(VARIANT, cached="other.pt") is None  # `cached` names the file
    assert fetches == [PACKAGES[pkg].WEIGHT_URLS[VARIANT]]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_a_failed_fetch_returns_none(pkg, fetches, capsys):
    assert PACKAGES[pkg].get_model_weights("yolov5s") is None
    assert fetches == [PACKAGES[pkg].WEIGHT_URLS["yolov5s"]]
    assert f"[download] could not fetch {PACKAGES[pkg].WEIGHT_URLS['yolov5s']}" in capsys.readouterr().out
    assert not os.path.exists(os.path.join(".cache", "yolov5s.pt"))


def test_the_model_zoo_is_the_same():
    assert download.WEIGHT_URLS == jdownload.WEIGHT_URLS


def test_version():
    assert __version__ == vehicle_counting_tpu_torch.__version__ == vehicle_counting_tpu.__version__
