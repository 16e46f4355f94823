"""PyTorch port, the wrappers' shared launch path: `_build.entry` resolves a
C entry point and sets its types once, then hands back the cached function.
Stub library objects stand in for a built kernel: no nvcc is needed."""

import ctypes

import pytest

from vehicle_counting_tpu_torch import _build
from vehicle_counting_tpu_torch.ops import assignment, cascade, conv_s2, crops, noop, reid_block
from vehicle_counting_tpu_torch.testing import one_torch_thread

_one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


class _Fn:
    """Counts how often its types are set."""

    def __init__(self):
        self.sets = 0
        self._argtypes = None
        self.restype = None

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self.sets += 1
        self._argtypes = value


class _Lib:
    def __init__(self):
        self.lookups = 0
        self.vct_stub = _Fn()
        self.vct_other = _Fn()

    def __getattribute__(self, name):
        if name.startswith("vct_"):
            object.__setattr__(self, "lookups", object.__getattribute__(self, "lookups") + 1)
        return object.__getattribute__(self, name)


def test_entry_sets_argtypes_once_and_returns_the_cached_function():
    lib = _Lib()
    types = [ctypes.c_void_p, ctypes.c_int]
    fn = _build.entry(lib, "vct_stub", types)
    assert fn is lib.__dict__["vct_stub"]
    assert fn.restype is ctypes.c_int and fn.argtypes == types and fn.sets == 1
    for _ in range(3):
        assert _build.entry(lib, "vct_stub", types) is fn
    assert fn.sets == 1 and lib.lookups == 1  # resolved and typed at the first call only


def test_entry_keeps_symbols_and_libraries_apart():
    a, b = _Lib(), _Lib()
    fa = _build.entry(a, "vct_stub", [ctypes.c_int])
    fo = _build.entry(a, "vct_other", [ctypes.c_void_p])
    fb = _build.entry(b, "vct_stub", [ctypes.c_float])
    assert fa is not fo and fa is not fb
    assert fa.argtypes == [ctypes.c_int] and fo.argtypes == [ctypes.c_void_p] and fb.argtypes == [ctypes.c_float]


def test_entry_by_name_loads_the_library_once(monkeypatch):
    lib, loads = _Lib(), []
    monkeypatch.setattr(_build, "load", lambda name: loads.append(name) or lib)
    monkeypatch.setattr(_build, "_ENTRIES", {})
    fn = _build.entry("stub_kernel", "vct_stub", [ctypes.c_int])
    assert _build.entry("stub_kernel", "vct_stub", [ctypes.c_int]) is fn
    assert loads == ["stub_kernel"] and fn.sets == 1


def test_entry_raises_on_a_missing_symbol():
    with pytest.raises(AttributeError):
        _build.entry(_Lib(), "vct_missing", [])


@pytest.mark.parametrize("module, n_args", [(crops, 18), (conv_s2, 9), (cascade, 21), (assignment, 6),
                                            (reid_block, 7), (noop, 4)])
def test_wrappers_declare_their_argtypes_once(module, n_args):
    """Every wrapper hands `_build.entry` one module-level list: pointers
    and the stream as c_void_p (an untyped Python int would be cut to 32
    bits), the stream last."""
    types = module._ARGTYPES
    assert len(types) == n_args and types[-1] is ctypes.c_void_p
    assert set(types) <= {ctypes.c_void_p, ctypes.c_int, ctypes.c_float}


def test_fused_stage_entry_declares_its_argtypes():
    """K4's second entry (`vct_match_stage`): seven pointers, C, K, the
    threshold and its clamp, the stream last."""
    types = assignment._STAGE_ARGTYPES
    assert len(types) == 12 and types[-1] is ctypes.c_void_p
    assert types[:7] == [ctypes.c_void_p] * 7 and types[7:11] == [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float]
