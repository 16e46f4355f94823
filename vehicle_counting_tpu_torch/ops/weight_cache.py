"""Kernel-layout weights kept per source tensor (kernels K5, K6 and K8).

K5's kernels (`ops/reid_block.py`) and K6's bf16 kernel (`ops/conv_s2.py`)
take their weights in layouts of their own. Packing costs a few device
kernels per call, more than K6's whole launch at small shapes, so the
wrappers pack through `cached`, which keeps each result while its source
tensors live and stay unchanged. The ReID trunk keeps the same way each BN
layer's rsqrt(var + eps) for K8 (`ops/reid_epilogue.py::bn_inv`) and each
conv weight in channels-last order (`models/reid.py::_conv_weight`).

The key is each source tensor's identity, checked on every hit: a weak
reference to it, its `_version` (moved by every in-place update, and shared
with its views), device, dtype, shape and data pointer. The address alone
would not do: PyTorch's caching allocator hands a freed block to the next
tensor, which would then get the dead one's pack. A dead source drops its
entries through the weak reference's callback, and at most `MAX_ENTRIES`
are kept, the least recently used going first. An inference tensor keeps no
version counter, so its packs are made anew on every call.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Callable, Hashable, Sequence

import torch

MAX_ENTRIES = 256  # the ReID trunk alone keeps 37 per weight set, one set per card

_ENTRIES: "OrderedDict[tuple, tuple]" = OrderedDict()
_LOCK = threading.RLock()  # re-entrant: a weak reference's callback may run while it is held


def _state(t: torch.Tensor):
    """What must be as it was when the pack was made; None where the
    tensor keeps no version counter."""
    try:
        version = t._version
    except RuntimeError:  # an inference tensor
        return None
    return version, t.device, t.dtype, t.shape, t.data_ptr()


def _drop(key, ref) -> None:
    """Remove `key`'s entry if it is still the one `ref`'s tensor keyed."""
    with _LOCK:
        entry = _ENTRIES.get(key)
        if entry is not None and any(r is ref for r in entry[0]):
            del _ENTRIES[key]


def cached(tag: Hashable, sources: Sequence[torch.Tensor], make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """`make()`, computed from `sources` (what `tag` names), or the value
    kept from an earlier call on the same, unchanged source tensors."""
    states = [_state(t) for t in sources]
    if None in states:
        return make()
    key = (tag, *map(id, sources))
    with _LOCK:  # the hit path, on every launch: no generator expressions
        entry = _ENTRIES.get(key)
        if entry is not None and entry[1] == states:
            for ref, t in zip(entry[0], sources):
                if ref() is not t:
                    break
            else:
                _ENTRIES.move_to_end(key)
                return entry[2]
    with torch.no_grad():  # a pack holds no graph, so nothing keeps its sources alive
        value = make()
    refs = [weakref.ref(t, lambda ref, key=key: _drop(key, ref)) for t in sources]
    with _LOCK:
        _ENTRIES[key] = (refs, states, value)
        _ENTRIES.move_to_end(key)
        while len(_ENTRIES) > MAX_ENTRIES:
            _ENTRIES.popitem(last=False)
    return value


def size() -> int:
    """How many packs are kept."""
    with _LOCK:
        return len(_ENTRIES)
