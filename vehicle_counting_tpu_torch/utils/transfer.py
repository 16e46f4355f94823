"""Host->device transfer helpers.

A batch of 128 thin-upload frames (720p -> 384x640 content-row I420,
345,600 B each) is 44 MB. `parallel_device_put` stages it in pinned host
memory and copies it with `non_blocking` copies on CUDA streams of its
own, so the copy neither queues behind the step's kernels on the compute
stream nor blocks the thread that starts it. The batch is cut into
`streams` chunks along axis 0, one copy stream each; over one PCIe link
the chunks share the same bandwidth, so more streams buy overlap of the
staging memcpy with the DMA, not a faster link. The consumer's stream
waits on one event per chunk before it reads the tensor.

One pinned staging buffer per (shape, dtype) is kept and reused, two deep
in turns (0, 1, 0, 1, ...), each guarded by the events of the copies that
last read it: the caller may upload batch i+1 while batch i's copy is
still in flight. The chunks are slices of that one buffer.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from vehicle_counting_tpu_torch.utils.profiling import spanned

_SMALL_BYTES = 1 << 21
_LOCK = threading.Lock()
_COPY_STREAMS: Dict[torch.device, List["torch.cuda.Stream"]] = {}
# (device, shape, dtype) -> {"bufs": [pinned tensor, ...], "events": [[event, ...], ...], "turn": int}
_STAGING: Dict[tuple, dict] = {}
_STAGING_DEPTH = 2


def upload_streams_default() -> int:
    return int(os.environ.get("VCT_UPLOAD_STREAMS", "4"))


def _copy_streams(dev, n: int):
    have = _COPY_STREAMS.setdefault(dev, [])
    while len(have) < n:
        have.append(torch.cuda.Stream(dev))
    return have[:n]


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


def _staging(dev, x: np.ndarray, pin: bool = True):
    """(pinned buffer shaped like x, its list of guarding events, emptied):
    the buffer whose turn it is, once the copies that last read it have
    finished (their events are waited for on the host)."""
    slot = _STAGING.setdefault((dev, x.shape, x.dtype.str), {"bufs": [], "events": [], "turn": -1})
    turn = slot["turn"] = (slot["turn"] + 1) % _STAGING_DEPTH
    if turn == len(slot["bufs"]):
        slot["bufs"].append(torch.empty(x.shape, dtype=_torch_dtype(x.dtype), pin_memory=pin))
        slot["events"].append([])
    for ev in slot["events"][turn]:
        ev.synchronize()
    slot["events"][turn].clear()
    return slot["bufs"][turn], slot["events"][turn]


@spanned("feed.upload")
def parallel_device_put(x: np.ndarray, streams: Optional[int] = None, device=None,
                        timing: Optional[list] = None) -> torch.Tensor:
    """`x` as a tensor on `device` (default: the current CUDA device).

    On a CUDA device: pinned staging, `streams` chunk copies on copy
    streams of their own, and the calling thread's current stream made to
    wait for their events, so work queued on it afterwards sees the data
    while work queued before is not held up. The tensor is allocated on
    the first copy stream, never on the consumer's: its memory was last
    used by an earlier upload, not by a kernel the copy would have to wait
    for. Small arrays (< 2 MiB), a 1-stream setting and inputs with fewer
    rows than streams go as one chunk. On the CPU the tensor shares `x`'s
    memory.

    `timing`, when a list, gets one `(start, [done, ...], nbytes)` of timed
    CUDA events per upload: `upload_gbps` turns it into a rate. Each call
    is a `feed.upload` span.
    """
    x = np.asarray(x)
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        return torch.from_numpy(x)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    n = upload_streams_default() if streams is None else int(streams)
    if n <= 1 or x.ndim < 1 or x.shape[0] < n or x.nbytes < _SMALL_BYTES:
        n = 1
    x = np.ascontiguousarray(x)
    if x.ndim == 0 or x.size == 0:
        return torch.from_numpy(x).to(dev)
    bounds = np.linspace(0, x.shape[0], n + 1).astype(int)
    consumer = torch.cuda.current_stream(dev)
    timed, dones, start = timing is not None, [], None
    with _LOCK:
        sides = _copy_streams(dev, n)
        with torch.cuda.stream(sides[0]):
            out = torch.empty(x.shape, dtype=_torch_dtype(x.dtype), device=dev)
            allocated = torch.cuda.Event()
            allocated.record(sides[0])
        buf, guards = _staging(dev, x)
        for i, side in enumerate(sides):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            buf[lo:hi].numpy()[...] = x[lo:hi]  # host memcpy into pinned memory
            if i:
                side.wait_event(allocated)
                out.record_stream(side)
            with torch.cuda.stream(side):
                if timed and not i:
                    start = torch.cuda.Event(enable_timing=True)
                    start.record(side)
                out[lo:hi].copy_(buf[lo:hi], non_blocking=True)
                done = torch.cuda.Event(enable_timing=timed)
                done.record(side)
            guards.append(done)
            dones.append(done)
            consumer.wait_event(done)
        out.record_stream(consumer)
    if timed:
        timing.append((start, dones, x.nbytes))
    return out


def upload_gbps(record) -> float:
    """GB/s of one finished upload from its `timing` record: its bytes over
    the span from the first chunk's copy starting to the last chunk's copy
    ending on the card's clock. With several chunks the span holds the host
    memcpy that stages the later chunks; with one it is the DMA alone."""
    start, dones, nbytes = record
    for d in dones:
        d.synchronize()
    return nbytes / (max(start.elapsed_time(d) for d in dones) * 1e-3) / 1e9
