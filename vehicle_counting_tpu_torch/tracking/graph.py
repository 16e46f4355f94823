"""The per-frame tracker step over static buffers, replayed from a CUDA graph.

Counterpart of the `jax.jit` around the JAX package's frame scan
(`vehicle_counting_tpu/pipeline/step.py::tracker_scan`, a `lax.scan` inside
one compiled program): the frame step is a dozen launches
(`tracking/deepsort.py::frame_update`: the features' normalisation, the
gallery GEMM, kernel K9, the association, kernel K10), and launched one by
one the host, not the card, would set the frame rate. A `FrameRunner` owns
one frame's `FrameInputs`, every `TrackerState` leaf and one
`TrackerOutputs` slot as static tensors, captures

    frame_update(static state, static inputs) -> K10 writes the new
    state over the static leaves and the outputs into the static slot

once, and per frame copies the frame's inputs in, replays the graph and
copies the outputs into row i of the batch's output tensors. Everything
stays on the current stream; nothing is read back from the device.

On the CPU there is no graph: the runner runs the same body eagerly over
the same static buffers (K9's and K10's plain versions, K10's writing
its results over the buffers), which is how the CPU tests hold the buffer
logic against the plain loop.

A state the runner does not own is copied in first (a 15.7 MB bf16 gallery
at C=4, K=64, budget 60); the state it returns is its own static state, so
a caller that feeds it back pays no copy. There is no fallback: a capture
that fails raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vehicle_counting_tpu_torch.ops.assignment import match_stage_batched
from vehicle_counting_tpu_torch.ops.cascade import cascade_match_batched, cascade_match_classparallel
from vehicle_counting_tpu_torch.ops.track_frame import track_frame_post, track_frame_pre
from vehicle_counting_tpu_torch.tracking.deepsort import DeepSortParams, FrameInputs, frame_update, init_states
from vehicle_counting_tpu_torch.tracking.tracker import TrackerOutputs, TrackerState
from vehicle_counting_tpu_torch.utils.profiling import span

# the kernel wrappers a tracker step can launch: a replay launches what the
# capture recorded, so the runner adds the captured step's counts per replay
_COUNTED = (cascade_match_classparallel, cascade_match_batched, match_stage_batched, track_frame_pre,
            track_frame_post)
_WARMUP_STEPS = 2
# wrapper name -> launches made by captures' warm-up steps, on scratch
# state: real device launches that advance no tracker, kept out of the
# wrappers' `.launches` and summed here
warmup_launches = {}


class OwnedState(TrackerState):
    """A `TrackerState` whose leaves are a runner's static buffers, as `run`
    hands it out, with the runner's generation at that time."""

    generation = None


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """a is b, or a view of b's memory with b's shape, strides and dtype."""
    return a is b or (a.device == b.device and a.dtype == b.dtype and a.shape == b.shape
                      and a.stride() == b.stride() and a.data_ptr() == b.data_ptr())


def _static_inputs(hp: DeepSortParams, device) -> FrameInputs:
    """One frame's inputs with no detection in them."""
    c, k, f = hp.num_classes, hp.tracker.capacity, hp.tracker.feat_dim
    return FrameInputs(
        tlwh=torch.zeros((c, k, 4), device=device),
        scores=torch.zeros((c, k), device=device),
        valid=torch.zeros((c, k), dtype=torch.bool, device=device),
        feats=torch.zeros((c, k, f), device=device),
        present=torch.zeros((c,), dtype=torch.bool, device=device),
        order=torch.zeros((c, k), dtype=torch.int32, device=device),
    )


def _static_outputs(hp: DeepSortParams, device) -> TrackerOutputs:
    c, k = hp.num_classes, hp.tracker.capacity
    return TrackerOutputs(
        boxes=torch.zeros((c, k, 4), dtype=torch.int32, device=device),
        ids=torch.zeros((c, k), dtype=torch.int32, device=device),
        scores=torch.zeros((c, k), device=device),
        mask=torch.zeros((c, k), dtype=torch.bool, device=device),
    )


class FrameRunner:
    """`frame_update` for one (hp, out_hw, device), over static buffers: a
    captured CUDA graph on a CUDA device, the same body run eagerly on the
    CPU. The association route (`tracker.FORCE_PALLAS_CASCADE`) is fixed
    when the step is captured: build another runner for the other route.
    """

    def __init__(self, hp: DeepSortParams, out_hw: Tuple[int, int], device):
        self.hp, self.out_hw, self.device = hp, tuple(out_hw), torch.device(device)
        self.inp = _static_inputs(hp, self.device)
        self.state = init_states(hp, self.device)  # scratch until a caller's state is loaded
        self.out = _static_outputs(hp, self.device)
        self._generation = 0  # how many foreign states were loaded into the buffers
        self.replay_launches = {}  # wrapper -> launches one replay makes
        self.graph = None
        if self.device.type == "cuda":
            self._capture()

    def _body(self) -> None:
        """One frame on the static buffers: K10 writes the new state and
        the outputs over them."""
        frame_update(self.state, self.inp, self.hp, self.out_hw, out_state=self.state, out=self.out)

    def _capture(self) -> None:
        """Warm up on a side stream, then capture one step. Both run on the
        scratch state this runner starts with: the warm-up mutates the
        gallery in place, so the real state is loaded only afterwards
        (`run` copies it in). The kernels are built by the warm-up's
        launches, never inside the capture. The warm-up's launches advance
        no tracker (they go to `warmup_launches`) and the capture launches
        nothing, so the wrappers' counts are put back; a replay adds what
        the capture recorded."""
        before = [w.launches for w in _COUNTED]
        with torch.no_grad():
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(_WARMUP_STEPS):
                    self._body()
            torch.cuda.current_stream(self.device).wait_stream(side)
            warm = [w.launches for w in _COUNTED]
            self.graph = torch.cuda.CUDAGraph()
            # thread_local: another thread (the pipeline's upload worker) may allocate meanwhile.
            # The capture stream is this device's: torch.cuda.graph's default one is made once per
            # process, on whichever device was current then, and a capture on another card fails.
            with torch.cuda.graph(self.graph, stream=side, capture_error_mode="thread_local"):
                self._body()
        for w, b, m in zip(_COUNTED, before, warm):
            if w.launches > m:
                self.replay_launches[w] = w.launches - m
            if m > b:
                warmup_launches[w.__name__] = warmup_launches.get(w.__name__, 0) + m - b
            w.launches = b

    def _step(self) -> None:
        """One frame: the graph's replay, or the body on the CPU. Span:
        `track.replay`."""
        with span("track.replay"):
            if self.graph is None:
                self._body()
                return
            self.graph.replay()
        for w, n in self.replay_launches.items():
            w.launches += n

    def load_state(self, states: TrackerState) -> None:
        """Copy a caller's state into the static leaves (no aliasing: the
        caller's tensors are left as they are)."""
        for dst, src in zip(self.state, states):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(f"state leaf {tuple(src.shape)} {src.dtype} does not fit the runner's "
                                 f"{tuple(dst.shape)} {dst.dtype}")
            dst.copy_(src)

    def _owns(self, states: TrackerState) -> bool:
        """Whether `states` is the buffers themselves, so nothing is to be
        copied in. A leaf is a buffer when it is that tensor or a view of
        the same memory with the same shape and strides (the multi-camera
        step hands the buffers out as [N_cam, C, ...] views and gets them
        back reshaped). A state handed out before another was loaded is
        refused. A re-wrapped state (`TrackerState(*st)`, `st._replace(...)`)
        carries no generation: it is owned when every leaf is a buffer, and
        copied in leaf by leaf otherwise."""
        mine = [_same_memory(a, b) for a, b in zip(states, self.state)]
        generation = getattr(states, "generation", None)
        if any(mine) and generation is not None and generation != self._generation:
            raise RuntimeError("this tracker state was handed out by the runner before its buffers were "
                               "loaded with another state: it no longer holds what it held")
        return all(mine)

    def run(self, states: TrackerState, inp: FrameInputs):
        """The frames of `inp` (leaves [B, C, K, ...]) in order, from
        `states`. Returns (the runner's static state, TrackerOutputs with
        leaves [B, C, K, ...], freshly allocated)."""
        with torch.no_grad():
            if not self._owns(states):
                self.load_state(states)
                self._generation += 1
            b = inp.valid.shape[0]
            outs = TrackerOutputs(*(torch.empty((b,) + o.shape, dtype=o.dtype, device=self.device) for o in self.out))
            for i in range(b):
                for dst, src in zip(self.inp, inp):
                    dst.copy_(src[i])
                self._step()
                for dst, src in zip(outs, self.out):
                    dst[i].copy_(src)
        handed = OwnedState(*self.state)
        handed.generation = self._generation
        return handed, outs
