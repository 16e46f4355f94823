"""The device's busy time of the kernels the counting step launched inside
its `track.replay` spans (each frame's replay of the tracker's CUDA graph,
or its eager step), per profiled frame, in ms: the union of their intervals
in the device-only profiled window, each kernel matched to its launch call
by correlation id (`cellbench/launch_spans.py`). None for a program without
the span."""

from cellbench import launch_spans


def read(r):
    return launch_spans.busy_ms_per_frame(r, "track.replay")
