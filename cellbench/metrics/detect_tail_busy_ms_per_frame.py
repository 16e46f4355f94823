"""The device's busy time of the kernels the counting step launched inside
its `detect.tail` span (the fused decode and NMS tail, the boxes' restore
and the class map), per profiled frame, in ms: the union of their
intervals in the device-only profiled window, each kernel matched to its
launch call by correlation id (`cellbench/launch_spans.py`)."""

from cellbench import launch_spans


def read(r):
    return launch_spans.busy_ms_per_frame(r, "detect.tail")
