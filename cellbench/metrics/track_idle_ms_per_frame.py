"""The device's idle time while the counting step's thread is in the tracker
layer's span (`tracker_scan`: the per-frame inputs, the frame graph's
replays): the gaps between operations of the device-only profiled window,
split over the program's layer spans on the trace's clock
(`cellbench/spans.py::idle_split`), per profiled frame, in ms."""


def read(r):
    from cellbench import spans

    return spans.idle_ms_per_frame(r, "track")
