"""The device's idle time while the counting step's thread is in the detect
layer's span (`detect_front`: pixels, the network, the NMS tail): the gaps
between operations of the device-only profiled window, split over the
program's layer spans on the trace's clock
(`cellbench/spans.py::idle_split`), per profiled frame, in ms."""


def read(r):
    from cellbench import spans

    return spans.idle_ms_per_frame(r, "detect")
