"""The device's idle time while the main thread is in no call of the
counting step (the wait for the next batch, the readback of the previous
one's rows, the loop's own Python): the gaps of the device-only profiled
window outside every `step` span on the trace's clock
(`cellbench/spans.py::idle_split`), per profiled frame, in ms."""


def read(r):
    from cellbench import spans

    return spans.idle_ms_per_frame(r, spans.OUTSIDE)
