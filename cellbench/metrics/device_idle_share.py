"""The share of a profiled window that records the device's activity
alone, between its two marker kernels on the device's clock, in which no
operation runs on the card (the complement of the union of its kernels',
copies' and memsets' intervals), in %."""


def read(r):
    w = r.device_window
    if w is None or w.window_us <= 0:
        return None
    return 100.0 * (1.0 - w.busy_us() / w.window_us)
