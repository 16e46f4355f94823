"""Kernel K1 (crop gather, csrc/crops.cu) as a share of its bound in the
profiled window: the bytes it needs (each sampled source pixel read once,
each crop written once; counts.py) at the card's memory rate, over the
device time of its kernels by name."""

KERNEL = "crop_gather_kernel"


def read(r):
    if r.window is None or r.peaks is None:
        return None
    us, n = r.window.kernel_us(KERNEL)
    if not n or us <= 0:
        return None
    return 100.0 * (r.k1_bytes / r.peaks["hbm_bytes_per_s"] * 1e6) / us
