"""The detector's and the ReID network's convolutions as a share of their
bound in the profiled window: each `aten::convolution`'s FLOPs and bytes
from its recorded shapes, its bound the larger of FLOPs at the dense peak
of its input type and bytes at the memory rate, summed, over the device
time of the kernels the convolutions launched."""

from cellbench import counts

ITEMSIZE = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4}
PEAK = {"c10::BFloat16": "bf16_flops", "c10::Half": "bf16_flops", "float": "tf32_flops"}


def read(r):
    if r.window is None or r.peaks is None:
        return None
    bound_us = dev_us = 0.0
    for x, w, stride, pad, dil, groups, dtype, us in r.window.convs:
        if us <= 0 or dtype not in ITEMSIZE:
            continue
        flops, nbytes = counts.conv_call(x, w, stride, pad, dil, groups, ITEMSIZE[dtype])
        bound_us += 1e6 * max(flops / r.peaks[PEAK[dtype]], nbytes / r.peaks["hbm_bytes_per_s"])
        dev_us += us
    return 100.0 * bound_us / dev_us if dev_us else None
