"""The detector network's share of its roofline, in %: the time its
convolutions take at best, a frame (`detector_counts.net_bound_s`: each
convolution of the configuration's table at `net_hw`, the larger of its
FLOPs at the bf16 dense peak and its bf16 input, weight and output bytes at
the memory rate), over `detect_net_busy_ms_per_frame`. The configuration is
the cell's on the command line (`launch_spans.cell_config`)."""

from cellbench import detector_counts, launch_spans


def read(r):
    cfg = launch_spans.cell_config()
    busy_ms = launch_spans.busy_ms_per_frame(r, "detect.net")
    if cfg is None or busy_ms is None or r.peaks is None or cfg.get("compute_dtype") not in detector_counts.PRECISION:
        return None
    return 100.0 * detector_counts.net_bound_s(cfg, r.peaks) * 1e3 / busy_ms
