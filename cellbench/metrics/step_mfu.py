"""The whole step's share of the card's bf16 dense peak over the traced
run's timed window: the model FLOPs of its frames (the detector's per
frame at the network input, the ReID network's per embedded detection,
counted from the step's outputs; counts.py) over the window's wall time."""


def read(r):
    if r.peaks is None or not r.window_s or not r.model_flops:
        return None
    return 100.0 * r.model_flops / r.window_s / r.peaks["bf16_flops"]
