"""The embed layer's time on the compute stream per frame of the timed
window, in ms: CUDA events recorded where the step enters and leaves the
layer's call, summed over the window's batches."""


def read(r):
    ms = r.layer_ms.get("embed")
    return None if ms is None or not r.frames else ms / r.frames
