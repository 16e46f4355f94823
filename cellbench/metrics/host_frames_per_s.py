"""Frames per second on the host's clock over the traced run's timed
window: every frame whose track rows reached the host in the window, over
the window (its first batch to the last batch's rows on the host). The
steps are those of an untraced window, with a CUDA event pair and a named
range at each layer call."""


def read(r):
    if not r.frames or not r.window_s:
        return None
    return r.frames / r.window_s
