"""The host's time waiting on the device inside the counting step: the
program's `sync.*` spans on the step's thread, summed over the traced
run's timed window, per frame of the window, in ms (`cellbench/spans.py`)."""


def read(r):
    from cellbench import spans

    got = spans.syncs(r)
    if got is None or not got[1]:
        return None
    per, frames = got
    return 1e3 * sum(s for _, s in per) / frames
