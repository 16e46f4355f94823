"""The host's waits on the device inside the counting step: the mean
number of the program's `sync.*` spans (each NMS pass's convergence test,
the embed's count read) per batch of the traced run's timed window, read
from the program's span recorder (`cellbench/spans.py`)."""


def read(r):
    from cellbench import spans

    got = spans.syncs(r)
    if got is None or not got[0]:
        return None
    per, _ = got
    return sum(n for n, _ in per) / len(per)
