"""How long a batch waits for its counts: per batch of the traced run's
timed window, from the producer's take of its raw frames (before the host
letterbox) to its track rows on the host; the 90th percentile over every
batch, in ms. A stall that the rate hides shows here."""

import statistics


def read(r):
    if len(r.latencies) < 2:
        return None
    return 1e3 * statistics.quantiles(r.latencies, n=10)[-1]
