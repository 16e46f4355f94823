"""Host feed: the mean time the main loop waits for the producer's next
batch (host letterbox + upload), per batch of the timed window, in ms."""


def read(r):
    if not r.feed_wait_s:
        return None
    return 1e3 * sum(r.feed_wait_s) / len(r.feed_wait_s)
