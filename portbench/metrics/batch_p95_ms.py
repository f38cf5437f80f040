"""batch_p95_ms: the 95th percentile (nearest rank) over every batch of
the window of the time from when the harness began to enqueue the batch
to when the host saw its completion event (host clock): what a caller
waiting on a batch's rebuild feels, the batch ahead included."""

import math


def read(view):
    xs = sorted(view.window.batch_s)
    if not xs:
        return None
    return xs[math.ceil(0.95 * len(xs)) - 1] * 1e3
