"""host_enqueue_ms: the median over the window's batches of the host's
time from a batch's first call (``replay_scan_teb``) to the return of
``refresh_tasks_device``, with no synchronise: the host's launch path.
Read over the untraced window of a ``--trace 1`` run, so that the
profiler's own cost per launch is not in it."""

import statistics


def read(view):
    xs = view.window.enqueue_s
    if not xs:
        return None
    return statistics.median(xs) * 1e3
