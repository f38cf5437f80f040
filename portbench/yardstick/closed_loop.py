"""The closed-loop window: batches enqueued for a number of seconds,
``inflight`` of them on the stream at once, as a dispatcher's double
buffer keeps them. Timed by the host's clock; a batch's time runs from
the start of its enqueue to the host's seeing its completion event.
"""

from __future__ import annotations

import time
from collections import deque
from types import SimpleNamespace

import torch


class _HostDone:
    """Completion of work that a CPU device finished when it returned."""

    def synchronize(self) -> None:
        pass


def _done(device: str):
    if device == "cpu":
        return _HostDone()
    ev = torch.cuda.Event()
    ev.record()
    return ev


def sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def window(step, seconds: float, traffic: dict, device: str,
           max_batches: int = 0) -> SimpleNamespace:
    """Enqueue batches for ``seconds`` (or ``max_batches``), keeping
    ``traffic["inflight"]`` of them enqueued: before a further one, wait
    for the oldest. Returns each batch's time from the start of its
    enqueue to the host's seeing it done, each enqueue's host time, the
    window's length up to the final synchronise, and the first and last
    batch's outputs."""
    inflight = int(traffic["inflight"])
    sync(device)
    pending = deque()
    batch_s, enqueue_s, first, last = [], [], None, None
    n = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline and not (
            max_batches and n >= max_batches):
        if len(pending) >= inflight:
            ts, done, _ = pending.popleft()
            done.synchronize()
            batch_s.append(time.perf_counter() - ts)
        ts = time.perf_counter()
        out = step()
        enqueue_s.append(time.perf_counter() - ts)
        if first is None:
            first = out
        pending.append((ts, _done(device), out))
        n += 1
    while pending:
        ts, done, out = pending.popleft()
        done.synchronize()
        batch_s.append(time.perf_counter() - ts)
        last = out
    sync(device)
    return SimpleNamespace(seconds=time.perf_counter() - t0, batches=n,
                           batch_s=batch_s, enqueue_s=enqueue_s,
                           kept=[o for o in (first, last) if o is not None])
