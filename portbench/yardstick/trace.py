"""Reduce a torch.profiler trace of the traced window to what the
per-layer readers take: device time and activity count by the
benchmark's span that launched them, the device's busy time, and the
breakdown of device operations and idle gaps.

A device activity (kernel, copy, set) belongs to the span during which
the host launched it: its launch call is found by the CUPTI correlation
id (the runtime call), else by the PyTorch op it is linked to. So a
metric reads the same work whatever kernels implement it. The busy time
is the union of the activities' intervals, a frozen copy of the union in
``device_busy`` of ``chip_smoke.py`` (the port's bring-up script).
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Tuple

WINDOW_SPAN = "bench.window"
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME_KINDS = ("cuda_runtime", "cuda_driver")


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float,
                                                                  float]]:
    """Disjoint sorted intervals covering ``intervals``."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class _Spans:
    """Which span holds a host time (the benchmark opens its spans one
    after another, so they are disjoint)."""

    def __init__(self, spans: Dict[str, List[Tuple[int, int]]]) -> None:
        self.items = sorted((a, b, name) for name, ivs in spans.items()
                            for a, b in ivs)
        self.starts = [a for a, _, _ in self.items]

    def at(self, t: int):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.items[i][1] >= t:
            return self.items[i][2]
        return None


def _kind(e) -> str:
    """The event's kineto activity type; torch builds without
    ``activity_type`` tell a runtime call by its name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if name.startswith("cuda") or (name.startswith("cu")
                                   and name[2:3].isupper()):
        return "cuda_runtime"
    return ""


def _span_ns(e) -> Tuple[int, int]:
    if hasattr(e, "start_ns"):
        a = e.start_ns()
    else:
        a = int(e.start_us() * 1000)
    if hasattr(e, "end_ns"):
        return a, e.end_ns()
    if hasattr(e, "duration_ns"):
        return a, a + e.duration_ns()
    return a, a + int(e.duration_us() * 1000)


def reduce_events(events, span_names: Iterable[str], device_type_cuda,
                  device_type_cpu) -> Dict:
    """Reduce kineto events (``prof.profiler.kineto_results.events()``).
    ``span_names``: the benchmark's spans to attribute to; the window is
    the span ``WINDOW_SPAN``."""
    names = set(span_names)
    spans: Dict[str, List[Tuple[int, int]]] = {n: [] for n in names}
    window, thread = None, None
    runtime_at: Dict[int, int] = {}
    op_at: Dict[int, int] = {}
    host_ops: List[Tuple[int, int, str, int]] = []
    device: List = []
    for e in events:
        dt = e.device_type()
        name = e.name()
        if dt == device_type_cpu:
            kind = _kind(e)
            a, b = _span_ns(e)
            if name == WINDOW_SPAN:
                window = (a, b)
                thread = e.start_thread_id()
            elif name in names:
                spans[name].append((a, b))
            if kind in _RUNTIME_KINDS:
                runtime_at[e.correlation_id()] = a
            else:
                op_at[e.correlation_id()] = a
            host_ops.append((a, b, name, e.start_thread_id()))
        elif dt == device_type_cuda:
            # kernels, copies and sets; not the spans' mirrors on the
            # device's timeline
            kind = e.activity_type() if hasattr(e, "activity_type") else ""
            if (kind in _DEVICE_KINDS if kind else
                    name not in names and name != WINDOW_SPAN):
                device.append(e)
    if window is None:
        return {}
    w0, w1 = window
    where = _Spans(spans)
    dev_ns = {n: 0 for n in names}
    count = {n: 0 for n in names}
    by_op: Dict[str, float] = {}
    intervals = []
    unattributed, by_op_link = 0, 0
    for e in device:
        a, b = _span_ns(e)
        if b < w0 or a > w1:
            continue
        intervals.append((max(a, w0), min(b, w1)))
        key = e.name()[:80]
        by_op[key] = by_op.get(key, 0.0) + (b - a) / 1e9
        t = runtime_at.get(e.correlation_id())
        if t is None:
            t = op_at.get(e.linked_correlation_id())
            by_op_link += t is not None
        name = where.at(t) if t is not None else None
        if name is None:
            unattributed += 1
            continue
        dev_ns[name] += b - a
        count[name] += 1
    busy = union(intervals)
    busy_ns = sum(b - a for a, b in busy)
    gaps = _idle_gaps(busy, w0, w1, [
        (a, b, name) for a, b, name, th in host_ops
        if th == thread and name != WINDOW_SPAN])
    return dict(
        window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
        span_device_s={n: v / 1e9 for n, v in dev_ns.items()},
        span_activities=count, device_activities=len(intervals),
        unattributed=unattributed, attributed_by_op=by_op_link,
        device_ops=sorted(by_op.items(), key=lambda kv: -kv[1])[:10],
        idle_gaps=gaps)


def _idle_gaps(busy, w0: int, w1: int, host_ops) -> List[Tuple[str, float]]:
    """The idle time of the window by what the host was in at each gap's
    middle (the benchmark's span and the innermost op on its thread), the
    ten largest sums."""
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    ops = sorted(host_ops)
    out: Dict[str, float] = {}
    stack: List[Tuple[int, int, str]] = []
    k = 0
    # the host's events on one thread nest: the innermost one open at a
    # time is the top of a stack swept in time order
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) // 2
        while k < len(ops) and ops[k][0] <= mid:
            while stack and stack[-1][1] < ops[k][0]:
                stack.pop()
            stack.append(ops[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        span = next((s[2] for s in stack if s[2].startswith("bench.")),
                    "outside the benchmark's spans")
        inner = stack[-1][2] if stack else span
        key = (span if inner == span else f"{span} > {inner}")[:80]
        out[key] = out.get(key, 0.0) + (b - a) / 1e9
    return sorted(out.items(), key=lambda kv: -kv[1])[:10]
