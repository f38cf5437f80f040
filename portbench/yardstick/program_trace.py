"""Reduce a torch.profiler trace of the traced window to the program's own
spans: the profiler ranges the port opens around its layers
(``cadence.replay.to_rows``, ``cadence.replay.fsm``,
``cadence.replay.from_rows``, ``cadence.refresh``, and any other CPU
event whose name starts with ``cadence.``).

A device activity (kernel, copy, set; not a span's mirror on the
device's timeline) belongs to the innermost program span open on the
thread that launched it, at its launch: the launch is found by the
runtime correlation id, else by the PyTorch op it is linked to, as in
``trace.py``. That is self time: where program spans nest (a dispatcher's
span around the replay's), the outer one keeps only what its children do
not launch. The reduction also counts the activities launched inside one
of the benchmark's ``bench.*`` spans under no program span, and sums the
window's idle gaps by the innermost program span open on the window's
thread at each gap's middle.

Where the program opens no such span (a version without them) every
figure by span is empty. ``run.py`` does not call it yet: per-layer
metrics that read the program's spans need ``traced_window`` to store
this reduction beside that of ``trace.reduce_events``, an edit to the
harness that a benchmark change makes (PERF.md §7).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import trace

PREFIX = "cadence."
BENCH_PREFIX = "bench."
OUTSIDE = "outside the program's spans"


def _innermost(spans: List[Tuple[int, int, str]],
               times: List[Tuple[int, int]]) -> Dict[int, Optional[str]]:
    """For each ``(time, key)`` of ``times``, the name of the innermost of
    ``spans`` (intervals of one thread, which nest) open at the time, or
    None; by key. Swept in time order with a stack of the open spans."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out: Dict[int, Optional[str]] = {}
    stack: List[Tuple[int, int, str]] = []
    k = 0
    for t, key in sorted(times):
        while k < len(spans) and spans[k][0] <= t:
            while stack and stack[-1][1] < spans[k][0]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = stack[-1][2] if stack else None
    return out


def reduce_events(events, device_type_cuda, device_type_cpu) -> Dict:
    """Reduce kineto events (``prof.profiler.kineto_results.events()``)
    to the program's spans within the window ``trace.WINDOW_SPAN``:
    device seconds and activities by span, the activities under no
    program span (``unattributed``) and, of those, the ones launched
    inside a ``bench.*`` span (``bench_outside_program``), and the idle
    gaps by program span. Empty without a window."""
    program: Dict[int, List[Tuple[int, int, str]]] = {}
    bench: Dict[int, List[Tuple[int, int, str]]] = {}
    launch_at: Dict[int, Tuple[int, int]] = {}
    op_at: Dict[int, Tuple[int, int]] = {}
    device = []
    window, window_thread = None, None
    for e in events:
        name = e.name()
        if e.device_type() == device_type_cpu:
            a, b = trace._span_ns(e)
            tid = e.start_thread_id()
            if name == trace.WINDOW_SPAN:
                window, window_thread = (a, b), tid
            elif name.startswith(PREFIX):
                program.setdefault(tid, []).append((a, b, name))
            elif name.startswith(BENCH_PREFIX):
                bench.setdefault(tid, []).append((a, b, name))
            if trace._kind(e) in trace._RUNTIME_KINDS:
                launch_at[e.correlation_id()] = (a, tid)
            else:
                op_at[e.correlation_id()] = (a, tid)
        elif e.device_type() == device_type_cuda:
            kind = e.activity_type() if hasattr(e, "activity_type") else ""
            if (kind in trace._DEVICE_KINDS if kind else not name.startswith(
                    (PREFIX, BENCH_PREFIX))):
                device.append(e)
    if window is None:
        return {}
    w0, w1 = window
    names = sorted({s[2] for ss in program.values() for s in ss})
    dev_ns = {n: 0 for n in names}
    count = {n: 0 for n in names}
    # (device interval, launching thread, launch time) of each activity
    acts = []
    for e in device:
        a, b = trace._span_ns(e)
        if b < w0 or a > w1:
            continue
        at = launch_at.get(e.correlation_id())
        if at is None:
            at = op_at.get(e.linked_correlation_id())
        acts.append((a, b, at))
    by_thread: Dict[int, List[Tuple[int, int]]] = {}
    for i, (_, _, at) in enumerate(acts):
        if at is not None:
            by_thread.setdefault(at[1], []).append((at[0], i))
    inner: Dict[int, Optional[str]] = {}
    in_bench: Dict[int, Optional[str]] = {}
    for tid, times in by_thread.items():
        inner.update(_innermost(program.get(tid, []), times))
        in_bench.update(_innermost(bench.get(tid, []), times))
    unattributed = bench_outside = 0
    for i, (a, b, _) in enumerate(acts):
        name = inner.get(i)
        if name is None:
            unattributed += 1
            bench_outside += in_bench.get(i) is not None
            continue
        dev_ns[name] += b - a
        count[name] += 1
    busy = trace.union((max(a, w0), min(b, w1)) for a, b, _ in acts)
    return dict(
        span_device_s={n: v / 1e9 for n, v in dev_ns.items()},
        span_activities=count, device_activities=len(acts),
        unattributed=unattributed, bench_outside_program=bench_outside,
        idle_gaps=_idle_gaps(busy, w0, w1,
                             program.get(window_thread, [])))


def _idle_gaps(busy, w0: int, w1: int,
               spans: List[Tuple[int, int, str]]) -> List[Tuple[str, float]]:
    """The window's idle time by the innermost program span open on the
    window's thread at each gap's middle, the ten largest sums."""
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    where = _innermost(spans, [((a + b) // 2, i)
                               for i, (a, b) in enumerate(gaps)])
    out: Dict[str, float] = {}
    for i, (a, b) in enumerate(gaps):
        key = where[i] or OUTSIDE
        out[key] = out.get(key, 0.0) + (b - a) / 1e9
    return sorted(out.items(), key=lambda kv: -kv[1])[:10]
