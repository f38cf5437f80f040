"""The port's spans on the profiler's timeline (utils/tracing.py
``device_span`` and the sampled spans' mirror), the layers' spans in the
ops modules and the dispatcher, and the dispatcher's event-timed device
step. CPU only: the CPU profiler records the same ranges kineto puts on
the card's timeline."""

from __future__ import annotations

import json
import random
import threading
from collections import deque

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from cadence_tpu_torch.ops import dispatch as D
from cadence_tpu_torch.ops import refresh as R
from cadence_tpu_torch.ops import replay_cuda as RC
from cadence_tpu_torch.ops import schema as S
from cadence_tpu_torch.testing import workloads as W
from cadence_tpu_torch.utils import tracing
from cadence_tpu_torch.utils.metrics import Scope
from cadence_tpu_torch.utils.pprof import DeviceTrace
from cadence_tpu_torch.utils.tracing import NOOP_SPAN, TRACER, device_span

CAPS = S.Capacities(max_events=32, max_activities=4, max_timers=2,
                    max_children=2, max_request_cancels=2,
                    max_signals_ext=2, max_version_items=2)
LAYER_SPANS = ("cadence.replay.to_rows", "cadence.replay.fsm",
               "cadence.replay.from_rows", "cadence.refresh")


@pytest.fixture(autouse=True)
def _clean_tracer():
    TRACER.configure(sample_rate=0.0)
    TRACER.clear()
    yield
    TRACER.configure(sample_rate=0.0)
    TRACER.clear()


def _histories(n, seed=7):
    rng = random.Random(seed)
    return [(f"wf-{i}", f"run-{i}", W.retry_deep_history(rng, depth=8))
            for i in range(n)]


def _step(lanes=4, steps=3):
    """The benchmark's resident step on CPU tensors: the replay of empty
    events (-1, no event) from the empty state, then the refresh."""
    state = S.state_from_numpy(S.empty_state(lanes, CAPS), "cpu")
    events = torch.full((steps, S.EV_N, lanes), -1, dtype=torch.int32)
    final = RC.replay_scan_teb(state, events, CAPS)
    return final, R.refresh_tasks_device(final)


def _ranges(prof, prefix=("cadence.", "bench.", "rpc.", "wf")):
    """(name, start ns, end ns, thread) of the CPU ranges whose names
    start with ``prefix``, in start order."""
    out = [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(prefix)]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_no_profiler_no_sample_is_the_shared_noop(monkeypatch):
    """(a) With no profiler and no sampled span a device span is the
    shared no-op and no profiler range is made, on the whole step."""
    def forbidden(*_a, **_k):
        raise AssertionError("a profiler range was made with tracing off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        forbidden)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        forbidden)
    assert tracing._profiler_range("cadence.x") is None
    assert device_span("cadence.replay.fsm") is NOOP_SPAN
    with device_span("cadence.x") as span:
        assert span is NOOP_SPAN and not span
    _step()
    assert TRACER.spans() == []


def test_the_step_emits_the_four_layer_spans_in_order():
    """(b) Under a CPU torch.profiler the replay and the refresh emit the
    four layer spans, in order, disjoint, each inside the benchmark-style
    range that called it."""
    with _cpu_profile() as prof:
        with record_function("bench.replay"):
            final = RC.replay_scan_teb(
                S.state_from_numpy(S.empty_state(4, CAPS), "cpu"),
                torch.full((3, S.EV_N, 4), -1, dtype=torch.int32), CAPS)
        with record_function("bench.refresh"):
            R.refresh_tasks_device(final)
    got = _ranges(prof)
    names = [r[0] for r in got]
    assert names == ["bench.replay", *LAYER_SPANS[:3], "bench.refresh",
                     LAYER_SPANS[3]]
    spans = {r[0]: r for r in got}
    layers = [spans[n] for n in LAYER_SPANS]
    for (_, _, end, _), (_, start, _, _) in zip(layers, layers[1:]):
        assert end <= start
    for outer, inner in (("bench.replay", LAYER_SPANS[:3]),
                         ("bench.refresh", LAYER_SPANS[3:])):
        _, a, b, th = spans[outer]
        for n in inner:
            assert a <= spans[n][1] <= spans[n][2] <= b
            assert spans[n][3] == th


def test_the_layer_spans_wrap_every_caller():
    """The spans sit inside the functions: the packed route and a bare
    ``replay_rows`` open theirs too."""
    rows = RC.state_to_rows(
        S.state_from_numpy(S.empty_state(2, CAPS), "cpu"), RC.RowMap(CAPS))
    events = torch.full((2, S.EV_N, 2), -1, dtype=torch.int32)
    with _cpu_profile() as prof:
        RC.replay_rows(events, rows, CAPS)
    assert [r[0] for r in _ranges(prof)] == ["cadence.replay.fsm"]


def test_sampled_span_is_mirrored_and_unsampled_code_adds_none():
    """(c) A sampled span entered under the profiler is a range of its
    name, and a device span under it is both a child span in the flight
    recorder and a range; unsampled spans add no range."""
    with _cpu_profile() as prof:
        with TRACER.trace("rpc.RebuildBatch", sampled=True) as root:
            with device_span("cadence.refresh") as child:
                assert child.parent_id == root.span_id
        with TRACER.trace("rpc.unsampled", sampled=False):
            with TRACER.span("engine.unsampled"):
                pass
    assert [r[0] for r in _ranges(prof)] == ["rpc.RebuildBatch",
                                             "cadence.refresh"]
    recorded = {s.name: s for s in TRACER.spans()}
    assert set(recorded) == {"rpc.RebuildBatch", "cadence.refresh"}
    assert recorded["cadence.refresh"].trace_id == root.trace_id
    # with no profiler the same span records but opens no range
    with TRACER.trace("rpc.quiet", sampled=True) as quiet:
        assert quiet._range is None


def test_a_sampled_span_closes_its_range_on_error():
    with _cpu_profile() as prof:
        with pytest.raises(ValueError):
            with TRACER.trace("rpc.fails", sampled=True) as span:
                raise ValueError("boom")
        with record_function("after"):
            pass
    (fails,) = [r for r in _ranges(prof, ("rpc.",))]
    (after,) = [r for r in _ranges(prof, ("after",))]
    assert fails[2] <= after[1]
    assert span.error == "ValueError" and span._range is None


def test_device_span_under_the_pprof_trace_of_every_thread(tmp_path):
    """The check holds under the operator's device trace too, which a
    thread of its own starts for every thread: a span on this thread,
    and the dispatcher's on its pump threads, land in its file."""
    dt = DeviceTrace(device="cpu")
    dt.start(str(tmp_path))
    try:
        assert tracing._profiler_range("cadence.x") is not None
        with device_span("cadence.replay.fsm") as span:
            assert span is not NOOP_SPAN and not span
        D.replay_stream(_histories(2), caps=CAPS, batch_size=1,
                        device="cpu")
    finally:
        path = dt.stop()
    assert tracing._profiler_range("cadence.x") is None
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_name = {}
    for e in events:
        by_name.setdefault(e.get("name"), set()).add(e.get("tid"))
    assert "cadence.replay.fsm" in by_name
    assert "cadence.dispatch.stage" in by_name
    assert "cadence.dispatch.replay" in by_name
    # the pumps are threads of their own
    assert by_name["cadence.dispatch.stage"].isdisjoint(
        by_name["cadence.dispatch.replay"])


def test_a_thread_without_a_span_reads_none():
    """The thread-local current span defaults to None on every thread,
    so the unsampled check is one attribute read."""
    seen = []
    with TRACER.trace("root", sampled=True):
        t = threading.Thread(target=lambda: seen.append(TRACER.current()))
        t.start()
        t.join(10)
    assert not t.is_alive() and seen == [None]


class _FakeEvent:
    """A timing event whose completion the test sets."""

    def __init__(self, ms: float, done: bool) -> None:
        self.ms, self.done, self.waited = ms, done, False

    def query(self) -> bool:
        return self.done

    def synchronize(self) -> None:
        self.waited = True
        self.done = True

    def elapsed_time(self, end) -> float:
        return end.ms - self.ms


def test_event_timed_steps_emit_in_order_once_complete(monkeypatch):
    """The card's step times: emitted oldest first as their end events
    complete, never past one that has not, and all of them, waited for,
    at the end of the stream."""
    d = D.DeviceDispatcher(metrics=Scope(), device="cpu")
    got = []
    monkeypatch.setattr(d, "_emit_step_telemetry",
                        lambda mode, s: got.append((mode, s)))
    timed = deque([
        ("hist", _FakeEvent(0.0, True), _FakeEvent(2.0, True)),
        ("lanes", _FakeEvent(2.0, True), _FakeEvent(5.0, False)),
        ("hist", _FakeEvent(5.0, True), _FakeEvent(6.0, True)),
    ])
    d._emit_timed(timed, wait=False)
    assert got == [("hist", 0.002)] and len(timed) == 2
    d._emit_timed(timed, wait=False)
    assert len(got) == 1
    last_end = timed[0][2]
    d._emit_timed(timed, wait=True)
    assert last_end.waited and not timed
    assert got == [("hist", 0.002), ("lanes", 0.003), ("hist", 0.001)]


def test_a_failed_timing_read_drops_only_its_batch(monkeypatch):
    d = D.DeviceDispatcher(metrics=Scope(), device="cpu")
    got = []
    monkeypatch.setattr(d, "_emit_step_telemetry",
                        lambda mode, s: got.append(s))
    class Unrecorded(_FakeEvent):
        def elapsed_time(self, end) -> float:
            raise RuntimeError("an event was not recorded")

    timed = deque([
        ("hist", Unrecorded(0.0, True), _FakeEvent(1.0, True)),
        ("hist", _FakeEvent(1.0, True), _FakeEvent(4.0, True)),
    ])
    d._emit_timed(timed, wait=False)
    assert got == [0.003] and not timed


def test_the_cpu_step_stays_on_the_host_clock():
    """On the CPU the step is the host's time of the replay, one sample
    a batch, as before."""
    scope = Scope()
    D.replay_stream(_histories(3), caps=CAPS, batch_size=1, metrics=scope,
                    device="cpu")
    reg = scope.registry
    assert reg.timer_stats("device_step_seconds").count == 3
    assert reg.counter_value("device_batches") == 3
