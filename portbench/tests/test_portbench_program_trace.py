"""The reduction of the traced window by the program's own spans
(``yardstick/program_trace.py``) on planted kineto events."""

from types import SimpleNamespace

import pytest

from yardstick import program_trace, trace

CPU, GPU = "cpu", "gpu"
LAYERS = ("cadence.replay.to_rows", "cadence.replay.fsm",
          "cadence.replay.from_rows", "cadence.refresh")


def _ev(name, dev, kind, a, b, corr=0, linked=0, thread=1, typed=True):
    e = SimpleNamespace(
        name=lambda: name, device_type=lambda: dev, start_ns=lambda: a,
        end_ns=lambda: b, correlation_id=lambda: corr,
        linked_correlation_id=lambda: linked, start_thread_id=lambda: thread)
    if typed:
        e.activity_type = lambda: kind
    return e


def _untyped(evs):
    """The same events as a torch build without ``activity_type`` gives
    them: runtime calls are told by their names."""
    return [_ev(e.name(), e.device_type(), None, e.start_ns(), e.end_ns(),
                e.correlation_id(), e.linked_correlation_id(),
                e.start_thread_id(), typed=False) for e in evs]


def _disjoint_step():
    """One batch as the benchmark's step launches it: the four layer
    spans one after another inside ``bench.replay`` and
    ``bench.refresh``, and a span's mirror on the device's timeline."""
    ua, rt = "user_annotation", "cuda_runtime"
    return [
        _ev("bench.window", CPU, ua, 0, 1000, corr=1),
        _ev("bench.replay", CPU, ua, 10, 200, corr=2),
        _ev("cadence.replay.to_rows", CPU, ua, 15, 30, corr=3),
        _ev("cudaMemcpyAsync", CPU, rt, 20, 25, corr=601),
        _ev("cadence.replay.fsm", CPU, ua, 35, 100, corr=4),
        _ev("cudaLaunchKernel", CPU, rt, 50, 55, corr=602),
        _ev("cadence.replay.from_rows", CPU, ua, 110, 150, corr=5),
        _ev("cudaLaunchKernel", CPU, rt, 120, 125, corr=603),
        _ev("bench.refresh", CPU, ua, 400, 600, corr=6),
        _ev("cadence.refresh", CPU, ua, 410, 590, corr=7),
        _ev("aten::where", CPU, "cpu_op", 450, 470, corr=8),
        _ev("copy", GPU, "gpu_memcpy", 40, 60, corr=601),
        _ev("replay_fsm_kernel", GPU, "kernel", 60, 300, corr=602),
        _ev("CatArrayBatchedCopy", GPU, "kernel", 300, 320, corr=603),
        # found only by the op it is linked to
        _ev("where", GPU, "kernel", 600, 650, corr=999, linked=8),
        _ev("cadence.replay.fsm", GPU, "gpu_user_annotation", 60, 300),
    ]


@pytest.mark.parametrize("typed", [True, False])
def test_innermost_span_self_time_and_the_unattributed(typed):
    """Nested program spans keep their self time; a launch on another
    thread falls under that thread's span; a launch inside a bench span
    under no program span is counted apart; idle gaps go to the
    innermost program span on the window's thread."""
    ua, rt = "user_annotation", "cuda_runtime"
    evs = _disjoint_step() + [
        # the dispatcher's span around the replay's three on thread 1
        _ev("cadence.dispatch.replay", CPU, ua, 12, 190, corr=9),
        _ev("cudaLaunchKernel", CPU, rt, 160, 165, corr=604),
        _ev("extra", GPU, "kernel", 320, 330, corr=604),
        # in bench.replay, under no program span
        _ev("cudaLaunchKernel", CPU, rt, 195, 196, corr=605),
        _ev("stray", GPU, "kernel", 330, 335, corr=605),
        # outside every span
        _ev("cudaLaunchKernel", CPU, rt, 700, 701, corr=606),
        _ev("late_host", GPU, "kernel", 700, 710, corr=606),
        # thread 2 runs its own replay all through the window
        _ev("cadence.replay.fsm", CPU, ua, 0, 1000, corr=10, thread=2),
        _ev("cudaLaunchKernel", CPU, rt, 800, 801, corr=607, thread=2),
        _ev("pump_kernel", GPU, "kernel", 720, 730, corr=607),
        # outside the window: left out
        _ev("after", GPU, "kernel", 2000, 2100, corr=602),
    ]
    if not typed:
        evs = _untyped(evs)
    red = program_trace.reduce_events(evs, GPU, CPU)
    dev = {k: round(v * 1e9) for k, v in red["span_device_s"].items()}
    assert dev == {"cadence.replay.to_rows": 20, "cadence.replay.fsm": 250,
                   "cadence.replay.from_rows": 20,
                   "cadence.dispatch.replay": 10, "cadence.refresh": 50}
    assert red["span_activities"] == {
        "cadence.replay.to_rows": 1, "cadence.replay.fsm": 2,
        "cadence.replay.from_rows": 1, "cadence.dispatch.replay": 1,
        "cadence.refresh": 1}
    assert red["device_activities"] == 8
    assert red["unattributed"] == 2 and red["bench_outside_program"] == 1
    gaps = {k: round(v * 1e9) for k, v in red["idle_gaps"]}
    # busy: 40-335, 600-650, 700-710, 720-730 of the window 0-1000
    assert gaps == {"cadence.replay.to_rows": 40, "cadence.refresh": 265,
                    program_trace.OUTSIDE: 50 + 10 + 270}


@pytest.mark.parametrize("typed", [True, False])
def test_disjoint_spans_reduce_as_the_benchmarks_own(typed):
    """Where the program's spans are disjoint, as on the benchmark's
    path, the reduction by them equals ``trace.reduce_events`` given the
    same names."""
    evs = _disjoint_step()
    if not typed:
        evs = _untyped(evs)
    mine = program_trace.reduce_events(evs, GPU, CPU)
    theirs = trace.reduce_events(evs, LAYERS, GPU, CPU)
    for key in ("span_device_s", "span_activities", "device_activities",
                "unattributed"):
        assert mine[key] == theirs[key], key
    assert mine["bench_outside_program"] == 0
    # and the bench spans' work is exactly the layers' work inside them
    bench = trace.reduce_events(evs, ("bench.replay", "bench.refresh"),
                                GPU, CPU)
    d = mine["span_device_s"]
    assert bench["span_device_s"]["bench.replay"] == pytest.approx(
        d["cadence.replay.to_rows"] + d["cadence.replay.fsm"]
        + d["cadence.replay.from_rows"])
    assert bench["span_device_s"]["bench.refresh"] == pytest.approx(
        d["cadence.refresh"])


def test_without_a_window_or_spans_reads_nothing():
    assert program_trace.reduce_events([], GPU, CPU) == {}
    # a program without the spans (an older version): nothing by span
    evs = [e for e in _disjoint_step()
           if not e.name().startswith("cadence.")]
    red = program_trace.reduce_events(evs, GPU, CPU)
    assert red["span_device_s"] == {} and red["span_activities"] == {}
    assert red["unattributed"] == red["device_activities"] == 4
    assert red["bench_outside_program"] == 4
