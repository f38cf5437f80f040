"""The yardstick's counts against shapes worked by hand, and the
trace's reduction on a made-up trace."""

from types import SimpleNamespace

import numpy as np
import pytest

from yardstick import roofline, schema as YS, trace
from yardstick.fsm import RowMap


def test_row_counts_of_the_two_configurations():
    retry = YS.Capacities(max_events=1024, max_activities=4, max_timers=2,
                          max_children=2, max_request_cancels=2,
                          max_signals_ext=2, max_version_items=2)
    # 25 exec + 2*2 vh + 1 + 4*19 + 2*6 + 2*8 + 2*4 + 2*4
    assert RowMap(retry).rows == 150 and RowMap(retry).rows_padded == 152
    # 25 + 2*8 + 1 + 32*19 + 16*6 + 16*8 + 8*4 + 8*4
    assert RowMap(YS.Capacities()).rows == 938
    assert RowMap(YS.Capacities()).rows_padded == 944


def _rows(n, wide_col=None, span=0):
    r = np.zeros((n, YS.EV_N), np.int32)
    r[:, YS.EV_TYPE] = 5
    if wide_col is not None:
        r[0, wide_col] = span
    return r


def test_event_bytes_at_the_narrow_widths():
    assert roofline.event_bytes([_rows(3)]) == 3 * 2 * YS.EV_N
    # one column wider than an int16's affine span: 4 bytes in it
    assert roofline.event_bytes([_rows(3, YS.EV_A0, 70000)]) == (
        3 * (2 * (YS.EV_N - 1) + 4))
    # a span of 65,000 still narrows
    assert roofline.event_bytes([_rows(2, YS.EV_A0, 65000)]) == (
        2 * 2 * YS.EV_N)
    # a wide type or slot column: the batch does not narrow
    assert roofline.event_bytes([_rows(2, YS.EV_SLOT, 70000)]) == (
        2 * 4 * YS.EV_N)
    assert roofline.event_bytes([_rows(0)]) == 0


def test_replay_work_by_hand():
    caps = YS.Capacities(max_events=8, max_activities=4, max_timers=2,
                         max_children=2, max_request_cancels=2,
                         max_signals_ext=2, max_version_items=2)
    rows = [_rows(3), _rows(5, YS.EV_A0, 70000)]
    w = roofline.replay_work(rows, 4, caps)
    per_event = 2 * (YS.EV_N - 1) + 4
    assert w["valid_events"] == 16
    assert w["event_bytes"] == 2 * 8 * per_event
    assert w["state_bytes"] == 2 * 4 * 150 * 4
    assert w["ops"] == 16 * 64
    least = max(w["bytes"] / 3.35e12, w["ops"] / 33.5e12)
    assert w["least_s"] == pytest.approx(least)
    assert w["bound_by"] == "bytes"
    with pytest.raises(ValueError):
        roofline.replay_work(rows, 5, caps)


def test_union_of_intervals():
    assert trace.union([(5, 7), (0, 2), (1, 3), (7, 9)]) == [(0, 3), (5, 9)]
    assert trace.union([]) == []


def _ev(name, dev, kind, a, b, corr=0, linked=0, thread=1, typed=True):
    e = SimpleNamespace(
        name=lambda: name, device_type=lambda: dev, start_ns=lambda: a,
        end_ns=lambda: b, correlation_id=lambda: corr,
        linked_correlation_id=lambda: linked, start_thread_id=lambda: thread)
    if typed:
        e.activity_type = lambda: kind
    return e


@pytest.mark.parametrize("typed", [True, False])
def test_reduce_attributes_device_work_to_the_launching_span(typed):
    """With kineto's activity types, and without them (older torch
    builds): runtime calls are then told by their names."""
    CPU, GPU = "cpu", "gpu"
    evs = [
        _ev("bench.window", CPU, "user_annotation", 0, 1000, corr=1),
        _ev("bench.replay", CPU, "user_annotation", 10, 100, corr=2),
        _ev("cudaLaunchKernel", CPU, "cuda_runtime", 20, 25, corr=501),
        _ev("bench.refresh", CPU, "user_annotation", 100, 400, corr=3),
        _ev("aten::where", CPU, "cpu_op", 150, 200, corr=4),
        _ev("cudaLaunchKernel", CPU, "cuda_runtime", 160, 170, corr=502),
        _ev("aten::amin", CPU, "cpu_op", 300, 350, corr=5),
        # the FSM kernel, found by its runtime call
        _ev("fsm", GPU, "kernel", 30, 330, corr=501),
        # a refresh kernel, found by its runtime call
        _ev("where", GPU, "kernel", 400, 450, corr=502),
        # a refresh kernel found only by its op
        _ev("amin", GPU, "kernel", 500, 520, corr=999, linked=5),
        # outside the window: left out
        _ev("late", GPU, "kernel", 2000, 2100, corr=502),
        # a span's mirror on the device's timeline: not device work
        _ev("bench.replay", GPU, "gpu_user_annotation", 30, 330),
    ]
    if not typed:
        evs = [_ev(e.name(), e.device_type(), None, e.start_ns(),
                   e.end_ns(), e.correlation_id(),
                   e.linked_correlation_id(), typed=False) for e in evs]
    red = trace.reduce_events(evs, ("bench.replay", "bench.refresh"), GPU,
                              CPU)
    assert red["window_s"] == pytest.approx(1000e-9)
    assert red["busy_s"] == pytest.approx((300 + 50 + 20) * 1e-9)
    assert red["span_device_s"]["bench.replay"] == pytest.approx(300e-9)
    assert red["span_device_s"]["bench.refresh"] == pytest.approx(70e-9)
    assert red["span_activities"] == {"bench.replay": 1, "bench.refresh": 2}
    assert red["unattributed"] == 0 and red["device_activities"] == 3
    assert red["device_ops"][0] == ("fsm", pytest.approx(300e-9))
    gaps = dict(red["idle_gaps"])
    # idle from 0 to 30: the host was in bench.replay, between its calls
    assert gaps["bench.replay"] == pytest.approx(30e-9)
    # idle from 450 to 500 and from 520: the host had left the spans
    assert gaps["outside the benchmark's spans"] == pytest.approx(
        (1000 - 520 + 50) * 1e-9)
    assert sum(gaps.values()) == pytest.approx((1000 - 370) * 1e-9)


def test_reduce_without_a_window_reads_nothing():
    assert trace.reduce_events([], ("bench.replay",), "gpu", "cpu") == {}
