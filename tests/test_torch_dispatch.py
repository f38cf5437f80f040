"""The port's pipelined dispatcher against the reference package's:
``replay_stream`` snapshots (bucketed lane packing, unpacked batches,
checkpoint resume) and the ``results(strict=)`` drain semantics."""

import random

import numpy as np
import pytest

from cadence_tpu.ops import dispatch as JD
from cadence_tpu.ops import schema as JS
from cadence_tpu.ops import unpack as JU
from cadence_tpu.testing import workloads as JW

from cadence_tpu_torch.ops import dispatch as D
from cadence_tpu_torch.ops import pack as P
from cadence_tpu_torch.ops import schema as S
from cadence_tpu_torch.ops.replay import replay_packed
from cadence_tpu_torch.ops.unpack import state_row_to_snapshot
from cadence_tpu_torch.testing import workloads as W

CAPS = S.Capacities(max_events=256, max_activities=4, max_timers=2,
                    max_children=2, max_request_cancels=2,
                    max_signals_ext=2, max_version_items=2)


def jcaps(caps):
    return JS.Capacities(**{f: getattr(caps, f)
                            for f in caps.__dataclass_fields__})


def mixed_depth(gen_mod, n_shallow=27, n_deep=3, seed=43):
    """The mixed_depth shape: 90% shallow retry histories, 10% deep."""
    rng = random.Random(seed)
    hs = [(f"wf-s{i}", f"run-s{i}", gen_mod.retry_deep_history(rng, depth=16))
          for i in range(n_shallow)]
    hs += [(f"wf-d{i}", f"run-d{i}",
            gen_mod.retry_deep_history(rng, depth=200))
           for i in range(n_deep)]
    order = random.Random(seed + 1).sample(range(len(hs)), len(hs))
    return [hs[i] for i in order]


def port_snapshots(results, n, bucketed):
    out = [None] * n
    base = 0
    for entry in results:
        if bucketed:
            idxs, packed, final = entry
        else:
            packed, final = entry
            rows = final.exec_info.shape[0]
            idxs = range(base, base + rows)
            base += rows
        for j, i in enumerate(idxs):
            out[i] = state_row_to_snapshot(final, j, packed.epoch_s)
    return out


def ref_snapshots(results, n, bucketed):
    out = [None] * n
    base = 0
    for entry in results:
        if bucketed:
            idxs, packed, final = entry
        else:
            packed, final = entry
            rows = final.exec_info.shape[0]
            idxs = range(base, base + rows)
            base += rows
        final = JS.StateTensors(*(np.asarray(getattr(final, f))
                                  for f in S.STATE_ROW_FIELDS))
        for j, i in enumerate(idxs):
            out[i] = JU.state_row_to_snapshot(final, j, packed.epoch_s)
    return out


@pytest.mark.parametrize("narrow", [True, False], ids=["int16", "int32"])
def test_replay_stream_bucketed_matches_reference(narrow):
    """bucket=True: depth buckets, lane packing and the kernel's packed
    route; every snapshot equals the reference dispatcher's."""
    hs = mixed_depth(W)
    jhs = mixed_depth(JW)
    got = D.replay_stream(hs, caps=CAPS, batch_size=16, bucket=True,
                          narrow=narrow, device="cpu")
    want = JD.replay_stream(jhs, caps=jcaps(CAPS), batch_size=16,
                            bucket=True, scan_mode="scan")
    assert len(got) == len(want) >= 3
    assert port_snapshots(got, len(hs), True) == ref_snapshots(
        want, len(hs), True)


@pytest.mark.parametrize("lane_pack", [False, True])
def test_replay_stream_batches_match_reference(lane_pack):
    hs = mixed_depth(W, n_shallow=9, n_deep=2, seed=5)
    jhs = mixed_depth(JW, n_shallow=9, n_deep=2, seed=5)
    got = D.replay_stream(hs, caps=CAPS, batch_size=4, lane_pack=lane_pack,
                          device="cpu")
    want = JD.replay_stream(jhs, caps=jcaps(CAPS), batch_size=4,
                            lane_pack=lane_pack, scan_mode="scan")
    assert port_snapshots(got, len(hs), False) == ref_snapshots(
        want, len(hs), False)


def test_replay_stream_resume_matches_full_replay():
    """Resumed histories (snapshot row + event suffix) replay through the
    dispatcher's lane route to the full history's state."""
    full = mixed_depth(W, n_shallow=6, n_deep=2, seed=7)
    cut = [len(b) // 2 for _, _, b in full]
    prefixes = [(w, r, b[:c]) for (w, r, b), c in zip(full, cut)]
    pk = P.pack_histories(prefixes, caps=CAPS)
    final = replay_packed(pk, device="cpu")
    resume = [P.ResumeState(pack=pk.side[i].resume,
                            side=pk.side[i].duplicate(),
                            state_row=S.state_row(final, i))
              for i in range(len(full))]
    resume[0] = None        # one history replays whole
    hs = [(w, r, b if res is None else b[c:])
          for (w, r, b), c, res in zip(full, cut, resume)]
    got = D.replay_stream(hs, caps=CAPS, bucket=True, resume=resume,
                          device="cpu")
    whole = D.replay_stream(full, caps=CAPS, bucket=True, device="cpu")
    assert port_snapshots(got, len(full), True) == port_snapshots(
        whole, len(full), True)


def test_depth_buckets_match_reference():
    hs = mixed_depth(W)
    got = [idxs for idxs, _ in D.depth_buckets(hs)]
    want = [idxs for idxs, _ in JD.depth_buckets(mixed_depth(JW))]
    assert got == want and len(got) >= 2


def test_dispatcher_strict_and_lenient_failures():
    """A batch that fails to pack raises its DispatchError in order
    (strict) or is yielded (strict=False) while later batches still run."""
    good = mixed_depth(W, n_shallow=3, n_deep=0, seed=3)
    bad = [("wf-bad", "run-bad", [[]])]
    with D.DeviceDispatcher(CAPS, device="cpu") as d:
        d.submit(0, good)
        d.submit(1, bad)
        d.submit(2, good)
        d.finish()
        out = list(d.results(strict=False))
    assert [type(o).__name__ for o in out] == [
        "tuple", "DispatchError", "tuple"]
    assert out[1].batch_id == 1

    with D.DeviceDispatcher(CAPS, device="cpu") as d:
        d.submit(0, bad)
        d.submit(1, good)
        d.finish()
        with pytest.raises(D.DispatchError):
            list(d.results())


def test_dispatcher_rejects_unknown_scan_mode():
    with pytest.raises(ValueError, match="scan_mode"):
        D.DeviceDispatcher(CAPS, scan_mode="fast", device="cpu")


# -- device-step telemetry ---------------------------------------------------

def device_series(registry):
    """The device layer's counters, gauges and timer counts, with the
    ``kernel`` tag left out (the reference names its routes xla|pallas,
    the port cuda|plain) and the ``jit_*`` series too (the reference
    counts jit executables, the port loaded kernel libraries)."""
    out = {}
    for table in ("_counters", "_gauges", "_timers"):
        for (name, tags), value in getattr(registry, table).items():
            if name.startswith("jit_"):
                continue
            rest = tuple((k, v) for k, v in tags if k != "kernel")
            out[(table, name, rest)] = (value.count if table == "_timers"
                                        else value)
    return out


def telemetry_histories(gen_mod, n=16, seed=7):
    rng = random.Random(seed)
    return [(f"wf-{i}", f"run-{i}",
             gen_mod.retry_deep_history(rng, depth=8 + 4 * (i % 3)))
            for i in range(n)]


def run_dispatcher(mod, hs, metrics, batch_size, **kw):
    with mod.DeviceDispatcher(metrics=metrics, **kw) as d:
        for i in range(0, len(hs), batch_size):
            d.submit(i, hs[i : i + batch_size])
        d.finish()
        return list(d.results())


# port keyword arguments, reference keyword arguments, expected mode.
# Batches of 8 sit on the round_scan_len grid, to which the reference
# pads every unpacked batch; the port pads only its assoc batches. The
# reference packs lanes off the TPU with seg_align=1, hence tb=1.
TELEMETRY_MODES = {
    "hist": (dict(), dict(scan_mode="scan"), "hist"),
    "lanes": (dict(lane_pack=True, lane_len=32, tb=1),
              dict(lane_pack=True, lane_len=32, scan_mode="scan"), "lanes"),
    "lanes_assoc": (dict(lane_pack=True, lane_len=32, tb=1,
                         scan_mode="assoc"),
                    dict(lane_pack=True, lane_len=32, scan_mode="assoc"),
                    "lanes_assoc"),
}


@pytest.mark.parametrize("mode", sorted(TELEMETRY_MODES))
def test_device_telemetry_matches_reference(mode):
    """On the same histories the port's dispatcher emits the reference's
    batches, widths, padding and occupancy exactly, and a wired scope
    changes no result."""
    from cadence_tpu.utils.metrics import Scope as JScope

    from cadence_tpu_torch.utils.metrics import Scope

    port_kw, ref_kw, want_mode = TELEMETRY_MODES[mode]
    hs, jhs = telemetry_histories(W), telemetry_histories(JW)
    metrics, jmetrics = Scope(), JScope()
    got = run_dispatcher(D, hs, metrics, 8, caps=CAPS, device="cpu",
                         **port_kw)
    bare = run_dispatcher(D, hs, None, 8, caps=CAPS, device="cpu", **port_kw)
    run_dispatcher(JD, jhs, jmetrics, 8, caps=jcaps(CAPS), kernel="xla",
                   **ref_kw)
    port, ref = device_series(metrics.registry), device_series(
        jmetrics.registry)
    assert port == ref
    reg = metrics.registry
    assert reg.counter_value("device_batches") == reg.counter_value(
        "device_batches", {"layer": "device", "kernel": "plain",
                           "mode": want_mode}) == 2
    assert reg.counter_value("batch_width") == 2
    assert reg.timer_stats("device_step_seconds").count == 2
    assert reg.gauge_value("jit_cache_entries") == 0
    for (_, _, g), (_, _, b) in zip(got, bare):
        for f in S.STATE_ROW_FIELDS:
            assert np.array_equal(getattr(g, f).numpy(),
                                  getattr(b, f).numpy()), f


def test_device_telemetry_reports_the_ported_batch_width():
    """Off the grid, an unpacked batch reports the width it was replayed
    at, with the reference's padding definition over that width."""
    from cadence_tpu_torch.utils.metrics import Scope

    hs = telemetry_histories(W, n=3)
    metrics = Scope()
    (_, packed, _), = run_dispatcher(D, hs, metrics, 3, caps=CAPS,
                                     device="cpu")
    reg = metrics.registry
    real = sum(D.history_depth(h[2]) for h in hs)
    want = (3 * packed.events.shape[1] - real) / real
    assert packed.batch == 3
    assert reg.gauge_value("padding_frac") == want
    assert reg.counter_value("batch_width", {
        "layer": "device", "kernel": "plain", "mode": "hist",
        "width": "3"}) == 1


def test_telemetry_off_measures_nothing(monkeypatch):
    """Without a scope, or with the shared NOOP, the pumps neither time
    nor synchronise: no clock is read on the default path."""
    from cadence_tpu_torch.utils.metrics import NOOP

    assert D.DeviceDispatcher(device="cpu")._telemetry is False
    assert D.DeviceDispatcher(metrics=NOOP, device="cpu")._telemetry is False

    def no_clock():
        raise AssertionError("the default path read the clock")

    monkeypatch.setattr(D, "perf_counter", no_clock)
    out = D.replay_stream(telemetry_histories(W, n=4), caps=CAPS,
                          batch_size=2, device="cpu")
    out += D.replay_stream(telemetry_histories(W, n=4), caps=CAPS,
                           batch_size=2, metrics=NOOP, device="cpu")
    assert len(out) == 4


def test_telemetry_fault_never_fails_a_batch(monkeypatch):
    """An emission that raises leaves the batch's result as it was."""
    from cadence_tpu_torch.utils.metrics import Scope

    def broken(*_):
        raise RuntimeError("telemetry broke")

    hs = telemetry_histories(W, n=4)
    monkeypatch.setattr(D.DeviceDispatcher, "_emit_stage_telemetry", broken)
    monkeypatch.setattr(D.DeviceDispatcher, "_emit_step_telemetry", broken)
    got = D.replay_stream(hs, caps=CAPS, batch_size=2, metrics=Scope(),
                          device="cpu")
    want = D.replay_stream(hs, caps=CAPS, batch_size=2, device="cpu")
    assert port_snapshots(got, 4, False) == port_snapshots(want, 4, False)


def test_kernel_library_growth_counts_retraces(monkeypatch):
    """A kernel library loaded between two batches counts as a retrace,
    across dispatcher lifetimes; a steady count adds none."""
    from cadence_tpu_torch.ops import _build
    from cadence_tpu_torch.utils.metrics import Scope

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(D, "_libs_prev", None)
    hs = telemetry_histories(W, n=2)
    metrics = Scope()
    D.replay_stream(hs, caps=CAPS, metrics=metrics, device="cpu")
    _build._libs["replay_fsm"] = object()
    D.replay_stream(hs, caps=CAPS, metrics=metrics, device="cpu")
    D.replay_stream(hs, caps=CAPS, metrics=metrics, device="cpu")
    reg = metrics.registry
    assert reg.gauge_value("jit_cache_entries") == 1
    assert reg.counter_value("jit_retraces") == 1
