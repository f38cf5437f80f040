"""The port's FSM replay against the reference package, exactly.

``replay_rows_plain`` (the plain PyTorch version of the CUDA kernel, and
what the kernel wrapper runs for CPU tensors) is held against the
reference's Pallas kernel in interpret mode and against its XLA scan; the
facades ``replay_packed`` / ``replay_packed_lanes`` on ``device="cpu"``
against the reference facades with ``scan_mode="scan"``. Every field is
int32 and every comparison is ``np.array_equal``.
"""

import random
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_tpu.core import history_factory as JF
from cadence_tpu.ops import pack as JP
from cadence_tpu.ops import schema as JS
from cadence_tpu.ops.replay import replay_packed as j_replay_packed
from cadence_tpu.ops.replay import replay_scan_jit
from cadence_tpu.ops.replay import replay_scan_packed as j_replay_scan_packed
from cadence_tpu.ops.replay_pallas import (
    replay_scan_pallas_packed, replay_scan_pallas_teb,
)
from cadence_tpu.testing import workloads as JW
from cadence_tpu.testing.event_generator import HistoryFuzzer

from cadence_tpu_torch.core import history_factory as F
from cadence_tpu_torch.core.enums import (
    EventType as E, ParentClosePolicy, TimeoutType,
)
from cadence_tpu_torch.ops import _build
from cadence_tpu_torch.ops import pack as P
from cadence_tpu_torch.ops import replay_cuda as RC
from cadence_tpu_torch.ops import schema as S
from cadence_tpu_torch.ops.replay import replay_packed, replay_packed_lanes
from cadence_tpu_torch.ops.unpack import (
    split_lane_snapshots, state_row_to_snapshot,
)
from cadence_tpu_torch.testing import workloads as W

# the reference's Pallas parity sizes (tests/test_replay_pallas.py)
CAPS = S.Capacities(
    max_events=96, max_activities=4, max_timers=4, max_children=4,
    max_request_cancels=2, max_signals_ext=2, max_version_items=4,
)
FAST_CAPS = S.Capacities(
    max_events=16, max_activities=2, max_timers=2, max_children=2,
    max_request_cancels=1, max_signals_ext=1, max_version_items=2,
)


def jcaps(caps):
    return JS.Capacities(**{f: getattr(caps, f)
                            for f in caps.__dataclass_fields__})


def assert_state_equal(got, want):
    for f in S.STATE_ROW_FIELDS:
        g = np.asarray(S.state_to_numpy(got).__dict__[f])
        w = np.asarray(getattr(want, f))
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w, err_msg=f"field {f} diverged")


def fuzz(caps, n, seed, target=60, **kw):
    fz = HistoryFuzzer(seed=seed, caps=jcaps(caps), **kw)
    return [(f"wf-{i}", f"run-{i}", fz.generate(target_events=target))
            for i in range(n)]


def plain_replay(teb, caps, state=None, base=None, wide=()):
    """Port: [T, P, B] numpy events -> numpy StateTensors via the plain
    version."""
    b = teb.shape[2]
    rm = RC.RowMap(caps)
    st = state if state is not None else S.empty_state(b, caps)
    rows = RC.state_to_rows(S.state_from_numpy(st, "cpu"), rm)
    out = RC.replay_rows_plain(S.host_tensor(teb),
                               rows, caps, base, wide)
    return S.state_to_numpy(RC.rows_to_state(out, rm))


def xla_replay(events_bte, caps, state=None):
    """Reference: batch-major [B, T, EV_N] events through the XLA scan."""
    b = events_bte.shape[0]
    st = state if state is not None else JS.empty_state(b, jcaps(caps))
    st = jax.tree_util.tree_map(jnp.asarray, st)
    ev_tm = jnp.asarray(np.ascontiguousarray(
        np.transpose(events_bte, (1, 0, 2))))
    return jax.tree_util.tree_map(np.asarray, replay_scan_jit(st, ev_tm))


def random_events(caps, t, b, seed, pad_frac=0.1):
    """Seeded random events [B, T, EV_N] over every event type, slots
    from -1 to past the largest table, frequent version changes and
    padding steps; values narrow except one hash-wide column."""
    rng = np.random.default_rng(seed)
    ev = np.zeros((b, t, S.EV_N), np.int32)
    ev[:, :, S.EV_TYPE] = rng.integers(0, len(E), size=(b, t))
    ev[:, :, S.EV_TYPE][rng.random((b, t)) < pad_frac] = -1
    ev[:, :, S.EV_ID] = np.arange(1, t + 1)[None, :]
    ev[:, :, S.EV_VERSION] = rng.choice([-24, 1, 2, 3, 10], size=(b, t))
    ev[:, :, S.EV_TASK_ID] = rng.integers(-1234, 5000, size=(b, t))
    ev[:, :, S.EV_TS] = rng.integers(0, 30000, size=(b, t))
    ev[:, :, S.EV_BATCH_FIRST] = rng.integers(1, t + 1, size=(b, t))
    ev[:, :, S.EV_IS_BATCH_LAST] = rng.integers(0, 2, size=(b, t))
    top = max(caps.max_activities, caps.max_timers, caps.max_children,
              caps.max_request_cancels, caps.max_signals_ext)
    ev[:, :, S.EV_SLOT] = rng.integers(-1, top + 2, size=(b, t))
    for c in range(S.EV_A0, S.EV_N):
        ev[:, :, c] = rng.integers(-3, 20, size=(b, t))
    ev[:, :, S.EV_A0] = rng.integers(0, 2**31 - 1, size=(b, t))
    # decision timeouts: about half ScheduleToStart (no attempt bump)
    dto = ev[:, :, S.EV_TYPE] == int(E.DecisionTaskTimedOut)
    ev[:, :, S.EV_A0][dto] = rng.integers(0, 2, size=int(dto.sum()))
    return ev


# --------------------------------------------------------------------------
# the plain version against the reference kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("narrow", [False, True], ids=["int32", "int16"])
def test_plain_matches_pallas_interpret(narrow):
    """replay_rows_plain == replay_scan_pallas_teb (interpret mode,
    bt=1024, tb=8) at FAST_CAPS, on the int32 and the narrow stream."""
    hs = fuzz(FAST_CAPS, 6, seed=6, target=10)
    pk = P.pack_histories(hs, caps=FAST_CAPS)
    teb = pk.teb()
    b = teb.shape[2]
    state0 = jax.tree_util.tree_map(
        jnp.asarray, JS.empty_state(b, jcaps(FAST_CAPS)))
    base, wide = None, ()
    if narrow:
        narrowed = RC.narrow_events_teb(teb)
        assert narrowed is not None
        teb, base, wide = narrowed
    want = replay_scan_pallas_teb(
        state0, jnp.asarray(teb), jcaps(FAST_CAPS), tb=8, interpret=True,
        bt=1024, base=base, wide_cols=wide)
    assert_state_equal(plain_replay(teb, FAST_CAPS, base=base, wide=wide),
                       want)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plain_matches_xla_scan_on_fuzzed_histories(seed):
    hs = fuzz(CAPS, 16, seed=seed, target=70)
    pk = P.pack_histories(hs, caps=CAPS)
    assert_state_equal(plain_replay(pk.teb(), CAPS),
                       xla_replay(pk.events, CAPS))


def test_plain_matches_xla_scan_past_version_capacity():
    """Histories with more version changes than max_version_items:
    vh_len runs past capacity and AddOrUpdateItem reads the clamped
    last slot. (The packer refuses such histories at its own caps, so
    they are packed at a wider version table and replayed at CAPS.)"""
    wide_vh = S.Capacities(**{**CAPS.__dict__, "max_version_items": 12})
    hs = fuzz(wide_vh, 12, seed=9, target=80, version_bump_prob=0.4)
    pk = P.pack_histories(hs, caps=wide_vh)
    got = plain_replay(pk.teb(), CAPS)
    assert (got.vh_len > CAPS.max_version_items).any()
    assert_state_equal(got, xla_replay(pk.events, CAPS))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_xla_scan_on_random_events(seed):
    """Every event type, out-of-range slots (-1 and >= cap), version
    changes past capacity, padding steps and read-after-write within a
    step, on random event tensors."""
    ev = random_events(CAPS, 64, 48, seed)
    got = plain_replay(np.ascontiguousarray(np.transpose(ev, (1, 2, 0))),
                       CAPS)
    assert (got.vh_len > CAPS.max_version_items).any()
    assert_state_equal(got, xla_replay(ev, CAPS))


@pytest.mark.parametrize("force_wide", [(), (S.EV_ID, S.EV_TS, S.EV_A6)])
def test_plain_narrow_stream_matches_int32(force_wide):
    """The narrow stream (affine and wide columns, forced-wide ones
    included) rebuilds the int32 events exactly; padding reconstructs
    EV_TYPE -1 through the base."""
    ev = random_events(CAPS, 48, 40, seed=4, pad_frac=0.3)
    teb = np.ascontiguousarray(np.transpose(ev, (1, 2, 0)))
    ev16, base, wide = RC.narrow_events_teb(teb, force_wide=force_wide)
    assert ev16.dtype == np.int16 and S.EV_A0 in wide
    assert set(force_wide) <= set(wide)
    assert_state_equal(plain_replay(ev16, CAPS, base=base, wide=wide),
                       plain_replay(teb, CAPS))


def test_plain_step_window_and_wrapper_on_cpu():
    """Replaying [0, k) then [k, T) equals one pass; the wrapper takes
    the plain version for CPU tensors and counts no launch."""
    ev = random_events(CAPS, 40, 16, seed=5)
    teb = torch.from_numpy(np.ascontiguousarray(np.transpose(ev, (1, 2, 0))))
    rm = RC.RowMap(CAPS)
    rows = RC.state_to_rows(
        S.state_from_numpy(S.empty_state(16, CAPS), "cpu"), rm)
    whole = RC.replay_rows_plain(teb, rows, CAPS)
    before = RC.replay_rows.launches
    half = RC.replay_rows(teb, rows, CAPS, t0=0, t1=17)
    split = RC.replay_rows(teb, half, CAPS, t0=17, t1=40, out=half)
    assert split is half
    assert torch.equal(split, whole)
    assert RC.replay_rows.launches == before
    with pytest.raises(ValueError, match="rows"):
        RC.replay_rows_plain(teb, rows[:, :8], CAPS)
    with pytest.raises(ValueError, match="base"):
        RC.replay_rows_plain(teb.to(torch.int16), rows, CAPS)


def _hand_history(FM):
    """A hand-built history exercising children, external cancels,
    external signals, activities, timers, decision timeout and failure,
    a failover version change and continue-as-new. ``FM``: either
    package's history_factory."""
    s = 1_000_000_000
    t0 = 1_700_000_000 * s
    v = 10
    b = []
    eid = iter(range(1, 1000))
    n = lambda: next(eid)  # noqa: E731

    def decision(ver, ts):
        sch, sta, com = n(), n(), n()
        b.append([FM.decision_task_scheduled(sch, ver, ts)])
        b.append([FM.decision_task_started(sta, ver, ts + s,
                                           scheduled_event_id=sch)])
        return sch, sta, com

    b.append([FM.workflow_execution_started(n(), v, t0)])
    sch, sta, com = decision(v, t0)
    ch, rc, sg, act, tim = n(), n(), n(), n(), n()
    b.append([
        FM.decision_task_completed(com, v, t0 + 2 * s,
                                   scheduled_event_id=sch,
                                   started_event_id=sta),
        FM.start_child_initiated(ch, v, t0 + 2 * s, domain="d",
                                 workflow_id="child-1",
                                 decision_task_completed_event_id=com,
                                 parent_close_policy=ParentClosePolicy.
                                 RequestCancel),
        FM.request_cancel_external_initiated(
            rc, v, t0 + 2 * s, domain="d", workflow_id="other",
            decision_task_completed_event_id=com),
        FM.signal_external_initiated(
            sg, v, t0 + 2 * s, domain="d", workflow_id="other2",
            decision_task_completed_event_id=com),
        FM.activity_task_scheduled(act, v, t0 + 2 * s, activity_id="a1",
                                   decision_task_completed_event_id=com),
        FM.timer_started(tim, v, t0 + 2 * s, timer_id="t1",
                         start_to_fire_timeout_seconds=30,
                         decision_task_completed_event_id=com),
    ])
    cs = n()
    b.append([FM.child_execution_started(cs, v, t0 + 3 * s,
                                         initiated_event_id=ch,
                                         domain="d", workflow_id="child-1",
                                         run_id="child-run")])
    b.append([FM.external_workflow_execution_cancel_requested(
        n(), v, t0 + 4 * s, initiated_event_id=rc)])
    b.append([FM.workflow_execution_signaled(n(), v, t0 + 4 * s)])
    # failover: a new version from here on
    v2 = 12
    sch2 = n()
    b.append([FM.decision_task_scheduled(sch2, v2, t0 + 5 * s)])
    b.append([FM.decision_task_timed_out(
        n(), v2, t0 + 15 * s, scheduled_event_id=sch2,
        timeout_type=TimeoutType.ScheduleToStart)])
    sch3, sta3 = n(), n()
    b.append([FM.decision_task_scheduled(sch3, v2, t0 + 16 * s)])
    b.append([FM.decision_task_started(sta3, v2, t0 + 17 * s,
                                       scheduled_event_id=sch3)])
    b.append([FM.decision_task_failed(n(), v2, t0 + 18 * s,
                                      scheduled_event_id=sch3,
                                      started_event_id=sta3)])
    b.append([FM.external_workflow_execution_signaled(
        n(), v2, t0 + 19 * s, initiated_event_id=sg)])
    b.append([FM.child_execution_completed(n(), v2, t0 + 20 * s,
                                           initiated_event_id=ch,
                                           started_event_id=cs)])
    sch4, sta4, com4 = decision(v2, t0 + 21 * s)
    b.append([
        FM.decision_task_completed(com4, v2, t0 + 23 * s,
                                   scheduled_event_id=sch4,
                                   started_event_id=sta4),
        FM.workflow_execution_continued_as_new(
            n(), v2, t0 + 23 * s, new_execution_run_id="run-next",
            decision_task_completed_event_id=com4),
    ])
    return b


def test_hand_built_history_matches_reference():
    hs = [("wf-hand", "run-hand", _hand_history(F))]
    jhs = [("wf-hand", "run-hand", _hand_history(JF))]
    pk = P.pack_histories(hs, caps=CAPS)
    jpk = JP.pack_histories(jhs, caps=jcaps(CAPS))
    np.testing.assert_array_equal(pk.events, jpk.events)
    types = set(pk.events[0, :, S.EV_TYPE].tolist())
    for et in (E.StartChildWorkflowExecutionInitiated,
               E.ExternalWorkflowExecutionCancelRequested,
               E.ExternalWorkflowExecutionSignaled,
               E.WorkflowExecutionContinuedAsNew):
        assert int(et) in types
    got = replay_packed(pk, device="cpu")
    want = j_replay_packed(jpk, scan_mode="scan")
    assert_state_equal(got, want)
    snap = state_row_to_snapshot(got, 0, pk.epoch_s)
    assert snap["exec"]["close_status"] == 5      # continued as new
    assert snap["version_history"][-1][1] == 12
    assert len(snap["activities"]) == 1 and len(snap["timers"]) == 1


# --------------------------------------------------------------------------
# the facades on device="cpu" against the reference facades
# --------------------------------------------------------------------------


RETRY_CAPS = S.Capacities(max_events=256, max_activities=4, max_timers=2,
                          max_children=2, max_request_cancels=2,
                          max_signals_ext=2, max_version_items=2)


def _retry(gen_mod, n, depth, seed=5, prefix=""):
    rng = random.Random(seed)
    return [(f"wf-{prefix}{i}", f"run-{prefix}{i}",
             gen_mod.retry_deep_history(rng, depth=depth)) for i in range(n)]


@pytest.mark.parametrize("narrow", [False, True], ids=["int32", "int16"])
def test_replay_packed_matches_reference(narrow):
    hs = _retry(W, 10, 150)
    jhs = _retry(JW, 10, 150)
    got = replay_packed(P.pack_histories(hs, caps=RETRY_CAPS),
                        device="cpu", narrow=narrow)
    want = j_replay_packed(JP.pack_histories(jhs, caps=jcaps(RETRY_CAPS)),
                           scan_mode="scan")
    assert_state_equal(got, want)


def test_replay_packed_rejects_unknown_scan_mode():
    pk = P.pack_histories(_retry(W, 1, 20), caps=RETRY_CAPS)
    with pytest.raises(ValueError, match="scan_mode"):
        replay_packed(pk, scan_mode="asoc", device="cpu")
    # every known mode gives the sequential kernel's state
    a = replay_packed(pk, scan_mode="assoc", device="cpu")
    assert_state_equal(a, replay_packed(pk, scan_mode="scan", device="cpu"))


def _resume_states(mod_pack, replay_fn, caps, prefixes):
    """Checkpoint-shaped resume states from replaying history prefixes
    (either package)."""
    pk = mod_pack.pack_histories(prefixes, caps=caps)
    final = replay_fn(pk)
    return [
        mod_pack.ResumeState(pack=pk.side[i].resume,
                             side=pk.side[i].duplicate(),
                             state_row={f: np.array(np.asarray(
                                 getattr(final, f))[i], np.int32)
                                 for f in S.STATE_ROW_FIELDS})
        for i in range(len(prefixes))
    ]


@pytest.mark.parametrize("seg_align", [1, 8])
def test_replay_packed_lanes_with_resume_matches_reference(seg_align):
    """Lane-packed replay with initial= resume rows: the port's packed
    route (kernel block flushes) equals the reference's packed scan, and
    each resumed snapshot equals the full history's."""
    full = _retry(W, 6, 120, seed=8) + _retry(W, 6, 30, seed=9, prefix="s")
    jfull = (_retry(JW, 6, 120, seed=8)
             + _retry(JW, 6, 30, seed=9, prefix="s"))
    cut = [len(h[2]) // 2 for h in full]
    prefixes = [(w, r, b[:c]) for (w, r, b), c in zip(full, cut)]
    suffixes = [(w, r, b[c:]) for (w, r, b), c in zip(full, cut)]
    jprefixes = [(w, r, b[:c]) for (w, r, b), c in zip(jfull, cut)]
    jsuffixes = [(w, r, b[c:]) for (w, r, b), c in zip(jfull, cut)]
    jc = jcaps(RETRY_CAPS)

    res = _resume_states(P, lambda p: replay_packed(p, device="cpu"),
                         RETRY_CAPS, prefixes)
    jres = _resume_states(
        JP, lambda p: j_replay_packed(p, scan_mode="scan"), jc, jprefixes)
    lanes = P.pack_lanes(suffixes, caps=RETRY_CAPS, target_lane_len=128,
                         seg_align=seg_align, resume=res)
    jlanes = JP.pack_lanes(jsuffixes, caps=jc, target_lane_len=128,
                           seg_align=seg_align, resume=jres)
    assert lanes.initial is not None
    got = replay_packed_lanes(lanes, initial=lanes.initial, device="cpu")
    want = j_replay_packed(jlanes, initial=jlanes.initial, scan_mode="scan")
    assert_state_equal(got, want)

    whole = P.pack_lanes(full, caps=RETRY_CAPS, target_lane_len=256,
                         seg_align=seg_align)
    assert (split_lane_snapshots(lanes, got)
            == split_lane_snapshots(whole, replay_packed(whole,
                                                         device="cpu")))


def test_replay_scan_packed_rejects_misaligned_segments():
    """Segment ends off any block edge are no longer rejected: a
    ``seg_align=1`` pack through ``replay_scan_packed`` (one launch, a
    flush at each segment's own end step) equals the reference's packed
    route on the same pack."""
    hs, jhs = _retry(W, 5, 20), _retry(JW, 5, 20)
    lanes = P.pack_lanes(hs, caps=RETRY_CAPS, target_lane_len=64,
                         seg_align=1)
    jlanes = JP.pack_lanes(jhs, caps=jcaps(RETRY_CAPS), target_lane_len=64,
                           seg_align=1)
    assert lanes.seg_end[:, : lanes.scan_len - 1].any()   # interior ends
    st = S.state_from_numpy(S.empty_state(lanes.lanes, RETRY_CAPS), "cpu")
    out0 = S.state_from_numpy(S.empty_state(5, RETRY_CAPS), "cpu")
    _, got = RC.replay_scan_packed(st, out0, torch.from_numpy(lanes.teb()),
                                   lanes.seg_end, lanes.out_row, RETRY_CAPS)
    want = j_replay_packed(jlanes, scan_mode="scan")
    assert_state_equal(got, want)


# --------------------------------------------------------------------------
# the fused packed route on random events against both reference routes
# --------------------------------------------------------------------------


def random_packing(caps, lanes, t, n_init, seed, tb=1):
    """Random packed-route operands: events [L, T, EV_N] (every type,
    padding, out-of-range slots), segment ends at random ``tb``-aligned
    steps with every lane's last one at T - 1, a permuted output row per
    segment, reset rows into ``n_init`` initial carries (the sentinel
    ``n_init`` included), and random lane and init states."""
    rng = np.random.default_rng(seed)
    ev = random_events(caps, t, lanes, seed)
    seg_end = np.zeros((lanes, t), bool)
    seg_end[:, tb - 1 :: tb] = rng.random((lanes, t // tb)) < 0.2
    seg_end[:, t - 1] = True
    n_seg = int(seg_end.sum())
    out_row = np.zeros((lanes, t), np.int32)
    out_row[seg_end] = rng.permutation(n_seg)
    reset_row = np.zeros((lanes, t), np.int32)
    reset_row[seg_end] = rng.integers(0, n_init + 1, n_seg)

    def rand_state(n):
        return S.empty_state(n, caps).map(
            lambda a: rng.integers(-5, 6, size=a.shape, dtype=np.int32))

    return ev, seg_end, out_row, reset_row, rand_state(lanes), \
        rand_state(n_init), n_seg


def jax_state(st):
    """A port (numpy) StateTensors as the reference's, on the device."""
    return JS.StateTensors(*(jnp.asarray(getattr(st, f))
                             for f in S.STATE_ROW_FIELDS))


def port_packed(ev, seg_end, out_row, reset_row, state, init, caps,
                n_out, narrow):
    """The port's packed route on the CPU; returns numpy (lanes, out)."""
    teb = np.ascontiguousarray(np.transpose(ev, (1, 2, 0)))
    base, wide = None, ()
    if narrow:
        narrowed = RC.narrow_events_teb(teb)
        assert narrowed is not None
        teb, base, wide = narrowed
    kw = {}
    if init is not None:
        kw = dict(init=S.state_from_numpy(init, "cpu"), reset_row=reset_row)
    lanes, out = RC.replay_scan_packed(
        S.state_from_numpy(state, "cpu"),
        S.state_from_numpy(S.empty_state(n_out, caps), "cpu"),
        torch.from_numpy(teb), seg_end, out_row, caps, base=base,
        wide_cols=wide, **kw)
    return lanes, out


@pytest.mark.parametrize("resume", [False, True], ids=["empty", "init"])
@pytest.mark.parametrize("narrow", [False, True], ids=["int32", "int16"])
def test_packed_route_matches_xla_packed_scan(narrow, resume):
    """``replay_scan_packed`` (the plain fused route on the CPU) against
    the reference's XLA packed scan on random events, with segment ends
    at arbitrary steps, permuted output rows and resets into ``init``
    (sentinel row included): output rows and final lane carries, exact."""
    L, T, n_init = 200, 128, 7
    ev, seg_end, out_row, reset_row, state, init, n_seg = random_packing(
        CAPS, L, T, n_init, seed=11 + 2 * narrow + resume)
    init = init if resume else None
    lanes, out = port_packed(ev, seg_end, out_row, reset_row, state, init,
                             CAPS, n_seg + 3, narrow)
    kw = {}
    if resume:
        kw = dict(init=jax_state(init),
                  reset_row_tm=jnp.asarray(reset_row.T.copy()))
    want_lanes, want = j_replay_scan_packed(
        jax_state(state), jax_state(S.empty_state(n_seg + 3, CAPS)),
        jnp.asarray(np.ascontiguousarray(np.transpose(ev, (1, 0, 2)))),
        jnp.asarray(seg_end.T.copy()), jnp.asarray(out_row.T.copy()), **kw)
    assert_state_equal(out, jax.tree_util.tree_map(np.asarray, want))
    assert_state_equal(lanes,
                       jax.tree_util.tree_map(np.asarray, want_lanes))


@pytest.mark.parametrize("resume", [False, True], ids=["empty", "init"])
@pytest.mark.parametrize("narrow", [False, True], ids=["int32", "int16"])
def test_packed_route_matches_pallas_interpret(narrow, resume):
    """The same against the reference's Pallas packed route in interpret
    mode, whose between-block flush needs tb-aligned segment ends."""
    L, T, n_init, tb = 64, 64, 5, 8
    ev, seg_end, out_row, reset_row, state, init, n_seg = random_packing(
        FAST_CAPS, L, T, n_init, seed=21 + 2 * narrow + resume, tb=tb)
    init = init if resume else None
    lanes, out = port_packed(ev, seg_end, out_row, reset_row, state, init,
                             FAST_CAPS, n_seg, narrow)
    teb = np.ascontiguousarray(np.transpose(ev, (1, 2, 0)))
    base, wide = None, ()
    if narrow:
        teb, base, wide = RC.narrow_events_teb(teb)
    jc = jcaps(FAST_CAPS)
    kw = {}
    if resume:
        kw = dict(init=jax_state(init), reset_row=jnp.asarray(reset_row))
    want_lanes, want = replay_scan_pallas_packed(
        jax_state(state), jax_state(S.empty_state(n_seg, FAST_CAPS)),
        jnp.asarray(teb), jnp.asarray(seg_end), jnp.asarray(out_row), jc,
        tb=tb, interpret=True, bt=1024, base=base, wide_cols=wide, **kw)
    assert_state_equal(out, jax.tree_util.tree_map(np.asarray, want))
    assert_state_equal(lanes,
                       jax.tree_util.tree_map(np.asarray, want_lanes))


def test_packed_plain_out_of_range_columns_write_nothing():
    """An output or reset column out of range writes nothing: the output
    rows keep their values and the lane carries on unreset, so with every
    column out of range the lanes end as one unpacked replay does."""
    L, T = 24, 40
    ev, seg_end, _, _, state, init, n_seg = random_packing(
        CAPS, L, T, 3, seed=31)
    teb = torch.from_numpy(np.ascontiguousarray(np.transpose(ev, (1, 2, 0))))
    rm = RC.RowMap(CAPS)
    rows = RC.state_to_rows(S.state_from_numpy(state, "cpu"), rm)
    init_rows = RC.state_to_rows(S.state_from_numpy(init, "cpu"), rm)
    out_rows = torch.full((rm.rows_padded, 4), 7, dtype=torch.int32)
    rng = np.random.default_rng(3)
    bad_out = np.where(seg_end, rng.choice([-1, 4, 99], seg_end.shape), 0)
    bad_reset = np.where(seg_end, rng.choice([-1, 4, 50], seg_end.shape), 0)
    ptr, ends = RC.segment_list(seg_end, bad_out, bad_reset)
    assert len(ends) == n_seg
    got, got_out = RC.replay_rows_packed_plain(
        teb, rows, CAPS, ptr, ends, out_rows, init_rows)
    assert torch.equal(got, RC.replay_rows_plain(teb, rows, CAPS))
    assert torch.equal(got_out, out_rows)
    # one segment back in range: its lane flushes there and resets
    ln = int(np.nonzero(seg_end[:, : T - 1].any(axis=1))[0][0])
    t = int(np.nonzero(seg_end[ln])[0][0])
    ends[ptr[ln], 1:] = (2, 1)
    got, got_out = RC.replay_rows_packed_plain(
        teb, rows, CAPS, ptr, ends, out_rows, init_rows)
    head = RC.replay_rows_plain(teb, rows, CAPS, t0=0, t1=t + 1)
    assert torch.equal(got_out[:, 2], head[:, ln])
    assert torch.equal(got_out[:, [0, 1, 3]], out_rows[:, [0, 1, 3]])
    restart = head.clone()
    restart[:, ln] = init_rows[:, 1]
    tail = RC.replay_rows_plain(teb, restart, CAPS, t0=t + 1, t1=T)
    assert torch.equal(got[:, ln], tail[:, ln])


@pytest.mark.parametrize("window", [(7, 7), (7, 8), (0, 1), (39, 40)])
def test_replay_rows_one_step_and_empty_windows_on_cpu(window):
    """``replay_rows`` over an empty window returns the rows unchanged and
    over a one-step window applies exactly that step (what the hybrid
    chunker launches), without counting a launch on the CPU."""
    t0, t1 = window
    ev = random_events(CAPS, 40, 16, seed=6)
    teb = torch.from_numpy(np.ascontiguousarray(np.transpose(ev, (1, 2, 0))))
    rm = RC.RowMap(CAPS)
    rows = RC.replay_rows_plain(
        teb, RC.state_to_rows(
            S.state_from_numpy(S.empty_state(16, CAPS), "cpu"), rm),
        CAPS, t0=0, t1=t0)
    before = RC.replay_rows.launches
    out = torch.empty_like(rows)
    got = RC.replay_rows(teb, rows, CAPS, t0=t0, t1=t1, out=out)
    assert got is out
    want = rows if t0 == t1 else RC.replay_rows_plain(teb[t0:t1], rows, CAPS)
    assert torch.equal(got, want)
    assert RC.replay_rows.launches == before


# --------------------------------------------------------------------------
# the kernel's launch plan, chosen from the shape alone
# --------------------------------------------------------------------------

# the deployments' capacities: retry_deep (R_pad 152), the default full
# tables (944) and the serving plane's (120)
RETRY_DEEP_CAPS = S.Capacities(
    max_events=1024, max_activities=4, max_timers=2, max_children=2,
    max_request_cancels=2, max_signals_ext=2, max_version_items=2)
SERVE_CAPS = S.Capacities(
    max_events=512, max_activities=2, max_timers=2, max_children=2,
    max_request_cancels=2, max_signals_ext=4, max_version_items=2)
PLAN_CAPS = {120: SERVE_CAPS, 152: RETRY_DEEP_CAPS, 944: S.Capacities()}
ROUTE_CASES = [
    (RETRY_DEEP_CAPS, 262_144, "shared"),  # retry_deep storm
    (RETRY_DEEP_CAPS, 1_048_576, "shared"),  # retry_deep resume tail
    (S.Capacities(), 32_768, "wide"),  # ndc_storm storm
    (S.Capacities(), 256, "shared"),  # the rebuilder's cold batch
    (S.Capacities(), 64, "shared"),  # the replication storm's batch
    (SERVE_CAPS, 4_096, "shared"),  # the serving tick
]

# The launch plans read on an H100 80GB HBM3 (power limit 700 W) from the
# kernel library's own planner, which asked the CUDA runtime for the
# card's attributes and, on the wide route, its occupancy calculator,
# before the plan moved to Python: (R_pad, B, event dtype, P, the events'
# base address modulo 16) -> (route, lanes per block, steps per ring
# stage, request bytes, shared bytes a block, blocks per SM, warps per
# SM). P is 16 for int32; 17 and 18 are the int16 narrow streams of the
# retry_deep and ndc_storm histories (one and two wide columns). Every
# ROUTE_CASES shape and every benchmark cell's is here.
FROZEN_PLANS = [
    (120, 64, "int32", 16, 0, "shared", 32, 16, 16, 110336, 2, 2),
    (120, 64, "int16", 17, 0, "shared", 32, 16, 16, 64256, 3, 3),
    (120, 64, "int16", 18, 0, "shared", 32, 16, 16, 67328, 3, 3),
    (120, 256, "int32", 16, 0, "shared", 32, 16, 16, 110336, 2, 2),
    (120, 256, "int16", 17, 0, "shared", 32, 16, 16, 64256, 3, 3),
    (120, 256, "int16", 18, 0, "shared", 32, 16, 16, 67328, 3, 3),
    (120, 2045, "int32", 16, 0, "shared", 32, 16, 4, 110336, 2, 2),
    (120, 2045, "int16", 17, 0, "shared", 32, 16, 2, 64256, 3, 3),
    (120, 2045, "int16", 18, 0, "shared", 32, 16, 2, 67328, 3, 3),
    (120, 2046, "int32", 16, 0, "shared", 32, 16, 8, 110336, 2, 2),
    (120, 2046, "int16", 17, 0, "shared", 32, 16, 4, 64256, 3, 3),
    (120, 2046, "int16", 18, 0, "shared", 32, 16, 4, 67328, 3, 3),
    (120, 4096, "int32", 16, 0, "shared", 32, 16, 16, 110336, 2, 2),
    (120, 4096, "int16", 17, 0, "shared", 32, 16, 16, 64256, 3, 3),
    (120, 4096, "int16", 18, 0, "shared", 32, 16, 16, 67328, 3, 3),
    (120, 4224, "int32", 16, 0, "shared", 32, 16, 16, 110336, 2, 2),
    (120, 4224, "int16", 17, 0, "shared", 32, 16, 16, 64256, 3, 3),
    (120, 4224, "int16", 18, 0, "shared", 32, 16, 16, 67328, 3, 3),
    (120, 4352, "int32", 16, 0, "shared", 32, 16, 16, 110336, 2, 2),
    (120, 4352, "int16", 17, 0, "shared", 32, 16, 16, 64256, 3, 3),
    (120, 4352, "int16", 18, 0, "shared", 32, 16, 16, 67328, 3, 3),
    (120, 8192, "int32", 16, 0, "shared", 32, 16, 16, 110336, 2, 2),
    (120, 8192, "int16", 17, 0, "shared", 32, 16, 16, 64256, 3, 3),
    (120, 8192, "int16", 18, 0, "shared", 32, 16, 16, 67328, 3, 3),
    (120, 16384, "int32", 16, 0, "shared", 64, 7, 16, 110080, 2, 4),
    (120, 16384, "int16", 17, 0, "shared", 64, 14, 16, 115456, 2, 4),
    (120, 16384, "int16", 18, 0, "shared", 64, 13, 16, 113920, 2, 4),
    (120, 32768, "int32", 16, 0, "shared", 128, 2, 16, 97280, 2, 8),
    (120, 32768, "int16", 17, 0, "shared", 128, 5, 16, 113408, 2, 8),
    (120, 32768, "int16", 18, 0, "shared", 128, 4, 16, 103424, 2, 8),
    (120, 65536, "int32", 16, 0, "shared", 128, 2, 16, 97280, 2, 8),
    (120, 65536, "int16", 17, 0, "shared", 128, 5, 16, 113408, 2, 8),
    (120, 65536, "int16", 18, 0, "shared", 128, 4, 16, 103424, 2, 8),
    (120, 262144, "int32", 16, 0, "shared", 128, 1, 16, 72704, 3, 12),
    (120, 262144, "int16", 17, 0, "shared", 128, 2, 16, 74240, 3, 12),
    (120, 262144, "int16", 18, 0, "shared", 128, 2, 16, 75776, 3, 12),
    (120, 1048576, "int32", 16, 0, "shared", 128, 1, 16, 72704, 3, 12),
    (120, 1048576, "int16", 17, 0, "shared", 128, 2, 16, 74240, 3, 12),
    (120, 1048576, "int16", 18, 0, "shared", 128, 2, 16, 75776, 3, 12),
    (152, 64, "int32", 16, 0, "shared", 32, 16, 16, 114432, 2, 2),
    (152, 64, "int16", 17, 0, "shared", 32, 16, 16, 68352, 3, 3),
    (152, 64, "int16", 18, 0, "shared", 32, 16, 16, 71424, 3, 3),
    (152, 256, "int32", 16, 0, "shared", 32, 16, 16, 114432, 2, 2),
    (152, 256, "int16", 17, 0, "shared", 32, 16, 16, 68352, 3, 3),
    (152, 256, "int16", 18, 0, "shared", 32, 16, 16, 71424, 3, 3),
    (152, 2045, "int32", 16, 0, "shared", 32, 16, 4, 114432, 2, 2),
    (152, 2045, "int16", 17, 0, "shared", 32, 16, 2, 68352, 3, 3),
    (152, 2045, "int16", 18, 0, "shared", 32, 16, 2, 71424, 3, 3),
    (152, 2046, "int32", 16, 0, "shared", 32, 16, 8, 114432, 2, 2),
    (152, 2046, "int16", 17, 0, "shared", 32, 16, 4, 68352, 3, 3),
    (152, 2046, "int16", 18, 0, "shared", 32, 16, 4, 71424, 3, 3),
    (152, 4096, "int32", 16, 0, "shared", 32, 16, 16, 114432, 2, 2),
    (152, 4096, "int16", 17, 0, "shared", 32, 16, 16, 68352, 3, 3),
    (152, 4096, "int16", 18, 0, "shared", 32, 16, 16, 71424, 3, 3),
    (152, 4224, "int32", 16, 0, "shared", 32, 16, 16, 114432, 2, 2),
    (152, 4224, "int16", 17, 0, "shared", 32, 16, 16, 68352, 3, 3),
    (152, 4224, "int16", 18, 0, "shared", 32, 16, 16, 71424, 3, 3),
    (152, 4352, "int32", 16, 0, "shared", 32, 16, 16, 114432, 2, 2),
    (152, 4352, "int16", 17, 0, "shared", 32, 16, 16, 68352, 3, 3),
    (152, 4352, "int16", 18, 0, "shared", 32, 16, 16, 71424, 3, 3),
    (152, 8192, "int32", 16, 0, "shared", 32, 16, 16, 114432, 2, 2),
    (152, 8192, "int16", 17, 0, "shared", 32, 16, 16, 68352, 3, 3),
    (152, 8192, "int16", 18, 0, "shared", 32, 16, 16, 71424, 3, 3),
    (152, 16384, "int32", 16, 0, "shared", 64, 6, 16, 105984, 2, 4),
    (152, 16384, "int16", 17, 0, "shared", 64, 12, 16, 110592, 2, 4),
    (152, 16384, "int16", 18, 0, "shared", 64, 12, 16, 115200, 2, 4),
    (152, 32768, "int32", 16, 0, "shared", 128, 2, 16, 113664, 2, 8),
    (152, 32768, "int16", 17, 0, "shared", 128, 3, 16, 103680, 2, 8),
    (152, 32768, "int16", 18, 0, "shared", 128, 3, 16, 105984, 2, 8),
    (152, 65536, "int32", 16, 0, "shared", 128, 2, 16, 113664, 2, 8),
    (152, 65536, "int16", 17, 0, "shared", 128, 3, 16, 103680, 2, 8),
    (152, 65536, "int16", 18, 0, "shared", 128, 3, 16, 105984, 2, 8),
    (152, 262144, "int32", 16, 0, "shared", 128, 2, 16, 113664, 2, 8),
    (152, 262144, "int16", 17, 0, "shared", 128, 3, 16, 103680, 2, 8),
    (152, 262144, "int16", 18, 0, "shared", 128, 3, 16, 105984, 2, 8),
    (152, 1048576, "int32", 16, 0, "shared", 128, 2, 16, 113664, 2, 8),
    (152, 1048576, "int16", 17, 0, "shared", 128, 3, 16, 103680, 2, 8),
    (152, 1048576, "int16", 18, 0, "shared", 128, 3, 16, 105984, 2, 8),
    (944, 64, "int32", 16, 0, "shared", 32, 16, 16, 215808, 1, 1),
    (944, 64, "int16", 17, 0, "shared", 32, 16, 16, 169728, 1, 1),
    (944, 64, "int16", 18, 0, "shared", 32, 16, 16, 172800, 1, 1),
    (944, 256, "int32", 16, 0, "shared", 32, 16, 16, 215808, 1, 1),
    (944, 256, "int16", 17, 0, "shared", 32, 16, 16, 169728, 1, 1),
    (944, 256, "int16", 18, 0, "shared", 32, 16, 16, 172800, 1, 1),
    (944, 2045, "int32", 16, 0, "shared", 32, 16, 4, 215808, 1, 1),
    (944, 2045, "int16", 17, 0, "shared", 32, 16, 2, 169728, 1, 1),
    (944, 2045, "int16", 18, 0, "shared", 32, 16, 2, 172800, 1, 1),
    (944, 2046, "int32", 16, 0, "shared", 32, 16, 8, 215808, 1, 1),
    (944, 2046, "int16", 17, 0, "shared", 32, 16, 4, 169728, 1, 1),
    (944, 2046, "int16", 18, 0, "shared", 32, 16, 4, 172800, 1, 1),
    (944, 4096, "int32", 16, 0, "shared", 32, 16, 16, 215808, 1, 1),
    (944, 4096, "int16", 17, 0, "shared", 32, 16, 16, 169728, 1, 1),
    (944, 4096, "int16", 18, 0, "shared", 32, 16, 16, 172800, 1, 1),
    (944, 4224, "int32", 16, 0, "shared", 32, 16, 16, 215808, 1, 1),
    (944, 4224, "int16", 17, 0, "shared", 32, 16, 16, 169728, 1, 1),
    (944, 4224, "int16", 18, 0, "shared", 32, 16, 16, 172800, 1, 1),
    (944, 4352, "int32", 16, 0, "wide", 128, 9, 16, 229376, 1, 4),
    (944, 4352, "int16", 17, 0, "wide", 128, 16, 16, 217088, 1, 4),
    (944, 4352, "int16", 18, 0, "wide", 128, 16, 16, 229376, 1, 4),
    (944, 8192, "int32", 16, 0, "wide", 128, 9, 16, 229376, 1, 4),
    (944, 8192, "int16", 17, 0, "wide", 128, 16, 16, 217088, 1, 4),
    (944, 8192, "int16", 18, 0, "wide", 128, 16, 16, 229376, 1, 4),
    (944, 16384, "int32", 16, 0, "wide", 128, 9, 16, 229376, 1, 4),
    (944, 16384, "int16", 17, 0, "wide", 128, 16, 16, 217088, 1, 4),
    (944, 16384, "int16", 18, 0, "wide", 128, 16, 16, 229376, 1, 4),
    (944, 32768, "int32", 16, 0, "wide", 128, 9, 16, 229376, 1, 4),
    (944, 32768, "int16", 17, 0, "wide", 128, 16, 16, 217088, 1, 4),
    (944, 32768, "int16", 18, 0, "wide", 128, 16, 16, 229376, 1, 4),
    (944, 65536, "int32", 16, 0, "wide", 128, 9, 16, 229376, 1, 4),
    (944, 65536, "int16", 17, 0, "wide", 128, 16, 16, 217088, 1, 4),
    (944, 65536, "int16", 18, 0, "wide", 128, 16, 16, 229376, 1, 4),
    (944, 262144, "int32", 16, 0, "wide", 128, 9, 16, 229376, 1, 4),
    (944, 262144, "int16", 17, 0, "wide", 128, 16, 16, 217088, 1, 4),
    (944, 262144, "int16", 18, 0, "wide", 128, 16, 16, 229376, 1, 4),
    (944, 1048576, "int32", 16, 0, "wide", 128, 9, 16, 229376, 1, 4),
    (944, 1048576, "int16", 17, 0, "wide", 128, 16, 16, 217088, 1, 4),
    (944, 1048576, "int16", 18, 0, "wide", 128, 16, 16, 229376, 1, 4),
    (152, 4096, "int32", 16, 4, "shared", 32, 16, 4, 114432, 2, 2),
    (152, 4096, "int32", 16, 8, "shared", 32, 16, 8, 114432, 2, 2),
    (152, 4096, "int16", 17, 2, "shared", 32, 16, 2, 68352, 3, 3),
    (152, 4096, "int16", 17, 4, "shared", 32, 16, 4, 68352, 3, 3),
    (944, 32768, "int32", 16, 4, "wide", 128, 9, 4, 229376, 1, 4),
    (944, 32768, "int32", 16, 8, "wide", 128, 9, 8, 229376, 1, 4),
    (944, 32768, "int16", 17, 2, "wide", 128, 16, 2, 217088, 1, 4),
    (944, 32768, "int16", 17, 4, "wide", 128, 16, 4, 217088, 1, 4),
    (152, 262144, "int32", 16, 4, "shared", 128, 2, 4, 113664, 2, 8),
    (152, 262144, "int32", 16, 8, "shared", 128, 2, 8, 113664, 2, 8),
    (152, 262144, "int16", 17, 2, "shared", 128, 3, 2, 103680, 2, 8),
    (152, 262144, "int16", 17, 4, "shared", 128, 3, 4, 103680, 2, 8),
]


def _events_at(batch, dtype, fields, offset, t=1):
    """[t, fields, batch] events with no storage of their own, whose base
    address is ``offset`` modulo 16: the plan reads only their shape,
    dtype, device and address."""
    buf = torch.zeros(16, dtype=dtype)
    assert buf.data_ptr() % 16 == 0
    return buf[offset // buf.element_size()].expand(t, fields, batch)


@pytest.mark.parametrize(
    "r_pad,batch,dtype,fields,offset,route,lanes,ksteps,vec,smem,blocks,"
    "warps", FROZEN_PLANS,
    ids=[f"{r}x{b}-{dt}-P{p}-at{o}" for r, b, dt, p, o, *_ in FROZEN_PLANS])
def test_kernel_plan_matches_the_frozen_table(
        r_pad, batch, dtype, fields, offset, route, lanes, ksteps, vec,
        smem, blocks, warps):
    """The plan, off the card an H100's, gives every key of the recorded
    one: wide tables at more lanes than one warp an SM can hold take the
    wide route, narrow tables and wide tables at few lanes the shared
    one, at ``lanes_per_block``'s lanes."""
    caps = PLAN_CAPS[r_pad]
    assert RC.RowMap(caps).rows_padded == r_pad
    ev = _events_at(batch, getattr(torch, dtype), fields, offset)
    assert RC.kernel_plan(ev, caps) == dict(
        lanes_per_block=lanes, steps_per_stage=ksteps, request_bytes=vec,
        smem_bytes=smem, blocks_per_sm=blocks, route=route,
        warps_per_sm=warps)
    assert RC.replay_route(r_pad, batch) == route
    if route == "shared":
        assert RC.lanes_per_block(r_pad, batch) == lanes


@pytest.mark.parametrize("caps,batch,route", ROUTE_CASES,
                         ids=[f"{RC.RowMap(c).rows_padded}x{b}"
                              for c, b, _ in ROUTE_CASES])
def test_kernel_params_carry_the_route(caps, batch, route):
    """The parameter block has the kernel's N_PARAMS entries and carries
    the plan (route, lanes, ring depth, request width, shared bytes) where
    the kernel's Params has it; the ring's stages and depth bound and the
    warp width are the kernel's."""
    src = (Path(__file__).resolve().parents[1]
           / "cadence_tpu_torch/ops/csrc/replay_fsm.cu").read_text()
    body = src[src.index("struct Params {"):]
    body = re.sub(r"//[^\n]*", "", body[body.index("{") + 1:body.index("};")])
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl.startswith("int "):
            continue
        for name in decl[4:].split(","):
            name = name.strip()
            if name.endswith("[EV_N]"):
                names += [name[:-6]] * S.EV_N
            else:
                names.append(name)
    assert len(names) == RC._N_PARAMS
    assert names.index("route") == RC._ROUTE_PARAM
    for name, value in (("STAGES", RC._RING_STAGES),
                        ("MAX_KSTEPS", RC._MAX_KSTEPS),
                        ("WARP", _build.WARP)):
        assert f"constexpr int {name} = {value};" in src, name
    rm = RC.RowMap(caps)
    ev = _events_at(batch, torch.int32, S.EV_N, 0, t=4)
    hp = RC._kernel_params(ev, rm, 0, 4, None, ())
    assert hp.dtype == np.int32 and len(hp) == RC._N_PARAMS
    plan = RC.kernel_plan(ev, caps)
    assert RC.ROUTES[hp[RC._ROUTE_PARAM]] == plan["route"] == route
    for name, key in (("lanes", "lanes_per_block"),
                      ("ksteps", "steps_per_stage"),
                      ("vec", "request_bytes"), ("smem", "smem_bytes")):
        assert hp[names.index(name)] == plan[key], name
    assert hp[names.index("B")] == batch
