"""The port's device task refresh (``cadence_tpu_torch.ops.refresh``)
against the reference package's, on the CPU.

The same state arrays go through the reference's jitted
``refresh_tasks_device`` and the port's torch version; all twelve fields
must agree exactly, dtypes included. States come from fuzzed replays
and from crafted tables that hit the tie and overflow rules (equal
expiries across slots and candidate kinds, duplicate schedule ids,
timeouts of 0, ``ts + timeout`` wrapping int32, an expiry of exactly
2**31 - 1). ``hydrate_tasks`` is held against the reference's and
against the port's host ``refresh_tasks``; the replay + refresh step
against the reference's ``replay_scan`` + ``refresh_tasks_device``."""

import dataclasses
import itertools
import random
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_tpu.ops import pack as JP
from cadence_tpu.ops import refresh as JR
from cadence_tpu.ops import schema as JS
from cadence_tpu.ops.replay import replay_packed as j_replay_packed
from cadence_tpu.ops.replay import replay_scan as j_replay_scan

from cadence_tpu_torch.core import version_history as VH
from cadence_tpu_torch.core.enums import TimerTaskType
from cadence_tpu_torch.core.events import HistoryEvent
from cadence_tpu_torch.core.ids import EMPTY_EVENT_ID
from cadence_tpu_torch.core.mutable_state import MutableState
from cadence_tpu_torch.core.state_builder import StateBuilder
from cadence_tpu_torch.core.task_refresher import refresh_tasks
from cadence_tpu_torch.ops import pack as P
from cadence_tpu_torch.ops import replay_cuda as RC
from cadence_tpu_torch.ops import schema as S
from cadence_tpu_torch.ops.refresh import (
    FIELDS, RefreshedTasks, hydrate_tasks, refresh_tasks_device,
    refreshed_to_numpy,
)
from cadence_tpu_torch.ops.replay import replay_packed
from cadence_tpu_torch.testing import workloads as W
from cadence_tpu_torch.testing.event_generator import HistoryFuzzer

from test_replay_differential import ALL_SCENARIOS

RETRY_CAPS = S.Capacities(
    max_events=1024, max_activities=4, max_timers=2, max_children=2,
    max_request_cancels=2, max_signals_ext=2, max_version_items=2)
SMALL_CAPS = S.Capacities(
    max_events=256, max_activities=4, max_timers=3, max_children=2,
    max_request_cancels=2, max_signals_ext=2, max_version_items=3)
BOOL_FIELDS = ("close_transfer", "first_decision_pending")
BIG = 2**31 - 1


def j_refresh(state) -> JR.RefreshedTasks:
    """The reference's refresh of numpy state, as numpy."""
    fields = {f: np.asarray(getattr(state, f)) for f in S.STATE_ROW_FIELDS}
    return JR.refreshed_to_numpy(
        JR.refresh_tasks_device_jit(JS.StateTensors(**fields)))


def assert_refreshed_equal(got: RefreshedTasks, want) -> None:
    """Every field equal, with the pinned dtypes: bool for the two flags,
    int32 for the rest."""
    for f in FIELDS:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert isinstance(g, torch.Tensor), f
        pinned = torch.bool if f in BOOL_FIELDS else torch.int32
        assert g.dtype == pinned, (f, g.dtype)
        assert w.dtype == (np.bool_ if f in BOOL_FIELDS else np.int32), f
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)


def fuzzed_final(seed, caps, n=6, target=120):
    fz = HistoryFuzzer(seed=seed, caps=caps)
    hs = [(f"wf-{i}", f"run-{i}",
           fz.generate(target_events=target + 20 * i, close=i % 3 == 0))
          for i in range(n)]
    pk = P.pack_histories(hs, caps=caps)
    return pk, replay_packed(pk, device="cpu")


@pytest.mark.parametrize("seed,caps", [
    (1, None), (2, None), (3, SMALL_CAPS), (4, RETRY_CAPS), (5, RETRY_CAPS),
], ids=["default-1", "default-2", "small-3", "retry-4", "retry-5"])
def test_refresh_matches_reference_on_fuzzed_finals(seed, caps):
    pk, final = fuzzed_final(seed, caps or S.Capacities())
    got = refresh_tasks_device(S.state_from_numpy(final, "cpu"))
    assert_refreshed_equal(got, j_refresh(final))
    # the fuzzed finals arm tasks: the comparison is not all -1s
    assert (got.activity_timer[:, 0] >= 0).any() or \
        (got.decision_transfer >= 0).any()


def crafted_state(seed: int, b: int, caps: S.Capacities) -> S.StateTensors:
    """State tables drawn from small value sets, so that expiries tie
    across slots and candidate kinds, schedule ids repeat, timeouts are 0
    or negative, ``ts + timeout`` wraps int32 and expiries land exactly
    on 2**31 - 1."""
    rng = np.random.default_rng(seed)
    st = S.empty_state(b, caps)
    ex = st.exec_info

    def pick(values, shape):
        return rng.choice(np.asarray(values, np.int64), size=shape).astype(
            np.int32)

    ex[:, S.X_STATE] = pick([0, 1, 1, 1, 2, 3], b)
    ex[:, S.X_START_TS] = pick([1, 7, BIG - 20, -5], b)
    ex[:, S.X_WORKFLOW_TIMEOUT] = pick([0, 19, 21, 100], b)
    ex[:, S.X_DEC_SCHEDULE_ID] = pick([EMPTY_EVENT_ID, 3, 9], b)
    ex[:, S.X_DEC_STARTED_ID] = pick([EMPTY_EVENT_ID, 0, 4], b)
    ex[:, S.X_DEC_STARTED_TS] = pick([0, 5, BIG - 2], b)
    ex[:, S.X_DEC_TIMEOUT] = pick([0, 2, 10], b)
    ex[:, S.X_DEC_ATTEMPT] = pick([0, 1, 7], b)
    ex[:, S.X_LAST_PROCESSED_EVENT] = pick([EMPTY_EVENT_ID, 0, 1, 6], b)

    a = st.activities
    shape = a.shape[:2]
    a[:, :, S.AC_OCC] = pick([0, 1, 1], shape)
    a[:, :, S.AC_SCHEDULE_ID] = pick([3, 4, 4, 8], shape)
    a[:, :, S.AC_STARTED_ID] = pick([EMPTY_EVENT_ID, 5, 6], shape)
    a[:, :, S.AC_SCHEDULED_TS] = pick([1, 2, BIG - 20], shape)
    a[:, :, S.AC_STARTED_TS] = pick([0, 1, 2, BIG - 20], shape)
    a[:, :, S.AC_LAST_HB_TS] = pick([0, 2, 3], shape)
    for col in (S.AC_SCH_TO_START, S.AC_SCH_TO_CLOSE,
                S.AC_START_TO_CLOSE, S.AC_HEARTBEAT):
        a[:, :, col] = pick([0, 0, 1, 2, 19, 21, -1], shape)
    a[:, :, S.AC_ATTEMPT] = pick([0, 1, 2, 3], shape)
    a[:, :, S.AC_VERSION] = pick([-24, 1, 2, 5], shape)

    t = st.timers
    shape = t.shape[:2]
    t[:, :, S.TI_OCC] = pick([0, 1, 1], shape)
    t[:, :, S.TI_EXPIRY_TS] = pick([5, 5, BIG, -7, 9], shape)
    t[:, :, S.TI_STARTED_ID] = pick([3, 3, 9], shape)
    t[:, :, S.TI_VERSION] = pick([-24, 1, 4], shape)

    for table, occ, init, started in (
            (st.children, S.CH_OCC, S.CH_INITIATED_ID, S.CH_STARTED_ID),
            (st.cancels, S.RC_OCC, S.RC_INITIATED_ID, None),
            (st.signals, S.SG_OCC, S.SG_INITIATED_ID, None)):
        shape = table.shape[:2]
        table[:, :, occ] = pick([0, 1], shape)
        table[:, :, init] = pick([11, 12, 40], shape)
        if started is not None:
            table[:, :, started] = pick([EMPTY_EVENT_ID, 13], shape)
    return st


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_refresh_matches_reference_on_crafted_ties_and_overflow(seed):
    caps = SMALL_CAPS if seed % 2 else RETRY_CAPS
    st = crafted_state(seed, 512, caps)
    got = refresh_tasks_device(S.state_from_numpy(st, "cpu"))
    assert_refreshed_equal(got, j_refresh(st))
    # the draw reaches the rules it is for
    timer = got.activity_timer.numpy()
    assert (timer[:, 0] >= 0).any() and (timer[:, 0] == -1).any()
    assert (timer[:, 0] < 0).sum() > (timer[:, 1] < 0).sum(), \
        "a wrapped (negative) expiry wins somewhere"
    assert len(np.unique(timer[timer[:, 0] >= 0, 1])) == 4, \
        "every timeout type wins somewhere"


def _one_row(caps, **acts):
    """A running workflow with activity slots set column by column."""
    st = S.empty_state(1, caps)
    st.exec_info[0, S.X_STATE] = 1
    for col, values in acts.items():
        st.activities[0, :len(values), getattr(S, col)] = values
    return st


def test_full_tie_takes_the_earlier_kind_and_its_winners():
    """Two slots with one schedule id and one expiry, one unstarted and
    one started, both armed by schedule-to-close: the unstarted kind
    comes first in the reference's order, so its slot's attempt and
    version win, not the max over both slots."""
    caps = SMALL_CAPS
    st = _one_row(
        caps, AC_OCC=[1, 1], AC_SCHEDULE_ID=[4, 4],
        AC_STARTED_ID=[EMPTY_EVENT_ID, 6], AC_SCHEDULED_TS=[10, 10],
        AC_SCH_TO_CLOSE=[5, 5], AC_ATTEMPT=[1, 3], AC_VERSION=[2, 9])
    got = refresh_tasks_device(S.state_from_numpy(st, "cpu"))
    assert_refreshed_equal(got, j_refresh(st))
    assert got.activity_timer[0].tolist() == [15, 2, 4, 1, 2]


def test_expiry_of_int32_max_reads_as_absent():
    """An armed candidate whose expiry is exactly 2**31 - 1 is no task,
    in both packages; one past it wraps negative and wins."""
    caps = SMALL_CAPS
    st = _one_row(caps, AC_OCC=[1], AC_SCHEDULE_ID=[4],
                  AC_STARTED_ID=[EMPTY_EVENT_ID], AC_SCHEDULED_TS=[BIG - 5],
                  AC_SCH_TO_START=[5])
    got = refresh_tasks_device(S.state_from_numpy(st, "cpu"))
    assert_refreshed_equal(got, j_refresh(st))
    assert got.activity_timer[0].tolist() == [-1] * 5
    st.activities[0, 0, S.AC_SCH_TO_START] = 6
    got = refresh_tasks_device(S.state_from_numpy(st, "cpu"))
    assert_refreshed_equal(got, j_refresh(st))
    assert got.activity_timer[0].tolist() == [-(2**31), 1, 4, 0, 0]


def test_refresh_makes_no_host_synchronisation():
    """The pass runs on meta tensors, which hold no values: it reads no
    value on the host (no ``.item()``, no copy, no branch on a tensor)."""
    st = crafted_state(9, 64, RETRY_CAPS)
    meta = S.StateTensors(**{
        f: torch.empty(getattr(st, f).shape, dtype=torch.int32,
                       device="meta") for f in S.STATE_ROW_FIELDS})
    got = refresh_tasks_device(meta)
    cpu = refresh_tasks_device(S.state_from_numpy(st, "cpu"))
    for f in FIELDS:
        g, c = getattr(got, f), getattr(cpu, f)
        assert g.device.type == "meta"
        assert (g.shape, g.dtype) == (c.shape, c.dtype), f


def test_refresh_refuses_numpy_state():
    st = crafted_state(0, 4, SMALL_CAPS)
    with pytest.raises(TypeError, match="torch state"):
        refresh_tasks_device(st)


def test_refreshed_to_numpy_keeps_values_and_dtypes():
    st = crafted_state(5, 33, RETRY_CAPS)
    got = refresh_tasks_device(S.state_from_numpy(st, "cpu"))
    host = refreshed_to_numpy(got)
    for f in FIELDS:
        h, g = getattr(host, f), getattr(got, f)
        assert isinstance(h, np.ndarray) and h.shape == tuple(g.shape), f
        assert h.dtype == (np.bool_ if f in BOOL_FIELDS else np.int32), f
        np.testing.assert_array_equal(h, g.numpy(), err_msg=f)
    empty = refreshed_to_numpy(refresh_tasks_device(
        S.state_from_numpy(S.empty_state(0, RETRY_CAPS), "cpu")))
    assert empty.activity_timer.shape == (0, 5)


# -- hydration ---------------------------------------------------------------


def port_batches(batches):
    """The reference package's events as the port's, through to_dict."""
    return [[HistoryEvent.from_dict(e.to_dict()) for e in b]
            for b in batches]


def task_dicts(tasks):
    """Tasks field by field, enums as ints."""
    return [{k: int(v) if k == "task_type" else v
             for k, v in dataclasses.asdict(t).items()} for t in tasks]


def transfer_keys(tasks):
    return [(int(t.task_type), t.schedule_id, t.task_list, t.initiated_id)
            for t in tasks]


def timer_keys(tasks):
    return [(int(t.task_type), t.visibility_timestamp, t.timeout_type,
             t.event_id, t.schedule_attempt, t.version) for t in tasks]


def port_oracle(batches):
    ms = MutableState(domain_id="dom")
    ms.version_histories = VH.VersionHistories.new_empty()
    ids = itertools.count()
    StateBuilder(ms, id_generator=lambda: f"id-{next(ids)}").apply_batches(
        "dom", "req", "wf", "run", batches)
    return ms


@pytest.mark.parametrize("scenario", ALL_SCENARIOS, ids=lambda f: f.__name__)
def test_hydrate_matches_reference_and_host_refresher(scenario):
    batches = scenario()
    jpk = JP.pack_histories([("wf", "run", batches)])
    j_tr, j_ti = JR.hydrate_tasks(
        JR.refreshed_to_numpy(JR.refresh_tasks_device_jit(
            j_replay_packed(jpk))), 0, jpk, domain_id="dom")

    pb = port_batches(batches)
    pk = P.pack_histories([("wf", "run", pb)])
    final = replay_packed(pk, device="cpu")
    tr, ti = hydrate_tasks(refresh_tasks_device(
        S.state_from_numpy(final, "cpu")), 0, pk, domain_id="dom")
    assert task_dicts(tr) == task_dicts(j_tr)
    assert task_dicts(ti) == task_dicts(j_ti)

    h_tr, h_ti = refresh_tasks(port_oracle(pb))
    assert transfer_keys(tr) == transfer_keys(h_tr)
    assert timer_keys(ti) == timer_keys(h_ti)


def test_hydrate_backoff_and_targets_match_reference():
    """Crafted rows hydrated with side tables that carry a first-decision
    backoff deadline, task lists and external targets: the same records
    as the reference's ``hydrate_tasks`` on the same arrays."""
    caps = RETRY_CAPS
    st = crafted_state(11, 64, caps)
    epoch_s = 1_700_000_000
    sides, j_sides = [], []
    for b in range(64):
        kw = dict(
            task_list=f"tl-{b % 3}",
            first_decision_backoff_deadline=(
                0 if b % 4 == 0 else (epoch_s + 3 * (b % 5)) * 10**9),
            activity_task_lists={s: f"atl-{s}" for s in range(b % 3)},
            child_domains={0: "cdom"}, child_workflow_ids={0: f"c-{b}"},
            cancel_targets={0: ("", f"x-{b}", "r", bool(b % 2))},
            signal_targets={1: ("sdom", f"y-{b}", "", False)})
        sides.append(P.WorkflowSideTable(**kw))
        j_sides.append(JP.WorkflowSideTable(**kw))
    got = refreshed_to_numpy(
        refresh_tasks_device(S.state_from_numpy(st, "cpu")))
    want = j_refresh(st)
    pk = SimpleNamespace(epoch_s=epoch_s, side=sides)
    jpk = SimpleNamespace(epoch_s=epoch_s, side=j_sides)
    n_backoff = 0
    for b in range(64):
        tr, ti = hydrate_tasks(got, b, pk, domain_id="dom")
        j_tr, j_ti = JR.hydrate_tasks(want, b, jpk, domain_id="dom")
        assert task_dicts(tr) == task_dicts(j_tr), b
        assert task_dicts(ti) == task_dicts(j_ti), b
        n_backoff += sum(t.task_type == TimerTaskType.WorkflowBackoffTimer
                         for t in ti)
    assert n_backoff, "some row re-arms the backoff timer"


# -- the replay + refresh step ------------------------------------------------


def test_replay_and_refresh_step_matches_reference():
    """``replay_scan_teb`` then ``refresh_tasks_device`` on the CPU equal
    the reference's ``replay_scan`` then ``refresh_tasks_device`` on the
    same pack (bench.py's unpacked replay step)."""
    caps = S.Capacities(max_events=256, max_activities=4, max_timers=2,
                        max_children=2, max_request_cancels=2,
                        max_signals_ext=2, max_version_items=2)
    rng = random.Random(3)
    fz = HistoryFuzzer(seed=17, caps=caps)
    hs = [(f"r-{i}", f"run-{i}", W.retry_deep_history(rng, depth=200))
          for i in range(5)]
    hs += [(f"f-{i}", f"run-f{i}", fz.generate(target_events=150,
                                               close=i == 0))
           for i in range(3)]
    pk = P.pack_histories(hs, caps=caps)
    jcaps = JS.Capacities(**dataclasses.asdict(caps))
    jpk = JP.pack_histories(_reference_histories(hs), caps=jcaps)
    assert pk.events.tobytes() == jpk.events.tobytes()

    j_final = j_replay_scan(
        JS.empty_state(len(hs), jcaps), jnp.asarray(jpk.time_major()))
    want = JR.refreshed_to_numpy(JR.refresh_tasks_device_jit(j_final))

    final = RC.replay_scan_teb(
        S.state_from_numpy(S.empty_state(len(hs), caps), "cpu"),
        S.host_tensor(pk.teb()), caps)
    got = refresh_tasks_device(final)
    assert_refreshed_equal(got, want)
    for f in S.STATE_ROW_FIELDS:
        np.testing.assert_array_equal(getattr(final, f).numpy(),
                                      np.asarray(getattr(j_final, f)),
                                      err_msg=f)


def _reference_histories(hs):
    """The port's histories as the reference package's events."""
    from cadence_tpu.core.events import HistoryEvent as JHistoryEvent

    return [(w, r, [[JHistoryEvent.from_dict(e.to_dict()) for e in b]
                    for b in batches]) for w, r, batches in hs]
