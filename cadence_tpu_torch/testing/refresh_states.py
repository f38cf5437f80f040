"""State tables that reach the task refresh's tie and overflow rules.

Numpy ``StateTensors`` (``ops/schema.py``) built from small value sets, so
that expiries tie across slots and candidate kinds, ids repeat, timeouts
are 0 or negative, ``ts + timeout`` wraps int32 and expiries land exactly
on 2**31 - 1. The CPU tests hold ``ops/refresh.py``'s plain version
against the reference package on them, and ``chip_smoke.py`` holds the
refresh kernel against the plain version on the same states on the card.
"""

from __future__ import annotations

import numpy as np

from ..core.ids import EMPTY_EVENT_ID
from ..ops import schema as S

BIG = 2**31 - 1

# caps the states are drawn at besides the benchmark's: small tables (the
# crafted states' own), the edges of the kernel's thread groups (one slot
# a table; odd widths that leave a group's threads idle), and an activity
# table whose slabs need more than the 48 KB a block gets without opting
# in (refresh_plan: one lane a block, 77 KB)
SMALL_CAPS = S.Capacities(
    max_events=256, max_activities=4, max_timers=3, max_children=2,
    max_request_cancels=2, max_signals_ext=2, max_version_items=3)
EDGE_CAPS = {
    "one-slot": S.Capacities(
        max_events=64, max_activities=1, max_timers=1, max_children=1,
        max_request_cancels=1, max_signals_ext=1, max_version_items=1),
    "odd": S.Capacities(
        max_events=64, max_activities=5, max_timers=3, max_children=7,
        max_request_cancels=1, max_signals_ext=2, max_version_items=2),
}
HUGE_CAPS = S.Capacities(max_activities=1000)


def _picker(rng):
    def pick(values, shape):
        return rng.choice(np.asarray(values, np.int64), size=shape).astype(
            np.int32)
    return pick


def crafted_state(seed: int, b: int, caps: S.Capacities) -> S.StateTensors:
    """``b`` lanes of state drawn from small value sets: expiries tie
    across slots and candidate kinds, schedule ids repeat, timeouts are 0
    or negative, ``ts + timeout`` wraps int32 and expiries land exactly
    on 2**31 - 1."""
    rng = np.random.default_rng(seed)
    pick = _picker(rng)
    st = S.empty_state(b, caps)
    ex = st.exec_info

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


def edge_state(seed: int, b: int, caps: S.Capacities) -> S.StateTensors:
    """``crafted_state`` pushed to the rules' edges: schedule and started
    ids of 2**31 - 1 (where the least id is that, every slot counts as a
    tied winner), negative attempts and versions (where every slot wins,
    attempt takes no 0 from a losing slot), most slots occupied and armed
    with few distinct expiries, and every column of the unused slots set
    too."""
    rng = np.random.default_rng(seed)
    pick = _picker(rng)
    st = crafted_state(seed, b, caps)
    a = st.activities
    shape = a.shape[:2]
    a[:, :, S.AC_OCC] = pick([0, 1, 1, 1, 1, 1], shape)
    a[:, :, S.AC_SCHEDULE_ID] = pick([4, BIG, BIG, -3], shape)
    a[:, :, S.AC_STARTED_ID] = pick([EMPTY_EVENT_ID, 5], shape)
    a[:, :, S.AC_SCHEDULED_TS] = pick([1, BIG - 1], shape)
    a[:, :, S.AC_STARTED_TS] = pick([0, 1], shape)
    a[:, :, S.AC_LAST_HB_TS] = pick([0, 1], shape)
    for col in (S.AC_SCH_TO_START, S.AC_SCH_TO_CLOSE,
                S.AC_START_TO_CLOSE, S.AC_HEARTBEAT):
        a[:, :, col] = pick([0, 1, 1, 2], shape)
    a[:, :, S.AC_ATTEMPT] = pick([-5, -1, -1, 0, 2], shape)
    a[:, :, S.AC_VERSION] = pick([-(2**31), -24, -2, 3], shape)
    t = st.timers
    shape = t.shape[:2]
    t[:, :, S.TI_OCC] = pick([0, 1, 1, 1], shape)
    t[:, :, S.TI_EXPIRY_TS] = pick([5, 5, BIG], shape)
    t[:, :, S.TI_STARTED_ID] = pick([BIG, BIG, 3], shape)
    t[:, :, S.TI_VERSION] = pick([-(2**31), -7, 4], shape)
    return st


def one_row(caps: S.Capacities, **acts) -> S.StateTensors:
    """A running workflow with activity slots set column by column."""
    st = S.empty_state(1, caps)
    st.exec_info[0, S.X_STATE] = 1
    for col, values in acts.items():
        st.activities[0, :len(values), getattr(S, col)] = values
    return st


def full_tie_state(caps: S.Capacities) -> S.StateTensors:
    """Two slots with one schedule id and one expiry, one unstarted and
    one started, both armed by schedule-to-close: the unstarted kind
    comes first in the reference's order, so its slot's attempt and
    version win (activity timer [15, 2, 4, 1, 2])."""
    return one_row(
        caps, AC_OCC=[1, 1], AC_SCHEDULE_ID=[4, 4],
        AC_STARTED_ID=[EMPTY_EVENT_ID, 6], AC_SCHEDULED_TS=[10, 10],
        AC_SCH_TO_CLOSE=[5, 5], AC_ATTEMPT=[1, 3], AC_VERSION=[2, 9])


def int32_max_state(caps: S.Capacities, timeout: int) -> S.StateTensors:
    """One armed schedule-to-start candidate scheduled at 2**31 - 6: a
    ``timeout`` of 5 expires exactly at 2**31 - 1 (no task), 6 wraps
    negative and wins."""
    return one_row(caps, AC_OCC=[1], AC_SCHEDULE_ID=[4],
                   AC_STARTED_ID=[EMPTY_EVENT_ID],
                   AC_SCHEDULED_TS=[BIG - 5], AC_SCH_TO_START=[timeout])
