"""TimerSequence: next-timer-task computation with creation dedup.

Twin of the reference's timerBuilder
(Cadence service/history/timerBuilder.go — GetUserTimerTaskIfNeeded /
GetActivityTimerTaskIfNeeded): the timer queue only needs a durable task for
the *earliest* pending expiry; per-entry status bits dedup task creation.

Deterministic ordering — (expiry, event_id, timeout_type) — is part of the
replay contract: the reference package's device refresh computes the
same argmin.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .enums import (
    TimeoutType,
    TimerTaskType,
    TIMER_TASK_STATUS_CREATED,
    TIMER_TASK_STATUS_CREATED_HEARTBEAT,
    TIMER_TASK_STATUS_CREATED_SCHEDULE_TO_CLOSE,
    TIMER_TASK_STATUS_CREATED_SCHEDULE_TO_START,
    TIMER_TASK_STATUS_CREATED_START_TO_CLOSE,
)
from .ids import EMPTY_EVENT_ID
from .mutable_state import MutableState, SECOND
from .tasks import TimerTask

_TIMEOUT_BIT = {
    TimeoutType.StartToClose: TIMER_TASK_STATUS_CREATED_START_TO_CLOSE,
    TimeoutType.ScheduleToStart: TIMER_TASK_STATUS_CREATED_SCHEDULE_TO_START,
    TimeoutType.ScheduleToClose: TIMER_TASK_STATUS_CREATED_SCHEDULE_TO_CLOSE,
    TimeoutType.Heartbeat: TIMER_TASK_STATUS_CREATED_HEARTBEAT,
}


class TimerSequence:
    def __init__(self, ms: MutableState) -> None:
        self.ms = ms

    # -- user timers ----------------------------------------------------

    def user_timer_task_if_needed(self) -> Optional[TimerTask]:
        """Durable task for the earliest pending user timer, once."""
        timers = sorted(
            self.ms.pending_timers.values(),
            key=lambda ti: (ti.expiry_time, ti.started_id),
        )
        if not timers:
            return None
        ti = timers[0]
        if ti.task_status & TIMER_TASK_STATUS_CREATED:
            return None
        ti.task_status |= TIMER_TASK_STATUS_CREATED
        return TimerTask(
            task_type=TimerTaskType.UserTimer,
            visibility_timestamp=ti.expiry_time,
            event_id=ti.started_id,
            version=ti.version,
        )

    # -- activity timeouts ----------------------------------------------

    def _activity_timeout_candidates(self) -> List[Tuple[int, int, int, object]]:
        """(expiry, schedule_id, timeout_type, activity) for every armed timeout."""
        out = []
        for ai in self.ms.pending_activities.values():
            if ai.started_id == EMPTY_EVENT_ID:
                if ai.schedule_to_start_timeout > 0:
                    out.append((
                        ai.scheduled_time + ai.schedule_to_start_timeout * SECOND,
                        ai.schedule_id, int(TimeoutType.ScheduleToStart), ai,
                    ))
                if ai.schedule_to_close_timeout > 0:
                    out.append((
                        ai.scheduled_time + ai.schedule_to_close_timeout * SECOND,
                        ai.schedule_id, int(TimeoutType.ScheduleToClose), ai,
                    ))
            else:
                if ai.start_to_close_timeout > 0:
                    out.append((
                        ai.started_time + ai.start_to_close_timeout * SECOND,
                        ai.schedule_id, int(TimeoutType.StartToClose), ai,
                    ))
                if ai.heartbeat_timeout > 0:
                    out.append((
                        ai.last_heartbeat_updated_time + ai.heartbeat_timeout * SECOND,
                        ai.schedule_id, int(TimeoutType.Heartbeat), ai,
                    ))
                if ai.schedule_to_close_timeout > 0:
                    out.append((
                        ai.scheduled_time + ai.schedule_to_close_timeout * SECOND,
                        ai.schedule_id, int(TimeoutType.ScheduleToClose), ai,
                    ))
        return sorted(out, key=lambda c: (c[0], c[1], c[2]))

    def activity_timer_task_if_needed(self) -> Optional[TimerTask]:
        """Durable task for the earliest armed activity timeout, once."""
        candidates = self._activity_timeout_candidates()
        if not candidates:
            return None
        expiry, schedule_id, timeout_type, ai = candidates[0]
        bit = _TIMEOUT_BIT[TimeoutType(timeout_type)]
        if ai.timer_task_status & bit:
            return None
        ai.timer_task_status |= bit
        return TimerTask(
            task_type=TimerTaskType.ActivityTimeout,
            visibility_timestamp=expiry,
            timeout_type=timeout_type,
            event_id=schedule_id,
            schedule_attempt=ai.attempt,
            version=ai.version,
        )
