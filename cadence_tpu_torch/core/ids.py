"""Sentinel IDs/versions shared across the FSM, host runtime, and kernels.

Mirrors the reference's common/constants.go:28-41 sentinels so that replay
semantics (e.g. "no pending decision" == DecisionScheduleID ==
EMPTY_EVENT_ID) are identical.
"""

from __future__ import annotations

# First event in any history.
FIRST_EVENT_ID = 1
# "no event" sentinel.
EMPTY_EVENT_ID = -23
# Event held in the buffered-events list, not yet assigned a real ID.
BUFFERED_EVENT_ID = -123
# Transient (not-yet-persisted) decision/activity started event.
TRANSIENT_EVENT_ID = -124
# Uninitialized per-event task ID.
EMPTY_EVENT_TASK_ID = -1234
# "no version" sentinel (local domains / uninitialized).
EMPTY_VERSION = -24

EMPTY_UUID = "emptyUuid"

# Versions for cross-cluster failover arithmetic
# (reference: common/cluster/metadata.go — version % increment selects cluster).
DEFAULT_FAILOVER_VERSION_INCREMENT = 10
