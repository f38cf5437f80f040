"""Matching service: task-list queues with synchronous rendezvous dispatch.

TPU-native rebuild of the reference matching service
(Cadence service/matching/): the host-side control plane that
rendezvouses task producers (history transfer queue) with task consumers
(worker pollers). There is no tensor analog — this stays a host
subsystem, designed around Python threading primitives instead of Go
channels.

A copy of the reference package's ``matching/__init__.py``.
"""

from .engine import MatchingEngine, PollRequest
from .matcher import TaskMatcher
from .task_list import InternalTask, TaskListID, TaskListManager

__all__ = [
    "MatchingEngine",
    "PollRequest",
    "TaskMatcher",
    "InternalTask",
    "TaskListID",
    "TaskListManager",
]
