"""Per-shard queue processors: transfer and timer, active and standby.

A copy of the queue machinery of the reference package's
``runtime/queues`` (Cadence service/history/queueProcessor.go,
queueAckMgr.go, taskProcessor.go, timerQueueProcessorBase.go,
timerGate.go, transferQueueActiveProcessor.go,
timerQueueActiveProcessor.go, transferQueueStandbyProcessor.go,
timerQueueStandbyProcessor.go): host-side pull pipelines that order, ack
and retry the work items the history engine persists, the standby
variants that verify a passive domain's tasks against replicated state,
and the queue GC. The shared parallel executor waits for a later slice of
the port.
"""

from .ack import QueueAckManager
from .base import QueueProcessorBase
from .effects import Footprint, TASK_FOOTPRINTS, build_conflict_matrix
from .standby import (
    QueueGC,
    TimerQueueStandbyProcessor,
    TransferQueueStandbyProcessor,
)
from .timer import TimerQueueProcessor
from .timer_gate import LocalTimerGate, RemoteTimerGate
from .transfer import TransferQueueProcessor

__all__ = [
    "Footprint",
    "QueueAckManager",
    "QueueGC",
    "QueueProcessorBase",
    "TASK_FOOTPRINTS",
    "build_conflict_matrix",
    "TimerQueueProcessor",
    "TimerQueueStandbyProcessor",
    "LocalTimerGate",
    "RemoteTimerGate",
    "TransferQueueProcessor",
    "TransferQueueStandbyProcessor",
]
