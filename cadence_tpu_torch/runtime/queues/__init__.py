"""Per-shard queue processors: transfer and timer.

A copy of the active queue machinery of the reference package's
``runtime/queues`` (Cadence service/history/queueProcessor.go,
queueAckMgr.go, taskProcessor.go, timerQueueProcessorBase.go,
timerGate.go, transferQueueActiveProcessor.go,
timerQueueActiveProcessor.go): host-side pull pipelines that order, ack
and retry the work items the history engine persists. The standby
processors, the queue GC and the shared parallel executor wait for later
slices of the port.
"""

from .ack import QueueAckManager
from .base import QueueProcessorBase
from .effects import Footprint, TASK_FOOTPRINTS, build_conflict_matrix
from .timer import TimerQueueProcessor
from .timer_gate import LocalTimerGate
from .transfer import TransferQueueProcessor

__all__ = [
    "Footprint",
    "QueueAckManager",
    "QueueProcessorBase",
    "TASK_FOOTPRINTS",
    "build_conflict_matrix",
    "TimerQueueProcessor",
    "LocalTimerGate",
    "TransferQueueProcessor",
]
