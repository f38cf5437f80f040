"""History engine: the workflow-mutation core.

Reference: service/history/historyEngine.go + decisionHandler.go +
workflowExecutionContext.go + historyCache.go. Every mutation follows
the same discipline: acquire the per-workflow lock, load mutable state,
build an ActiveTransaction, persist events + state + queue tasks under
the shard's range_id and the load-time next_event_id condition, retrying
the whole body on ConditionFailedError (the Update_History_Loop).

A copy of the reference package's ``runtime/engine/__init__.py``.
"""

from .engine import HistoryEngine
