"""Retention-driven workflow deletion, shared by the active and standby
timer pipelines (ref timerQueueProcessorBase.go deleteHistoryEvent —
retention runs on every cluster).

A copy of the reference package's ``runtime/queues/retention.py``.
"""

from __future__ import annotations


def delete_workflow_retention(shard, engine, task) -> None:
    """Remove visibility, mutable state, and the history branch of a
    retention-expired run; idempotent (a second call finds nothing)."""
    ex = shard.persistence.execution
    vis = shard.persistence.visibility
    hist = shard.persistence.history
    try:
        record = ex.get_workflow_execution(
            shard.shard_id, task.domain_id, task.workflow_id, task.run_id,
        )
    except Exception:
        return  # already gone
    if vis is not None:
        try:
            vis.delete_workflow_execution(
                task.domain_id, task.workflow_id, task.run_id
            )
        except Exception:
            pass
    branch = record.snapshot.get("execution_info", {}).get("branch_token", b"")
    ex.delete_current_workflow_execution(
        shard.shard_id, task.domain_id, task.workflow_id, task.run_id
    )
    ex.delete_workflow_execution(
        shard.shard_id, task.domain_id, task.workflow_id, task.run_id
    )
    if branch and hist is not None:
        from ...runtime.persistence.records import BranchToken
        from ...utils.log import get_logger

        if isinstance(branch, bytes):
            branch = branch.decode()
        try:
            hist.delete_history_branch(BranchToken.from_json(branch))
        except Exception:
            # the execution record is already gone, so this branch will
            # never be retried — make the leak visible instead of
            # silently recreating the swallowed-error bug
            get_logger("cadence_tpu_torch.retention").exception(
                f"history branch delete failed for {task.workflow_id}/"
                f"{task.run_id}; branch leaked"
            )
    engine.cache.evict(task.domain_id, task.workflow_id, task.run_id)
    events_cache = getattr(engine, "events_cache", None)
    if events_cache is not None:
        events_cache.delete_workflow(
            task.domain_id, task.workflow_id, task.run_id
        )
