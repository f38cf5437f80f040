"""Worker service assembly: all background daemons on one host.

Reference: service/worker/service.go — starts the sub-daemons that are
enabled by config: replicator consumers (global-domain clusters),
indexer (advanced visibility), archiver, scanner, batcher,
parent-close-policy, each on the system domain.

A copy of the reference package's ``worker/service.py``.
"""

from __future__ import annotations

from typing import List, Optional

from ..messaging import MessageBus

from .archiver import SYSTEM_DOMAIN, build_archiver_worker
from .batcher import build_batcher_worker
from .indexer import Indexer
from .parent_close_policy import build_parent_close_policy_worker
from .replicator import DomainReplicationProcessor, HistoryReplicationConsumer
from .scanner import build_scanner_worker


class WorkerService:
    def __init__(
        self,
        frontend,
        persistence,
        num_shards: int,
        bus: Optional[MessageBus] = None,
        domain_handler=None,
        history_service=None,
        visibility_store=None,
        enable_scanner: bool = True,
        enable_batcher: bool = True,
        enable_archiver: bool = True,
        enable_pcp: bool = True,
        enable_indexer: bool = False,
        replication_sources: Optional[List[str]] = None,
    ) -> None:
        self.frontend = frontend
        self._ensure_system_domain(frontend)
        self._scanner_enabled = enable_scanner
        self.workers = []
        self.consumers = []
        if enable_archiver:
            self.workers.append(
                build_archiver_worker(
                    frontend, persistence.history, persistence.execution,
                    shard_resolver=(
                        history_service.controller.shard_for
                        if history_service is not None
                        else None
                    ),
                )
            )
        if enable_scanner:
            self.workers.append(
                build_scanner_worker(
                    frontend, persistence.task, persistence.history,
                    persistence.execution, num_shards=num_shards,
                    # live ids, not the boot-time count: after a shard
                    # split the scavenger must count the new shard's
                    # runs as live or it would destroy their histories
                    shard_ids=(
                        history_service.controller.shard_ids
                        if history_service is not None else None
                    ),
                    matching=frontend.matching if hasattr(
                        frontend, "matching"
                    ) else None,
                )
            )
        if enable_batcher:
            self.workers.append(build_batcher_worker(frontend))
        if enable_pcp:
            self.workers.append(build_parent_close_policy_worker(frontend))
        if enable_indexer and bus is not None and visibility_store is not None:
            self.consumers.append(Indexer(bus, visibility_store))
        if bus is not None and domain_handler is not None:
            self.domain_replication = DomainReplicationProcessor(
                bus, domain_handler
            )
            # pumped like every other consumer — construction alone
            # would leave published domain records unapplied forever
            self.consumers.append(self.domain_replication)
        else:
            self.domain_replication = None
        if bus is not None and history_service is not None:
            for source in replication_sources or []:
                self.consumers.append(
                    HistoryReplicationConsumer(bus, source, history_service)
                )

    @staticmethod
    def _ensure_system_domain(frontend) -> None:
        from ..frontend.domain_handler import DomainAlreadyExistsError

        try:
            frontend.register_domain(SYSTEM_DOMAIN, retention_days=1)
        except DomainAlreadyExistsError:
            pass

    def start(self) -> None:
        for w in self.workers:
            w.start()
        for c in self.consumers:
            c.start()
        self._kick_scanner()

    def _kick_scanner(self) -> None:
        """Launch the scavenger cron workflow (scanner.go starts it at
        service start; AlreadyStarted means a previous run is live)."""
        if not self._scanner_enabled:
            return
        from ..runtime.api import (
            StartWorkflowRequest,
            WorkflowExecutionAlreadyStartedServiceError,
        )

        from .scanner import (
            SCANNER_TASK_LIST,
            SCANNER_WORKFLOW_ID,
            SCANNER_WORKFLOW_TYPE,
        )

        try:
            self.frontend.start_workflow_execution(
                StartWorkflowRequest(
                    domain=SYSTEM_DOMAIN,
                    workflow_id=SCANNER_WORKFLOW_ID,
                    workflow_type=SCANNER_WORKFLOW_TYPE,
                    task_list=SCANNER_TASK_LIST,
                    input=b"60",
                    execution_start_to_close_timeout_seconds=3600 * 24,
                    task_start_to_close_timeout_seconds=30,
                )
            )
        except WorkflowExecutionAlreadyStartedServiceError:
            pass

    def stop(self) -> None:
        for w in self.workers:
            w.stop()
        for c in self.consumers:
            c.stop()
