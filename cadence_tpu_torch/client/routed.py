"""Cross-process routed clients: ring lookup → host address → gRPC stub.

Reference: client/history/client.go:844-846 (GetClientForKey: shard key
→ membership ring → host → RPC client) and client/matching/client.go
(task-list-name routing). The in-process clients (client/history.py,
client/matching.py) short-circuit to local engines; these variants add
the process boundary: a shard (or task list) owned by another host is
reached through that host's History/Matching gRPC endpoint
(rpc/server.py), with stubs cached per address.

Host identities in the membership ring ARE dial addresses (the
reference's ringpop identities are host:port the same way), so routing
needs no separate address registry.

A copy of the reference package's ``client/routed.py``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import grpc

from ..runtime.controller import ShardOwnershipLostError
from ..runtime.membership import Monitor
from ..utils.backoff import ExponentialRetryPolicy, retry
from ..utils.hashing import shard_for_workflow

from .history import HistoryClient
from .matching import MatchingClient

# Service-client retry schedule: the reference wraps every service
# client in a retryable layer (client/history/retryableClient.go:1-60,
# client/matching/retryableClient.go) with
# CreateHistoryServiceRetryPolicy (50ms initial, bounded expiration).
# Each attempt re-resolves the ring, so a shard that moved mid-call is
# found at its new owner once the ring settles.
ROUTED_RETRY_POLICY = ExponentialRetryPolicy(
    initial_interval_s=0.05,
    backoff_coefficient=2.0,
    maximum_interval_s=2.0,
    expiration_interval_s=10.0,
    maximum_attempts=0,
)


def is_routed_retryable(e: Exception) -> bool:
    """ShardOwnershipLost + transport-level transients (the reference's
    common.IsServiceTransientError + membership re-resolution cases)."""
    from ..runtime.persistence.errors import (
        ShardOwnershipLostError as PersistenceShardOwnershipLost,
    )

    # both ownership-lost shapes: the controller's (remote handler, and
    # the rpc client rebuilds this class from the wire) AND the
    # persistence layer's rangeID-fencing sibling, which the LOCAL
    # engine path surfaces directly when the shard moved away mid-call
    if isinstance(e, (ShardOwnershipLostError,
                      PersistenceShardOwnershipLost, ConnectionError)):
        return True
    if isinstance(e, grpc.RpcError):
        # CANCELLED: the stub cache closed this channel under us (its
        # host left the ring mid-call) — the next attempt re-resolves
        # and dials fresh
        return e.code() in (grpc.StatusCode.UNAVAILABLE,
                            grpc.StatusCode.CANCELLED)
    if isinstance(e, ValueError) and "closed channel" in str(e):
        return True  # raced an evicted stub; re-resolve and redial
    # ring momentarily empty while a host is being replaced
    if isinstance(e, RuntimeError) and "no hosts in service ring" in str(e):
        return True
    return False


def _traced_attempts(fn, method: str):
    """Wrap a retried thunk so re-resolution attempts annotate the
    active trace (utils/tracing.py) — no active trace, no cost beyond
    an int increment."""
    from ..utils.tracing import TRACER

    state = {"n": 0}

    def attempt():
        state["n"] += 1
        if state["n"] > 1:
            TRACER.annotate(
                f"routed retry attempt={state['n'] - 1} op={method}"
            )
        return fn()

    return attempt


class _StubCache:
    def __init__(self, factory) -> None:
        self._factory = factory
        self._stubs: Dict[str, object] = {}
        self._lock = threading.Lock()

    def get(self, address: str):
        with self._lock:
            stub = self._stubs.get(address)
            if stub is None:
                stub = self._stubs[address] = self._factory(address)
            return stub

    def evict(self, addresses) -> None:
        """Drop (and close) stubs for hosts that left the ring — an
        address reused by a new instance must get a fresh channel."""
        with self._lock:
            stubs = [
                self._stubs.pop(a) for a in addresses if a in self._stubs
            ]
        for stub in stubs:
            try:
                stub.close()
            except Exception:
                pass

    def close(self) -> None:
        with self._lock:
            for stub in self._stubs.values():
                stub.close()
            self._stubs.clear()


class RoutedHistoryClient(HistoryClient):
    """HistoryClient surface; shard → ring("history") → local engine or
    remote History endpoint."""

    def __init__(
        self,
        monitor: Monitor,
        local_controller=None,
        num_shards: Optional[int] = None,
        retry_budget=None,
        metrics=None,
    ) -> None:
        from ..rpc.client import RemoteHistory
        from ..utils.metrics import NOOP

        super().__init__(
            {} if local_controller is None
            else {local_controller.identity: local_controller},
            retry_budget=retry_budget,
            metrics=metrics if metrics is not None else NOOP,
        )
        self.monitor = monitor
        self.local = local_controller
        self.num_shards = (
            num_shards if num_shards is not None
            else (local_controller.num_shards if local_controller else 1)
        )
        self._stubs = _StubCache(RemoteHistory)
        self.retry_policy = ROUTED_RETRY_POLICY
        self._listener = f"routed-history-{id(self)}"
        monitor.resolver("history").add_listener(
            self._listener,
            lambda ev: self._stubs.evict(ev.hosts_removed),
        )

    def _call_once(self, workflow_id: str, method: str, *args, **kwargs):
        # epoch-versioned routing: after a reshard flip the resolver's
        # ShardMap is the truth; the static modulo is only the pre-
        # reshard (epoch 0) fallback for monitors without a map
        shard_map = self.monitor.resolver("history").shard_map()
        if shard_map is not None:
            shard_id = shard_map.shard_for(workflow_id)
        else:
            shard_id = shard_for_workflow(workflow_id, self.num_shards)
        owner = self.monitor.resolver("history").lookup(
            str(shard_id)
        ).identity
        if self.local is not None and owner == self.local.identity:
            return getattr(
                self.local.get_engine_for_shard(shard_id), method
            )(*args, **kwargs)
        return getattr(self._stubs.get(owner), method)(*args, **kwargs)

    def _call_inner(self, workflow_id: str, method: str, *args, **kwargs):
        # the ownership/transport retry layer; the ServiceBusy retry
        # BUDGET lives above it in HistoryClient._call — a shed
        # response is deliberately NOT in is_routed_retryable, or the
        # unbudgeted transport retry would amplify the very overload
        # the server is shedding
        return retry(
            _traced_attempts(
                lambda: self._call_once(workflow_id, method, *args,
                                        **kwargs),
                method,
            ),
            policy=self.retry_policy,
            is_retriable=is_routed_retryable,
        )

    def close(self) -> None:
        self.monitor.resolver("history").remove_listener(self._listener)
        self._stubs.close()


class RoutedMatchingClient(MatchingClient):
    """MatchingClient surface; task list → ring("matching") → local
    engine or remote Matching endpoint."""

    def __init__(self, monitor: Monitor, local_engine=None,
                 local_identity: str = "") -> None:
        from ..rpc.client import RemoteMatching

        super().__init__(
            {local_identity or "local": local_engine}
            if local_engine is not None else {}
        )
        self.monitor = monitor
        self.local_engine = local_engine
        self.local_identity = local_identity or monitor.self_identity
        self._stubs = _StubCache(RemoteMatching)
        self.retry_policy = ROUTED_RETRY_POLICY
        self._listener = f"routed-matching-{id(self)}"
        monitor.resolver("matching").add_listener(
            self._listener,
            lambda ev: self._stubs.evict(ev.hosts_removed),
        )

    def _engine_for(self, task_list: str):
        owner = self.monitor.resolver("matching").lookup(task_list).identity
        if self.local_engine is not None and owner == self.local_identity:
            return self.local_engine
        return self._stubs.get(owner)

    def _invoke(self, task_list: str, method: str, *args, **kwargs):
        # each attempt re-resolves the ring (retryableClient.go parity)
        return retry(
            _traced_attempts(
                lambda: getattr(self._engine_for(task_list), method)(
                    *args, **kwargs
                ),
                method,
            ),
            policy=self.retry_policy,
            is_retriable=is_routed_retryable,
        )

    def close(self) -> None:
        self.monitor.resolver("matching").remove_listener(self._listener)
        self._stubs.close()
