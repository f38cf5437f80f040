"""Shard controller: acquire/release shard engines on membership change.

Reference: Cadence service/history/shardController.go:96,148-389 —
one engine per owned shard; a management pump re-evaluates ownership on
every membership ChangedEvent, acquiring newly-owned shards and
releasing stolen ones (the new owner's lease bump fences the old one).

Routing is an epoch-versioned ShardMap held by the history
ServiceResolver (runtime/resharding.py); the controller adopts a map
committed to the shard store over its constructor's shard count, and
``get_engine`` falls back to the previous epoch's shard handle while a
resolver holds one. The reconfiguration verbs that commit a new map wait
for a later slice of the port.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from ..utils.clock import TimeSource
from ..utils.log import get_logger

from .domains import DomainCache
from .engine.engine import HistoryEngine
from .membership import Monitor, ServiceResolver
from .persistence.interfaces import PersistenceBundle
from .shard import ShardContext


class ShardOwnershipLostError(Exception):
    def __init__(self, shard_id: int, owner: str) -> None:
        super().__init__(f"shard {shard_id} owned by {owner}")
        self.shard_id = shard_id
        self.owner = owner


class _ShardHandle:
    """One owned shard: context + engine + queue processors."""

    def __init__(self, shard: ShardContext, engine: HistoryEngine,
                 processors: List[object]) -> None:
        self.shard = shard
        self.engine = engine
        self.processors = processors

    def stop(self) -> None:
        for p in self.processors:
            p.stop()


class ShardController:
    def __init__(
        self,
        num_shards: int,
        persistence: PersistenceBundle,
        domain_cache: DomainCache,
        monitor: Monitor,
        engine_factory: Optional[Callable[[ShardContext], _ShardHandle]] = None,
        time_source: Optional[TimeSource] = None,
    ) -> None:
        self.initial_num_shards = num_shards
        self.persistence = persistence
        self.domains = domain_cache
        self.monitor = monitor
        self.identity = monitor.self_identity
        self._time = time_source
        self._engine_factory = engine_factory or self._default_factory
        self._lock = threading.Lock()
        self._handles: Dict[int, _ShardHandle] = {}
        self._log = get_logger("cadence_tpu_torch.shardController", host=self.identity)
        self._resolver: ServiceResolver = monitor.resolver("history")
        self._install_shard_map(num_shards)
        self._resolver.add_listener(
            f"shardController-{self.identity}", lambda ev: self.acquire_shards()
        )

    def _install_shard_map(self, num_shards: int) -> None:
        """Adopt the durable routing map: a committed reshard outlives
        every host restart, so the store's epoch wins over both the
        constructor arg and any stale resolver state."""
        from .resharding import ShardMap, load_reshard_state

        stored, _ = load_reshard_state(self.persistence.shard)
        current = self._resolver.shard_map()
        if stored is not None and (
            current is None or stored.epoch > current.epoch
        ):
            self._resolver.set_shard_map(stored)
        elif current is None:
            self._resolver.set_shard_map(ShardMap.initial(num_shards))

    # -- ownership -----------------------------------------------------

    @property
    def shard_map(self):
        return self._resolver.shard_map()

    @property
    def num_shards(self) -> int:
        """Live shard count under the current routing epoch."""
        m = self._resolver.shard_map()
        return m.num_shards if m is not None else self.initial_num_shards

    def shard_ids(self) -> List[int]:
        m = self._resolver.shard_map()
        return (
            m.shard_ids() if m is not None
            else list(range(self.initial_num_shards))
        )

    def _owned(self, shard_id: int) -> bool:
        return self._resolver.lookup(str(shard_id)).identity == self.identity

    def shard_for(self, workflow_id: str) -> int:
        return self.shard_map.shard_for(workflow_id)

    def acquire_shards(self) -> None:
        """Re-evaluate ownership for every shard (acquireShards :279-346).
        Walks the union of the current map's ids and anything still
        held, so a merged-away shard's engine is released too."""
        with self._lock:
            held = set(self._handles)
        # one consistent view of the id set for the whole sweep (a map
        # flip mid-loop re-fires the listener and re-evaluates anyway)
        ids = set(self.shard_ids())
        for shard_id in sorted(ids | held):
            try:
                owned = shard_id in ids and self._owned(shard_id)
            except RuntimeError:
                owned = False  # empty ring
            with self._lock:
                have = shard_id in self._handles
                if owned and not have:
                    try:
                        self._handles[shard_id] = self._engine_factory(
                            self._make_shard(shard_id)
                        )
                        self._log.info(f"acquired shard {shard_id}")
                    except Exception:
                        self._log.exception(f"failed to acquire shard {shard_id}")
                elif not owned and have:
                    self._handles.pop(shard_id).stop()
                    self._log.info(f"released shard {shard_id}")

    def _make_shard(self, shard_id: int) -> ShardContext:
        return ShardContext(
            shard_id, self.persistence, owner=self.identity,
            time_source=self._time,
        )

    def _default_factory(self, shard: ShardContext) -> _ShardHandle:
        engine = HistoryEngine(shard, self.domains)
        return _ShardHandle(shard, engine, [])

    # -- engine lookup -------------------------------------------------

    def get_engine(self, workflow_id: str) -> HistoryEngine:
        current, previous = self._resolver.shard_maps()
        shard_id = (
            current.shard_for(workflow_id) if current is not None else 0
        )
        try:
            return self.get_engine_for_shard(shard_id)
        except ShardOwnershipLostError:
            # dual-read window: a read racing a reshard flip may still
            # find the outgoing epoch's handle on this host
            if previous is not None:
                prev_id = previous.shard_for(workflow_id)
                if prev_id != shard_id:
                    with self._lock:
                        handle = self._handles.get(prev_id)
                    if handle is not None:
                        return handle.engine
            raise

    def get_engine_for_shard(self, shard_id: int) -> HistoryEngine:
        with self._lock:
            handle = self._handles.get(shard_id)
        if handle is None:
            try:
                owner = self._resolver.lookup(str(shard_id)).identity
            except RuntimeError:
                owner = "<no hosts>"
            raise ShardOwnershipLostError(shard_id, owner)
        return handle.engine

    def owned_shards(self) -> List[int]:
        with self._lock:
            return sorted(self._handles)

    def describe(self) -> dict:
        """DescribeHistoryHost (service/history/handler.go:662)."""
        m = self.shard_map
        with self._lock:
            return {
                "identity": self.identity,
                "shard_count": len(self._handles),
                "shard_ids": sorted(self._handles),
                "num_shards_total": self.num_shards,
                "reshard_epoch": m.epoch if m is not None else 0,
            }

    def stop(self) -> None:
        self._resolver.remove_listener(f"shardController-{self.identity}")
        with self._lock:
            for handle in self._handles.values():
                handle.stop()
            self._handles.clear()

    def release_shard(self, shard_id: int) -> None:
        """Force-release one owned shard (admin CloseShard — reference
        shardController.removeEngineForShard)."""
        with self._lock:
            handle = self._handles.pop(shard_id, None)
        if handle is not None:
            handle.stop()
