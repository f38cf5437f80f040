"""Membership: host ring with consistent-hash lookup + change listeners.

Reference: Cadence common/membership/interfaces.go:49-79
(Monitor / ServiceResolver) over ringpop SWIM gossip
(rpMonitor.go:44, rpServiceResolver.go:45). In this build the gossip
plane is replaced by an explicitly-driven host set (the onebox test
strategy, Cadence host/simpleMonitor.go): hosts join/leave via
API calls, listeners fire on change, and Lookup hashes keys onto a
replicated consistent-hash ring. Multi-host deployments drive the same
API from their orchestrator (k8s endpoints watch, etc.).

A copy of the reference package's ``runtime/membership.py``.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
from typing import Callable, Dict, List, Optional

_VNODES = 100  # virtual nodes per host for ring smoothness


def _ring_hash(s: str) -> int:
    """Ring position hash. NOT fnv1a32: FNV-1a over strings that differ
    only in a trailing counter ("host#0", "host#1", ...) yields hashes
    in arithmetic progression (stride = the FNV prime), so every host's
    vnodes form a band and a two-host ring degenerates — measured ~45%
    of adjacent-port host pairs put ALL 16 shard keys on one host. MD5
    avalanches properly; ring rebuilds are rare, lookups hash one short
    key."""
    # usedforsecurity=False: this is a placement hash; FIPS-mode
    # OpenSSL otherwise refuses md5 entirely
    digest = hashlib.md5(s.encode(), usedforsecurity=False).digest()
    return int.from_bytes(digest[:4], "big")


class HostInfo:
    def __init__(self, identity: str) -> None:
        self.identity = identity

    def __repr__(self) -> str:
        return f"HostInfo({self.identity!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, HostInfo) and other.identity == self.identity

    def __hash__(self) -> int:
        return hash(self.identity)


class ChangedEvent:
    def __init__(self, added: List[str], removed: List[str]) -> None:
        self.hosts_added = added
        self.hosts_removed = removed


class ServiceResolver:
    """Consistent-hash ring for one service (rpServiceResolver.go)."""

    def __init__(self, service: str) -> None:
        self.service = service
        self._lock = threading.Lock()
        self._hosts: List[str] = []
        self._ring: List[int] = []  # sorted vnode hashes
        self._ring_hosts: Dict[int, str] = {}
        self._listeners: Dict[str, Callable[[ChangedEvent], None]] = {}
        # epoch-versioned shard routing (runtime/resharding.ShardMap):
        # the reshard coordinator flips the current map atomically and
        # keeps the outgoing one for a brief dual-read window so reads
        # racing the flip can still find the old owner's handle
        self._shard_map = None
        self._prev_shard_map = None

    # -- shard map (elastic resharding) --------------------------------

    def set_shard_map(self, shard_map, previous=None) -> None:
        """Atomically flip the routing epoch. ``previous`` keeps the
        outgoing map readable (dual-read window) until
        ``retire_previous_shard_map``."""
        with self._lock:
            if (
                self._shard_map is not None
                and shard_map.epoch < self._shard_map.epoch
            ):
                return  # a newer epoch already landed; never regress
            self._prev_shard_map = previous
            self._shard_map = shard_map

    def shard_map(self):
        with self._lock:
            return self._shard_map

    def shard_maps(self):
        """(current, previous-or-None) under one lock acquisition."""
        with self._lock:
            return self._shard_map, self._prev_shard_map

    def retire_previous_shard_map(self) -> None:
        with self._lock:
            self._prev_shard_map = None

    def _rebuild(self) -> None:
        self._ring = []
        self._ring_hosts = {}
        for host in self._hosts:
            for v in range(_VNODES):
                h = _ring_hash(f"{host}#{v}")
                # first writer wins on (astronomically unlikely) collision
                if h not in self._ring_hosts:
                    self._ring_hosts[h] = host
        self._ring = sorted(self._ring_hosts)

    def set_hosts(self, hosts: List[str]) -> None:
        with self._lock:
            old = set(self._hosts)
            new = set(hosts)
            self._hosts = sorted(new)
            self._rebuild()
            listeners = list(self._listeners.values())
        event = ChangedEvent(sorted(new - old), sorted(old - new))
        if event.hosts_added or event.hosts_removed:
            for cb in listeners:
                cb(event)

    def members(self) -> List[HostInfo]:
        with self._lock:
            return [HostInfo(h) for h in self._hosts]

    def member_count(self) -> int:
        with self._lock:
            return len(self._hosts)

    def lookup(self, key: str) -> HostInfo:
        """key → owning host (Lookup, interfaces.go:74)."""
        with self._lock:
            if not self._ring:
                raise RuntimeError(
                    f"no hosts in service ring {self.service!r}"
                )
            h = _ring_hash(key)
            idx = bisect.bisect_left(self._ring, h)
            if idx == len(self._ring):
                idx = 0
            return HostInfo(self._ring_hosts[self._ring[idx]])

    def add_listener(
        self, name: str, cb: Callable[[ChangedEvent], None]
    ) -> None:
        with self._lock:
            self._listeners[name] = cb

    def remove_listener(self, name: str) -> None:
        with self._lock:
            self._listeners.pop(name, None)


class Monitor:
    """Per-service rings + this host's identity (membership.Monitor)."""

    SERVICES = ("frontend", "history", "matching", "worker")

    def __init__(self, self_identity: str = "self") -> None:
        self.self_identity = self_identity
        self._resolvers: Dict[str, ServiceResolver] = {
            s: ServiceResolver(s) for s in self.SERVICES
        }

    def resolver(self, service: str) -> ServiceResolver:
        r = self._resolvers.get(service)
        if r is None:
            r = self._resolvers[service] = ServiceResolver(service)
        return r

    def whoami(self) -> HostInfo:
        return HostInfo(self.self_identity)

    def join(self, service: str, identity: Optional[str] = None) -> None:
        identity = identity or self.self_identity
        r = self.resolver(service)
        hosts = [h.identity for h in r.members()]
        if identity not in hosts:
            r.set_hosts(hosts + [identity])

    def leave(self, service: str, identity: Optional[str] = None) -> None:
        identity = identity or self.self_identity
        r = self.resolver(service)
        r.set_hosts([h.identity for h in r.members() if h.identity != identity])


def single_host_monitor(identity: str = "onebox") -> Monitor:
    """A monitor where this host owns every service (onebox topology)."""
    m = Monitor(identity)
    for s in Monitor.SERVICES:
        m.join(s)
    return m


class FailureDetector:
    """Direct-probe liveness monitor: the SWIM stand-in.

    Reference: ringpop gossip drives membership so a dead host's shards
    are reacquired automatically (Cadence common/membership/
    rpMonitor.go:44). Here each host probes its rings' peers directly
    (``probe(service, address) -> bool``, transport injected — the rpc
    plane provides grpc_ping); ``failure_threshold`` consecutive misses
    evict the peer from THIS host's rings via Monitor.leave, firing
    resolver listeners so the shard controller rebalances and reacquires
    the dead host's shards under rangeID fencing. Hosts detect
    independently, so rings may diverge for ~a probe interval — the
    same transient SWIM suspicion allows. Recovery (a restarted host
    rejoining) is driven by that host's own bootstrap join, as before.
    """

    def __init__(
        self,
        monitor: Monitor,
        probe: Callable[[str, str], bool],
        own_identities: Optional[set] = None,
        services: Optional[List[str]] = None,
        probe_interval_s: float = 1.0,
        failure_threshold: int = 3,
    ) -> None:
        self.monitor = monitor
        self.probe = probe
        self.own = set(own_identities or {monitor.self_identity})
        self.services = list(services or Monitor.SERVICES)
        self.probe_interval_s = probe_interval_s
        self.failure_threshold = failure_threshold
        self._misses: Dict[tuple, int] = {}
        # evicted peers stay on the probe list: a restarted host that
        # answers again is re-admitted (monitor.join) — without this,
        # eviction would be permanent on every SURVIVING host and a
        # returning peer would split the rings (it sees {A,B}, the
        # survivor sees {A}), double-acquiring shards forever
        self._evicted: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pool = None  # lazy: probe rounds reuse one executor

    def start(self) -> "FailureDetector":
        self._thread = threading.Thread(
            target=self._run, name="failureDetector", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    def _run(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            try:
                self.probe_once()
            except Exception:  # detector must outlive transient faults
                pass

    def probe_once(self) -> None:
        """One probe round over every ring peer + every evicted peer
        (test-callable). Probes run concurrently so one blackholed host
        cannot stretch the round by its full timeout per peer; ring
        mutations happen after the round, on this thread."""
        targets = []  # (service, identity, currently_evicted)
        for service in self.services:
            for host in self.monitor.resolver(service).members():
                if host.identity not in self.own:
                    targets.append((service, host.identity, False))
        targets.extend((s, i, True) for (s, i) in self._evicted)
        if not targets:
            return
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="fd-probe"
            )
        alive = list(self._pool.map(
            lambda t: self.probe(t[0], t[1]), targets
        ))
        for (service, ident, evicted), ok in zip(targets, alive):
            key = (service, ident)
            if ok:
                self._misses.pop(key, None)
                if evicted:
                    self._evicted.discard(key)
                    self.monitor.join(service, ident)
                continue
            if evicted:
                continue
            n = self._misses.get(key, 0) + 1
            self._misses[key] = n
            if n >= self.failure_threshold:
                self._misses.pop(key, None)
                self._evicted.add(key)
                self.monitor.leave(service, ident)
