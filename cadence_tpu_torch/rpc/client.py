"""gRPC client stub: a remote WorkflowHandler with the same surface.

Any method on the server-side frontend/admin is callable by name; the
stub re-raises the server's service errors as their local classes.

A copy of the reference package's ``rpc/client.py``, its service names
on the wire included.
"""

from __future__ import annotations

from typing import Any

import grpc

from . import codec
from .errors import ERROR_TYPES

_SERVICE = "cadence_tpu.Frontend"


class _Method:
    def __init__(self, channel: grpc.Channel, name: str,
                 service: str = _SERVICE) -> None:
        self._call = channel.unary_unary(
            f"/{service}/{name}",
            request_serializer=codec.dumps,
            response_deserializer=codec.loads_envelope,
        )

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        # trace propagation (utils/tracing.py): a sampled caller's
        # context rides the metadata so the receiving host's spans join
        # the same trace; with no active trace this is one thread-local
        # read returning the metadata unchanged (None)
        from ..utils.tracing import inject_metadata

        try:
            return self._call(
                (list(args), kwargs), metadata=inject_metadata()
            )["r"]
        except grpc.RpcError as e:
            details = e.details() or ""
            cls_name, _, msg = details.partition(": ")
            exc_type = ERROR_TYPES.get(cls_name)
            if exc_type is not None:
                exc = _build(exc_type, msg)
                # restore the structured attributes the server attached
                # (e.run_id, e.shard_id, ...) — without them the rebuilt
                # instance is a bare-message shell
                for key, value in (e.trailing_metadata() or ()):
                    if key == "error-attrs-bin":
                        try:
                            exc.__dict__.update(codec.loads(value))
                        except Exception:
                            pass
                raise exc from None
            raise


def _build(exc_type, msg):
    try:
        return exc_type(msg)
    except TypeError:
        e = exc_type.__new__(exc_type)
        Exception.__init__(e, msg)
        return e


class RemoteService:
    """Dial a service endpoint; any method is callable by name with the
    same surface as the server-side handler."""

    _service = _SERVICE

    def __init__(self, address: str) -> None:
        self.address = address
        self._channel = grpc.insecure_channel(address)
        self._methods = {}

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        m = self._methods.get(name)
        if m is None:
            m = self._methods[name] = _Method(
                self._channel, name, self._service
            )
        return m

    def close(self) -> None:
        self._channel.close()


class RemoteFrontend(RemoteService):
    """Dial a frontend; use exactly like a local WorkflowHandler."""

    _service = "cadence_tpu.Frontend"


class RemoteHistory(RemoteService):
    """Dial a history host; same surface as an in-proc HistoryClient."""

    _service = "cadence_tpu.History"


class RemoteMatching(RemoteService):
    """Dial a matching host; same surface as a MatchingEngine."""

    _service = "cadence_tpu.Matching"


class RemoteClusterRPCClient:
    """Cross-cluster replication transport: the DCN pull plane.

    Implements the fetcher's RemoteClusterClient contract
    (runtime/replication/processor.py) over the gRPC history endpoint
    of a host in the SOURCE cluster — the consumer cluster's fetchers
    dial the source and drain its replicator queue, exactly the
    reference's admin client GetReplicationMessages over the cross-DC
    connection (client/admin + common/rpc dispatching on
    ClusterInformation rpc addresses).
    """

    def __init__(self, address: str, consumer_cluster: str) -> None:
        self._stub = RemoteHistory(address)
        self.address = address
        self.consumer_cluster = consumer_cluster

    def get_replication_messages(
        self, shard_id: int, last_retrieved_id: int, max_tasks=None
    ):
        if max_tasks is None:
            # omit the argument entirely: a source host still running
            # the pre-paging handler signature keeps serving fetches
            # through a rolling upgrade (the same compatibility rule
            # ReplicationTaskFetcher.fetch applies)
            return self._stub.get_replication_messages(
                shard_id, last_retrieved_id, self.consumer_cluster
            )
        return self._stub.get_replication_messages(
            shard_id, last_retrieved_id, self.consumer_cluster,
            max_tasks,
        )

    def get_workflow_history_raw(
        self, domain_id: str, workflow_id: str, run_id: str,
        start_event_id: int, end_event_id: int,
    ):
        return self._stub.get_workflow_history_raw(
            domain_id, workflow_id, run_id, start_event_id, end_event_id
        )

    # -- bandwidth-adaptive state transfer (replication/transport.py) --

    def get_replication_backlog(
        self, shard_id: int, last_retrieved_id: int
    ):
        """Per-run backlog spans past the cursor (no event payloads) —
        the adaptive consumer's catch-up probe."""
        return self._stub.get_replication_backlog(
            shard_id, last_retrieved_id
        )

    def get_replication_checkpoint(
        self, domain_id: str, workflow_id: str, run_id: str
    ) -> bytes:
        """Delta-compressed branch-tip ReplayCheckpoint (snapshot
        shipping); b"" = no shippable snapshot."""
        return self._stub.get_replication_checkpoint(
            domain_id, workflow_id, run_id
        )

    def close(self) -> None:
        self._stub.close()


# -- liveness probe (failure detector transport) -------------------------

_PING_SERVICES = {
    "frontend": "cadence_tpu.Frontend",
    "history": "cadence_tpu.History",
    "matching": "cadence_tpu.Matching",
}


def grpc_ping(service: str, address: str, timeout_s: float = 1.0) -> bool:
    """One direct liveness probe: the built-in ``ping`` method every
    ServiceRPCServer exposes (rpc/server.py). Transport for
    membership.FailureDetector — the stand-in for ringpop's SWIM
    direct-probe (Cadence common/membership/rpMonitor.go:44).

    A fresh channel per probe keeps the probe honest: a cached channel
    can report a stale READY state for a port whose process just died.
    """
    service_name = _PING_SERVICES.get(service)
    if service_name is None:
        return True  # no RPC surface to probe (e.g. worker ring)
    channel = grpc.insecure_channel(address)
    try:
        call = channel.unary_unary(
            f"/{service_name}/ping",
            request_serializer=codec.dumps,
            response_deserializer=codec.loads_envelope,
        )
        call(([], {}), timeout=timeout_s)
        return True
    except grpc.RpcError as e:
        if e.code() == grpc.StatusCode.UNAVAILABLE:
            return False  # connection refused/reset: the process is gone
        # DEADLINE_EXCEEDED etc. can just mean the service thread pool
        # is saturated (64 long-polls queue the ping behind them) — a
        # busy host must not be evicted as dead. Distinguish with a raw
        # TCP connect: a live process still accepts; a crashed or
        # blackholed one does not.
        return _tcp_alive(address, timeout_s)
    finally:
        channel.close()


def _tcp_alive(address: str, timeout_s: float) -> bool:
    import socket

    host, _, port = address.rpartition(":")
    try:
        with socket.create_connection((host or "127.0.0.1", int(port)),
                                      timeout=timeout_s):
            return True
    except OSError:
        return False
