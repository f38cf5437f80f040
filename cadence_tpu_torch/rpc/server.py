"""gRPC servers over generic handlers: every service's network endpoint.

Reference: common/rpc.go dispatcher + the per-service Thrift servers
(service/frontend, service/history/handler.go:227,
service/matching/handler.go). Methods are dispatched by name to the
target handler objects; requests/responses ride the JSON codec; service
errors map to gRPC status codes with the error class in the details for
client-side re-raise.

The history endpoint's targets are an in-process HistoryClient bound to
the LOCAL shard controller plus the HistoryService — exactly the
reference shape where the receiving host's handler re-resolves the
shard's engine and surfaces ShardOwnershipLostError to the caller for
retry after the ring settles (handler.go:262).

A copy of the reference package's ``rpc/server.py``, its service names
on the wire included.
"""

from __future__ import annotations

from concurrent import futures
from typing import Optional

import grpc

from . import codec
from .errors import ERROR_CODES

FRONTEND_SERVICE = "cadence_tpu.Frontend"
HISTORY_SERVICE = "cadence_tpu.History"
MATCHING_SERVICE = "cadence_tpu.Matching"

# lifecycle/assembly methods must NOT be remotely callable — the
# generic by-name dispatch would otherwise let anyone who can reach
# the port shut a service down or corrupt routing
DISPATCH_DENYLIST = frozenset({
    "start", "stop", "shutdown", "close", "wire", "drain",
    "drain_queues", "notify", "add_host", "remove_host",
    "unload_idle_task_lists", "enable_replication_from",
    "acquire_shards", "release_shard",
})


class _Generic(grpc.GenericRpcHandler):
    def __init__(self, targets, service: str = FRONTEND_SERVICE) -> None:
        self._targets = targets  # list of handler objects, first match
        self._service = service

    def _resolve(self, name: str):
        if name.startswith("_") or name in DISPATCH_DENYLIST:
            return None
        for target in self._targets:
            fn = getattr(target, name, None)
            if fn is not None and callable(fn):
                return fn
        return None

    def service(self, call_details):
        prefix = f"/{self._service}/"
        if not call_details.method.startswith(prefix):
            return None
        name = call_details.method[len(prefix):]
        if name == "ping":
            # built-in liveness probe for the failure detector
            # (membership.FailureDetector; ref ringpop's direct probe,
            # common/membership/rpMonitor.go) — no handler dispatch
            return grpc.unary_unary_rpc_method_handler(
                lambda request, context: {"ok": True},
                request_deserializer=codec.loads,
                response_serializer=codec.dumps_enveloped,
            )
        fn = self._resolve(name)
        if fn is None:
            return None

        service_short = self._service.rsplit(".", 1)[-1].lower()

        def handler(request, context):
            from ..utils.tracing import TRACER, extract_metadata

            args, kwargs = request
            # trace propagation: a caller-shipped context parents this
            # server's span (the cross-process hop of one trace); with
            # no inbound context the endpoint MAY root a new trace at
            # the configured sample rate (telemetry: YAML section) —
            # rate 0 (the default) makes this a no-op span
            ctx = extract_metadata(context.invocation_metadata())
            if ctx is not None:
                span = TRACER.span(
                    f"rpc.{name}", service=service_short, parent=ctx
                )
            else:
                span = TRACER.trace(f"rpc.{name}", service=service_short)
            try:
                with span:
                    return fn(*args, **kwargs)
            except Exception as e:
                cls = type(e).__name__
                code = ERROR_CODES.get(cls, grpc.StatusCode.INTERNAL)
                # ship the error's structured attributes so the client
                # rebuilds a faithful instance (e.run_id on
                # AlreadyStarted, e.shard_id/.owner on
                # ShardOwnershipLost), not a bare-message shell
                attrs = {
                    k: v for k, v in vars(e).items()
                    if isinstance(v, (str, int, float, bool, bytes))
                }
                if attrs:
                    try:
                        context.set_trailing_metadata(
                            (("error-attrs-bin", codec.dumps(attrs)),)
                        )
                    except Exception:
                        pass  # diagnostics only; the error still flows
                context.abort(code, f"{cls}: {e}")

        return grpc.unary_unary_rpc_method_handler(
            handler,
            request_deserializer=codec.loads,
            response_serializer=codec.dumps_enveloped,
        )


class ServiceRPCServer:
    """A gRPC endpoint dispatching one service's methods by name."""

    def __init__(
        self, service: str, targets, address: str = "127.0.0.1:0",
        max_workers: int = 64, server: Optional[grpc.Server] = None,
    ) -> None:
        self.service = service
        self._owns_server = server is None
        self._server = server or grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers)
        )
        self._server.add_generic_rpc_handlers(
            (_Generic(list(targets), service),)
        )
        if self._owns_server:
            self.port = self._server.add_insecure_port(address)
            self.address = f"127.0.0.1:{self.port}"

    def start(self) -> "ServiceRPCServer":
        if self._owns_server:
            self._server.start()
        return self

    def stop(self, grace: Optional[float] = 0.5) -> None:
        if self._owns_server:
            self._server.stop(grace)


class FrontendRPCServer(ServiceRPCServer):
    def __init__(
        self, frontend, admin=None, address: str = "127.0.0.1:0",
        max_workers: int = 64,
    ) -> None:
        targets = [frontend] + ([admin] if admin is not None else [])
        super().__init__(FRONTEND_SERVICE, targets, address, max_workers)


class HistoryRPCServer(ServiceRPCServer):
    """This host's history endpoint: an in-proc HistoryClient over the
    LOCAL controller resolves each call's shard engine (not-owned shards
    raise ShardOwnershipLostError back to the remote caller)."""

    def __init__(
        self, history_service, address: str = "127.0.0.1:0",
        max_workers: int = 64, server: Optional[grpc.Server] = None,
    ) -> None:
        from ..client.history import HistoryClient

        # share the service's metrics scope so the client-layer
        # retry_budget_exhausted counter is observable on this host
        local = HistoryClient(
            history_service.controller,
            metrics=history_service.metrics,
        )
        super().__init__(
            HISTORY_SERVICE, [local, history_service], address,
            max_workers, server=server,
        )


class MatchingRPCServer(ServiceRPCServer):
    def __init__(
        self, matching_engine, address: str = "127.0.0.1:0",
        max_workers: int = 64, server: Optional[grpc.Server] = None,
    ) -> None:
        super().__init__(
            MATCHING_SERVICE, [matching_engine], address, max_workers,
            server=server,
        )
