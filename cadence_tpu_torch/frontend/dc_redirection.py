"""DC redirection: forward API calls for passive global domains.

Reference: service/frontend/dcRedirectionHandler.go +
dcRedirectionPolicy.go — under the "selected-apis-forwarding" policy,
non-worker APIs for a domain whose active cluster is elsewhere are
forwarded to that cluster's frontend; the "noop" policy serves locally
and lets the history engine raise DomainNotActiveError.

A copy of the reference package's ``frontend/dc_redirection.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ..runtime.api import DomainNotActiveError

# the API set the reference forwards (dcRedirectionPolicy.go
# selectedAPIsForwardingRedirectionPolicyAPIAllowlist)
FORWARDED_APIS = frozenset(
    {
        "start_workflow_execution",
        "signal_workflow_execution",
        "signal_with_start_workflow_execution",
        "request_cancel_workflow_execution",
        "terminate_workflow_execution",
        "reset_workflow_execution",
        "query_workflow",
    }
)


class NoopRedirectionPolicy:
    def pick_cluster(self, domain_record, api: str, current: str) -> str:
        return current


class SelectedAPIsForwardingPolicy:
    def pick_cluster(self, domain_record, api: str, current: str) -> str:
        if (
            domain_record is None
            or not domain_record.is_global
            or api not in FORWARDED_APIS
        ):
            return current
        return domain_record.replication_config.active_cluster_name


class DCRedirectionHandler:
    """Wraps a WorkflowHandler; remote frontends are plugged per cluster
    (in-process peers in tests, gRPC stubs across real clusters)."""

    def __init__(
        self,
        local_handler,
        current_cluster: str,
        policy=None,
        remote_frontends: Optional[Dict[str, object]] = None,
    ) -> None:
        self.local = local_handler
        self.current = current_cluster
        self.policy = policy or SelectedAPIsForwardingPolicy()
        self.remotes: Dict[str, object] = dict(remote_frontends or {})

    def add_remote(self, cluster: str, frontend) -> None:
        self.remotes[cluster] = frontend

    def _domain_record(self, domain_name: str):
        try:
            return self.local.domain_handler.describe_domain(name=domain_name)
        except Exception:
            return None

    def call(self, api: str, domain_name: str, *args, **kwargs):
        rec = self._domain_record(domain_name)
        target = self.policy.pick_cluster(rec, api, self.current)
        if target == self.current:
            return getattr(self.local, api)(*args, **kwargs)
        remote = self.remotes.get(target)
        if remote is None:
            raise DomainNotActiveError(
                f"domain {domain_name} is active in {target!r} and no "
                "forwarding route is configured",
                active_cluster=target,
            )
        return getattr(remote, api)(*args, **kwargs)

    def __getattr__(self, api: str):
        # transparently proxy everything else to the local handler
        return getattr(self.local, api)
