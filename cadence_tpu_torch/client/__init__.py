"""Service clients: ring-routed access to history and matching.

Reference: Cadence client/ — per-service clients that resolve
the owning host through the membership ring and dispatch RPCs
(history routes by workflowID → shard → host,
client/history/client.go:844-846; matching routes by task list).
HistoryClient/MatchingClient dispatch in-process into the target host's
engine registry; the Routed* variants add the process boundary — ring
lookup → host address → gRPC stub (rpc/server.py endpoints).

A copy of the reference package's ``client/``.
"""

from .history import HistoryClient
from .matching import MatchingClient
from .routed import RoutedHistoryClient, RoutedMatchingClient

__all__ = [
    "HistoryClient",
    "MatchingClient",
    "RoutedHistoryClient",
    "RoutedMatchingClient",
]
