"""Service clients: in-process access to history and matching.

Reference: Cadence client/ — per-service clients that resolve the owning
host through the membership ring and dispatch calls (history routes by
workflowID → shard → host, client/history/client.go:844-846; matching
routes by task list). HistoryClient and MatchingClient dispatch
in-process into the target host's engine registry; the reference
package's routed variants, which add the process boundary, wait for the
port of the rpc layer.
"""

from .history import HistoryClient
from .matching import MatchingClient

__all__ = [
    "HistoryClient",
    "MatchingClient",
]
