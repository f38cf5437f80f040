"""RPC layer: the host↔host plane.

Reference: common/rpc.go — YARPC dispatchers over TChannel. The
reference package's equivalent is gRPC for the host plane (device to
device traffic rides the collectives, never this layer). Uses gRPC
generic handlers with a JSON+dataclass codec, so no IDL compilation step
is needed.

A copy of the reference package's ``rpc/``. The service names on the wire
(``cadence_tpu.Frontend``, ``cadence_tpu.History``,
``cadence_tpu.Matching``) are the reference's, so a client of either
package calls a server of the other.
"""

from .codec import decode, encode
from .server import FrontendRPCServer
from .client import RemoteClusterRPCClient, RemoteFrontend

__all__ = [
    "decode",
    "encode",
    "FrontendRPCServer",
    "RemoteClusterRPCClient",
    "RemoteFrontend",
]
