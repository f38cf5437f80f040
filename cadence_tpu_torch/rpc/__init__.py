"""The host-to-host wire codec.

The encoding half of the reference package's ``rpc/`` codec (JSON with
dataclass, bytes, enum and tuple envelopes). The replication transport
sizes every transfer by it (``runtime/replication/transport.wire_size``).
Decoding and the gRPC server and clients wait for the rpc slice of the
port.
"""

from .codec import encode

__all__ = ["encode"]
