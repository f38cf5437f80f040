"""Wire codec: JSON with dataclass/bytes/enum/tuple envelopes.

Replaces the reference's thrift envelope (common/codec/
version0Thriftrw.go): every API type crossing the host plane is a
registered dataclass; bytes are base64; enums are ints; tuples are
tagged so (events, token) responses round-trip.

A copy of the reference package's ``rpc/codec.py`` over the port's types,
with two envelopes the reference has not, for values it refuses to
encode: ``__nd`` (a numpy array: dtype, shape and base64 bytes; a numpy
scalar travels as its Python value) and ``__ik`` (an int-keyed dict as
[key, value] pairs). With them the history endpoint's ``serving_read``
answers over the wire: its ``ResidentRead`` holds a state row of arrays,
a snapshot keyed by slot ids and a side table (``ResidentRead``,
``WorkflowSideTable`` and ``PackResume`` are registered). Everything the
reference encodes is encoded as it does (a user dict holding one of the
two new marker keys is escaped, as one holding the reference's own
markers is), so either package's client talks to either package's
server.
"""

from __future__ import annotations

import base64
import dataclasses
import enum
import json
from typing import Any, Dict

import numpy as np

from ..core.events import HistoryEvent, RetryPolicy

_REGISTRY: Dict[str, type] = {}


def register(cls: type) -> type:
    _REGISTRY[cls.__name__] = cls
    return cls


def _register_defaults() -> None:
    from ..matching.engine import PollRequest
    from ..ops.pack import PackResume, WorkflowSideTable
    from ..runtime import api as A
    from ..runtime.persistence import records as R
    from ..runtime.replication.messages import (
        HistoryTaskV2,
        ReplicationMessages,
    )
    from ..serving.engine import ResidentRead

    for cls in (
        HistoryTaskV2,
        ReplicationMessages,
        PollRequest,
        A.StartWorkflowRequest,
        A.SignalRequest,
        A.SignalWithStartRequest,
        A.Decision,
        A.PollForDecisionTaskResponse,
        A.PollForActivityTaskResponse,
        A.DescribeWorkflowResponse,
        R.DomainInfo,
        R.DomainConfig,
        R.DomainReplicationConfig,
        R.DomainRecord,
        R.VisibilityRecord,
        R.TaskListInfo,
        RetryPolicy,
        ResidentRead,
        WorkflowSideTable,
        PackResume,
    ):
        register(cls)


_MARKERS = ("__b", "__ev", "__t", "__dc", "__esc", "__s", "__nd", "__ik")


def encode(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, bytes):
        return {"__b": base64.b64encode(obj).decode()}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return {"__nd": [obj.dtype.str, list(obj.shape),
                         base64.b64encode(
                             np.ascontiguousarray(obj).tobytes()).decode()]}
    if isinstance(obj, HistoryEvent):
        return {"__ev": obj.to_dict()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        return {
            "__dc": name,
            "f": {
                fld.name: encode(getattr(obj, fld.name))
                for fld in dataclasses.fields(obj)
            },
        }
    if isinstance(obj, tuple):
        return {"__t": [encode(v) for v in obj]}
    if isinstance(obj, list):
        return [encode(v) for v in obj]
    if isinstance(obj, dict):
        if obj and all(type(k) is int for k in obj):
            return {"__ik": [[k, encode(v)] for k, v in obj.items()]}
        for k in obj:
            if not isinstance(k, str):
                # silent str() coercion would corrupt int-keyed maps on
                # round-trip (d[1] -> KeyError server-side); fail loud
                raise TypeError(
                    f"cannot encode dict key {k!r} "
                    f"({type(k).__name__}): wire dicts are str-keyed"
                )
        enc = {k: encode(v) for k, v in obj.items()}
        if any(k in enc for k in _MARKERS):
            # user payloads may legitimately carry marker-shaped keys
            return {"__esc": enc}
        return enc
    if isinstance(obj, (set, frozenset)):
        return {"__s": [encode(v) for v in sorted(obj)]}
    raise TypeError(f"cannot encode {type(obj).__name__}")


def decode(obj: Any) -> Any:
    if isinstance(obj, list):
        return [decode(v) for v in obj]
    if isinstance(obj, dict):
        if "__b" in obj and len(obj) == 1:
            return base64.b64decode(obj["__b"])
        if "__ev" in obj and len(obj) == 1:
            return HistoryEvent.from_dict(obj["__ev"])
        if "__t" in obj and len(obj) == 1:
            return tuple(decode(v) for v in obj["__t"])
        if "__s" in obj and len(obj) == 1:
            return set(decode(v) for v in obj["__s"])
        if "__esc" in obj and len(obj) == 1:
            return {k: decode(v) for k, v in obj["__esc"].items()}
        if "__nd" in obj and len(obj) == 1:
            dtype, shape, data = obj["__nd"]
            return np.frombuffer(
                base64.b64decode(data), dtype=np.dtype(dtype)
            ).reshape(shape).copy()
        if "__ik" in obj and len(obj) == 1:
            return {int(k): decode(v) for k, v in obj["__ik"]}
        if "__dc" in obj:
            if not _REGISTRY:
                _register_defaults()
            cls = _REGISTRY.get(obj["__dc"])
            if cls is None:
                raise TypeError(f"unknown wire type {obj['__dc']}")
            return cls(**{k: decode(v) for k, v in obj["f"].items()})
        return {k: decode(v) for k, v in obj.items()}
    return obj


def dumps(obj: Any) -> bytes:
    if not _REGISTRY:
        _register_defaults()
    return json.dumps(encode(obj)).encode()


def loads(raw: bytes) -> Any:
    if not _REGISTRY:
        _register_defaults()
    return decode(json.loads(raw.decode()))


# grpc-python treats a deserializer returning None as a deserialization
# FAILURE (grpc/_channel.py "Exception deserializing response!"), so
# void RPC results must ride in an envelope.


def dumps_enveloped(obj: Any) -> bytes:
    return dumps({"r": obj})


def loads_envelope(raw: bytes) -> Any:
    """Returns the ENVELOPE dict — the deserializer result itself must
    never be None (grpc reads that as failure); callers unwrap ["r"]."""
    return loads(raw)
