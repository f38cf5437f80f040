"""Wire codec: JSON with dataclass/bytes/enum/tuple envelopes.

Replaces the reference's thrift envelope (common/codec/
version0Thriftrw.go): every API type crossing the host plane is a
registered dataclass; bytes are base64; enums are ints; tuples are
tagged so (events, token) responses round-trip.

A copy of the encoding half of the reference package's ``rpc/codec.py``
(``encode``, ``dumps``): the replication transport sizes every transfer
by it. Decoding, its type registry and the envelopes wait for the rpc
slice of the port.
"""

from __future__ import annotations

import base64
import dataclasses
import enum
import json
from typing import Any

from ..core.events import HistoryEvent


def encode(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, bytes):
        return {"__b": base64.b64encode(obj).decode()}
    if isinstance(obj, enum.Enum):
        return obj.value
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
        for k in obj:
            if not isinstance(k, str):
                # silent str() coercion would corrupt int-keyed maps on
                # round-trip (d[1] -> KeyError server-side); fail loud
                raise TypeError(
                    f"cannot encode dict key {k!r} "
                    f"({type(k).__name__}): wire dicts are str-keyed"
                )
        enc = {k: encode(v) for k, v in obj.items()}
        if any(k in enc for k in ("__b", "__ev", "__t", "__dc", "__esc",
                                  "__s")):
            # user payloads may legitimately carry marker-shaped keys
            return {"__esc": enc}
        return enc
    if isinstance(obj, (set, frozenset)):
        return {"__s": [encode(v) for v in sorted(obj)]}
    raise TypeError(f"cannot encode {type(obj).__name__}")


def dumps(obj: Any) -> bytes:
    return json.dumps(encode(obj)).encode()
