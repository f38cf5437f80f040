"""JSON codecs for snapshots that carry bytes.

A copy of the snapshot codecs of the reference package's
``runtime/persistence/serde.py``: bytes become ``{"__b": base64}``, sets
sorted lists, and a user dict that carries a marker key is escaped, so a
checkpoint's side table (memo and search-attribute payloads) round-trips.
"""

from __future__ import annotations

import base64
import json
from typing import Any, Dict


def _enc(obj: Any) -> Any:
    """Bytes-tolerant JSON projection (mutable-state snapshots carry
    branch tokens / payload bytes; sets become sorted lists, which
    MutableState.from_snapshot rebuilds)."""
    if isinstance(obj, bytes):
        return {"__b": base64.b64encode(obj).decode()}
    if isinstance(obj, dict):
        enc = {str(k): _enc(v) for k, v in obj.items()}
        if "__b" in enc or "__esc" in enc:
            # a user dict that happens to carry a marker key must not be
            # mistaken for an encoded value on the way back
            return {"__esc": enc}
        return enc
    if isinstance(obj, (list, tuple)):
        return [_enc(v) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return [_enc(v) for v in sorted(obj)]
    return obj


def _dec(obj: Any) -> Any:
    if isinstance(obj, dict):
        if "__b" in obj and len(obj) == 1:
            return base64.b64decode(obj["__b"])
        if "__esc" in obj and len(obj) == 1:
            return {k: _dec(v) for k, v in obj["__esc"].items()}
        return {k: _dec(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_dec(v) for v in obj]
    return obj


def snapshot_to_json(snapshot: Dict[str, Any]) -> str:
    return json.dumps(_enc(snapshot))


def snapshot_from_json(s: str) -> Dict[str, Any]:
    return _dec(json.loads(s))
