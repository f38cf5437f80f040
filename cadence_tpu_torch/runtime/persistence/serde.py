"""JSON serialization for snapshots and queue-task records (shared by
durable backends).

A copy of the reference package's ``runtime/persistence/serde.py``:
bytes become ``{"__b": base64}``, sets sorted lists, and a user dict that
carries a marker key is escaped, so a checkpoint's side table (memo and
search-attribute payloads) round-trips; the queue-task codecs write the
same JSON as the reference's, so one sqlite file serves both packages.
"""

from __future__ import annotations

import base64
import dataclasses
import json
from typing import Any, Dict

from ...core.enums import TimerTaskType, TransferTaskType
from ...core.tasks import ReplicationTask, TimerTask, TransferTask


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


def transfer_to_json(t: TransferTask) -> str:
    return json.dumps(dataclasses.asdict(t))


def transfer_from_json(s: str) -> TransferTask:
    d = json.loads(s)
    d["task_type"] = TransferTaskType(d["task_type"])
    return TransferTask(**d)


def timer_to_json(t: TimerTask) -> str:
    return json.dumps(dataclasses.asdict(t))


def timer_from_json(s: str) -> TimerTask:
    d = json.loads(s)
    d["task_type"] = TimerTaskType(d["task_type"])
    return TimerTask(**d)


def replication_to_json(t: ReplicationTask) -> str:
    d = dataclasses.asdict(t)
    d["branch_token"] = t.branch_token.decode("latin-1")
    d["new_run_branch_token"] = t.new_run_branch_token.decode("latin-1")
    return json.dumps(d)


def replication_from_json(s: str) -> ReplicationTask:
    d = json.loads(s)
    d["branch_token"] = d["branch_token"].encode("latin-1")
    d["new_run_branch_token"] = d["new_run_branch_token"].encode("latin-1")
    return ReplicationTask(**d)
