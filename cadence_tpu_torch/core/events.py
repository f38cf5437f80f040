"""History events: the durable record of every workflow state transition.

A ``HistoryEvent`` is the unit of the event-sourced log (reference model:
idl/github.com/uber/cadence/shared.thrift HistoryEvent + the per-type
*EventAttributes structs). Attributes are stored as a plain dict with
snake_case keys so that events serialize to JSON losslessly and pack into
dense tensors cheaply (ops/pack.py extracts the integer columns,
leaving payload bytes in a host-side side table — payloads never influence
transitions).

Timestamps are int nanoseconds (host precision); the device path quantizes
to seconds relative to a batch epoch during packing.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Optional

from .enums import EventType
from .ids import EMPTY_EVENT_TASK_ID


@dataclasses.dataclass
class HistoryEvent:
    event_id: int
    event_type: EventType
    version: int
    timestamp: int  # ns
    task_id: int = EMPTY_EVENT_TASK_ID
    attributes: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def get(self, key: str, default: Any = None) -> Any:
        return self.attributes.get(key, default)

    # -- serialization ----------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "event_id": self.event_id,
            "event_type": int(self.event_type),
            "version": self.version,
            "timestamp": self.timestamp,
            "task_id": self.task_id,
            "attributes": _jsonable(self.attributes),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "HistoryEvent":
        return cls(
            event_id=d["event_id"],
            event_type=EventType(d["event_type"]),
            version=d["version"],
            timestamp=d["timestamp"],
            task_id=d.get("task_id", EMPTY_EVENT_TASK_ID),
            attributes=_unjsonable(d.get("attributes", {})),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str) -> "HistoryEvent":
        return cls.from_dict(json.loads(s))


def _jsonable(obj: Any) -> Any:
    """Make attribute values JSON-safe (bytes → latin-1 tagged strings)."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, bytes):
        return {"__bytes__": obj.decode("latin-1")}
    return obj


def _unjsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        if set(obj.keys()) == {"__bytes__"}:
            return obj["__bytes__"].encode("latin-1")
        return {k: _unjsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unjsonable(v) for v in obj]
    return obj


def encode_batch(events: Iterable[HistoryEvent]) -> bytes:
    """Serialize an event batch (one history node) to bytes."""
    return json.dumps([e.to_dict() for e in events], separators=(",", ":")).encode()


def decode_batch(blob: bytes) -> List[HistoryEvent]:
    return [HistoryEvent.from_dict(d) for d in json.loads(blob.decode())]


@dataclasses.dataclass
class RetryPolicy:
    """Activity/workflow retry policy (reference: shared.thrift RetryPolicy)."""

    initial_interval_seconds: int = 0
    backoff_coefficient: float = 2.0
    maximum_interval_seconds: int = 0
    maximum_attempts: int = 0  # 0 == unlimited
    expiration_interval_seconds: int = 0
    non_retriable_error_reasons: List[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> Optional["RetryPolicy"]:
        if d is None:
            return None
        return cls(**d)


@dataclasses.dataclass
class WorkflowExecution:
    workflow_id: str
    run_id: str


@dataclasses.dataclass
class WorkflowType:
    name: str
