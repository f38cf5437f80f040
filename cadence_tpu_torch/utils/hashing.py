"""Stable 32-bit string hashing (a copy of the reference package's).

The packer hashes string keys (activity IDs, timer IDs, child workflow and
run IDs) to int31 slot attributes, since on-device transitions never need
the string itself.
"""

from __future__ import annotations

_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619
_MASK32 = 0xFFFFFFFF


def fnv1a32(s: str) -> int:
    """FNV-1a over utf-8 bytes, full uint32 range."""
    h = _FNV_OFFSET
    for byte in s.encode("utf-8"):
        h ^= byte
        h = (h * _FNV_PRIME) & _MASK32
    return h


def hash31(s: str) -> int:
    """Non-negative int31 hash — safe to store in an int32 tensor."""
    return fnv1a32(s) & 0x7FFFFFFF


def shard_for_workflow(workflow_id: str, num_shards: int) -> int:
    """workflowID → shard (reference: common/util.go:249-251); the
    epoch-0 ``ShardMap`` routes the same way."""
    return fnv1a32(workflow_id) % num_shards
