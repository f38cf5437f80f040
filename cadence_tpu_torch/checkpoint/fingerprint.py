"""Transition-function fingerprint for checkpoint invalidation.

A checkpointed carry is only resumable if the transition semantics that
produced it are the ones that will consume it. The fingerprint hashes the
bytes of every source that defines the port's replay contract: the tensor
schema (state layout), the packer (event-row encoding and slot
assignment), the replay facades, both kernels' wrappers and both CUDA
kernels. Any change to one of them flips the fingerprint, and every stored
checkpoint reads as stale (a full replay, never a silently wrong resume).

The sources are located relative to this package, by path: the CUDA
sources are not modules, so an import-system lookup cannot find them.
The port hashes its own contract, so its fingerprint differs from the
reference package's, and neither resumes the other's checkpoints.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Iterable, List

_PACKAGE = Path(__file__).resolve().parents[1]

# the replay-contract surface, relative to the package; order is part of
# the fingerprint
CONTRACT_SOURCES = (
    "ops/schema.py",
    "ops/pack.py",
    "ops/replay.py",
    "ops/replay_cuda.py",
    # the parallel-in-time replay consumes checkpoint rows as segment
    # base states: its semantics are part of the contract
    "ops/assoc.py",
    "ops/assoc_cuda.py",
    "ops/csrc/replay_fsm.cu",
    "ops/csrc/affine_segscan.cu",
)

_FINGERPRINT: str = ""


def contract_paths() -> List[Path]:
    """The files the fingerprint hashes, in order."""
    return [_PACKAGE / rel for rel in CONTRACT_SOURCES]


def fingerprint_of(paths: Iterable[Path]) -> str:
    """Hex digest (16 chars) of the files' bytes, in order."""
    h = hashlib.sha256()
    for path in paths:
        h.update(Path(path).read_bytes())
        h.update(b"\x00")
    return h.hexdigest()[:16]


def transition_fingerprint() -> str:
    """The fingerprint of the port's replay contract (computed once)."""
    global _FINGERPRINT
    if not _FINGERPRINT:
        _FINGERPRINT = fingerprint_of(contract_paths())
    return _FINGERPRINT
