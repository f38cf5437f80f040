"""The durable checkpoint record.

One :class:`ReplayCheckpoint` = everything needed to resume a run's
replay from a transaction-batch boundary:

* the device **state row** (one workflow's slice of the replay carry,
  ``ops.schema.state_row`` form, timestamps relative to ``epoch_s``);
* the **pack resume** (slot tables + version/decision bookkeeping —
  ``ops.pack.PackResume``) so suffix packing assigns the same slots a
  full pack would;
* the **side table** accumulated over the prefix (strings the device
  never sees but rehydration needs);
* the **version-history items** at the snapshot, the NDC divergence
  stamp: a conflicting branch whose LCA with the snapshot's history
  falls before ``event_id`` must not resume from it;
* the **fingerprint** of the transition contract that produced the row.

Serialization reuses the persistence JSON codecs
(runtime/persistence/serde.py) — side tables carry bytes (memo /
search-attribute payloads) that plain ``json`` cannot round-trip.

A copy of the reference package's record: the same JSON layout. The
state row is numpy here, never a device tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..ops import schema as S
from ..ops.pack import PackResume, ResumeState, WorkflowSideTable
from ..runtime.persistence.serde import (
    snapshot_from_json,
    snapshot_to_json,
)


@dataclasses.dataclass
class ReplayCheckpoint:
    """A durable replay snapshot, keyed by ``(branch_key, event_id)``."""

    branch_key: str            # the branch token JSON (BranchToken form)
    tree_id: str               # the branch's history tree (GC/LCA scope)
    event_id: int              # last event covered by the snapshot
    fingerprint: str           # transition_fingerprint() at write time
    epoch_s: int               # epoch the state row's timestamps use
    caps: S.Capacities         # slot-table shape the row was built with
    vh_items: List[Tuple[int, int]]   # version history at the snapshot
    state_row: Dict[str, np.ndarray]  # ops.schema.state_row form
    resume: PackResume
    side: WorkflowSideTable
    domain_id: str = ""
    workflow_id: str = ""
    run_id: str = ""
    created_at: float = 0.0

    # -- serde ---------------------------------------------------------

    def to_json(self) -> str:
        # the side table's resume IS this record's resume (the packer
        # attaches it); strip the nested copy so the blob stores one
        # source of truth — from_json re-links it on load
        side_d = self.side.to_dict()
        side_d["resume"] = None
        return snapshot_to_json({
            "branch_key": self.branch_key,
            "tree_id": self.tree_id,
            "event_id": self.event_id,
            "fingerprint": self.fingerprint,
            "epoch_s": self.epoch_s,
            "caps": dataclasses.asdict(self.caps),
            "vh_items": [[e, v] for e, v in self.vh_items],
            "state_row": {
                k: np.asarray(v).tolist()
                for k, v in self.state_row.items()
            },
            "resume": self.resume.to_dict(),
            "side": side_d,
            "domain_id": self.domain_id,
            "workflow_id": self.workflow_id,
            "run_id": self.run_id,
            "created_at": self.created_at,
        })

    @classmethod
    def from_json(cls, s: str) -> "ReplayCheckpoint":
        d = snapshot_from_json(s)
        caps = S.Capacities(**{k: int(v) for k, v in d["caps"].items()})
        row = {
            k: np.asarray(v, dtype=np.int32)
            for k, v in d["state_row"].items()
        }
        if set(row) != set(S.STATE_ROW_FIELDS):
            raise ValueError(
                f"state row fields {sorted(row)} != schema fields"
            )
        resume = PackResume.from_dict(d["resume"])
        side = WorkflowSideTable.from_dict(d["side"])
        side.resume = resume  # stored once; re-linked on load
        return cls(
            branch_key=d["branch_key"],
            tree_id=d["tree_id"],
            event_id=int(d["event_id"]),
            fingerprint=d["fingerprint"],
            epoch_s=int(d["epoch_s"]),
            caps=caps,
            vh_items=[(int(e), int(v)) for e, v in d["vh_items"]],
            state_row=row,
            resume=resume,
            side=side,
            domain_id=d.get("domain_id", ""),
            workflow_id=d.get("workflow_id", ""),
            run_id=d.get("run_id", ""),
            created_at=float(d.get("created_at", 0.0)),
        )

    # -- conversions ---------------------------------------------------

    def resume_state(self) -> ResumeState:
        """The packer-facing resume bundle (side copied — packing must
        not mutate the stored record)."""
        return ResumeState(
            pack=self.resume,
            side=self.side.duplicate(),
            state_row={
                k: np.array(v, dtype=np.int32)
                for k, v in self.state_row.items()
            },
        )

    def state_tensors(self) -> S.StateTensors:
        """One-row StateTensors holding the snapshot carry (numpy)."""
        state = S.empty_state(1, self.caps)
        S.set_state_row(state, 0, self.state_row)
        return state
