"""Dense tensor layout for batched workflow-history replay.

The on-device ABI, copied from the reference package so both sides build
identical tensors: every workflow's mutable state is a fixed set of int32
tensors, every history event is one int32 row. Strings never influence
transitions — the packer (ops/pack.py) hashes the keyed ones to int31 and
keeps originals in host side tables; slot indices for pending-map entries
are precomputed host-side so the kernel does pure dense masked updates.

Timestamps on device are int32 **seconds** relative to the batch epoch.

``StateTensors`` holds numpy arrays on the host (packing, results) and
torch int32 tensors on a device; ``state_from_numpy`` / ``state_to_numpy``
carry state across, including state built by the reference package, so
both sides compute from identical inputs.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict

import numpy as np
import torch

from ..core.ids import EMPTY_EVENT_ID, EMPTY_VERSION, FIRST_EVENT_ID

# --------------------------------------------------------------------------
# Event row columns: events[B, T, EV_N]
# --------------------------------------------------------------------------
EV_TYPE = 0            # EventType, or -1 for padding
EV_ID = 1              # event_id
EV_VERSION = 2         # failover version
EV_TASK_ID = 3         # LastEventTaskID source
EV_TS = 4              # seconds
EV_BATCH_FIRST = 5     # first event_id of this event's transaction batch
EV_IS_BATCH_LAST = 6   # 1 if last event of its batch
EV_SLOT = 7            # precomputed pending-map slot this event touches, or -1
EV_A0 = 8              # per-type attributes (see pack.py for the mapping)
EV_A1 = 9
EV_A2 = 10
EV_A3 = 11
EV_A4 = 12
EV_A5 = 13
EV_A6 = 14
EV_A7 = 15
EV_N = 16

# --------------------------------------------------------------------------
# Execution-info columns: exec_info[B, X_N]
# --------------------------------------------------------------------------
X_STATE = 0
X_CLOSE_STATUS = 1
X_NEXT_EVENT_ID = 2
X_LAST_FIRST_EVENT_ID = 3
X_LAST_EVENT_TASK_ID = 4
X_LAST_PROCESSED_EVENT = 5
X_START_TS = 6
X_WORKFLOW_TIMEOUT = 7        # seconds
X_DECISION_TIMEOUT_VALUE = 8  # seconds
X_DEC_VERSION = 9
X_DEC_SCHEDULE_ID = 10
X_DEC_STARTED_ID = 11
X_DEC_TIMEOUT = 12            # seconds
X_DEC_ATTEMPT = 13
X_DEC_SCHEDULED_TS = 14
X_DEC_STARTED_TS = 15
X_DEC_ORIGINAL_SCHEDULED_TS = 16
X_CANCEL_REQUESTED = 17
X_SIGNAL_COUNT = 18
X_ATTEMPT = 19                # workflow retry attempt
X_HAS_RETRY_POLICY = 20
X_COMPLETION_EVENT_BATCH_ID = 21
X_PARENT_INITIATED_ID = 22
X_WF_EXPIRATION_TS = 23
X_CUR_VERSION = 24
X_N = 25

# --------------------------------------------------------------------------
# Pending-activity slot columns: activities[B, A, AC_N]
# --------------------------------------------------------------------------
AC_OCC = 0
AC_VERSION = 1
AC_SCHEDULE_ID = 2
AC_SCHEDULED_BATCH_ID = 3
AC_SCHEDULED_TS = 4
AC_STARTED_ID = 5
AC_STARTED_TS = 6
AC_ID_HASH = 7
AC_SCH_TO_START = 8
AC_SCH_TO_CLOSE = 9
AC_START_TO_CLOSE = 10
AC_HEARTBEAT = 11
AC_CANCEL_REQUESTED = 12
AC_CANCEL_REQUEST_ID = 13
AC_ATTEMPT = 14
AC_HAS_RETRY = 15
AC_EXPIRATION_TS = 16
AC_LAST_HB_TS = 17
AC_TIMER_STATUS = 18   # refreshed by ops/refresh.py, not tracked in-scan
AC_N = 19

# --------------------------------------------------------------------------
# Pending-timer slot columns: timers[B, TM, TI_N]
# --------------------------------------------------------------------------
TI_OCC = 0
TI_VERSION = 1
TI_STARTED_ID = 2
TI_ID_HASH = 3
TI_EXPIRY_TS = 4
TI_STATUS = 5          # refreshed by ops/refresh.py
TI_N = 6

# --------------------------------------------------------------------------
# Pending-child slot columns: children[B, C, CH_N]
# --------------------------------------------------------------------------
CH_OCC = 0
CH_VERSION = 1
CH_INITIATED_ID = 2
CH_INITIATED_BATCH_ID = 3
CH_STARTED_ID = 4
CH_WF_ID_HASH = 5
CH_RUN_ID_HASH = 6
CH_POLICY = 7
CH_N = 8

# --------------------------------------------------------------------------
# Pending external cancel/signal slot columns: [B, RC, RC_N] / [B, SG, SG_N]
# --------------------------------------------------------------------------
RC_OCC = 0
RC_VERSION = 1
RC_INITIATED_ID = 2
RC_INITIATED_BATCH_ID = 3
RC_N = 4

SG_OCC = 0
SG_VERSION = 1
SG_INITIATED_ID = 2
SG_INITIATED_BATCH_ID = 3
SG_N = 4


@dataclasses.dataclass(frozen=True)
class Capacities:
    """Slot-table sizes. Histories whose pending sets exceed these are
    rejected at pack time and routed to the host replay path (the
    overflow-to-host escape hatch, SURVEY.md §7 hard part (b))."""

    max_events: int = 1024        # T: scan length (padded)
    max_activities: int = 32      # A
    max_timers: int = 16          # TM
    max_children: int = 16        # C
    max_request_cancels: int = 8  # RC
    max_signals_ext: int = 8      # SG
    max_version_items: int = 8    # V: version-history items (NDC)


@dataclasses.dataclass
class StateTensors:
    """The batched mutable state. All arrays int32: numpy on the host,
    torch tensors on a device."""

    exec_info: Any      # [B, X_N]
    activities: Any     # [B, A, AC_N]
    timers: Any         # [B, TM, TI_N]
    children: Any       # [B, C, CH_N]
    cancels: Any        # [B, RC, RC_N]
    signals: Any        # [B, SG, SG_N]
    vh_items: Any       # [B, V, 2]  (event_id, version)
    vh_len: Any         # [B]

    @property
    def batch(self) -> int:
        return self.exec_info.shape[0]

    def map(self, fn) -> "StateTensors":
        """A new StateTensors with ``fn`` applied to every field."""
        return StateTensors(
            **{f: fn(getattr(self, f)) for f in STATE_ROW_FIELDS})


def resolve_device(device) -> torch.device:
    """The port's device rule: ``"cuda"`` (the default of every entry
    point) needs a CUDA device and raises without one; ``"cpu"`` runs the
    kernels' plain PyTorch versions."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def state_from_numpy(fields, device="cuda") -> StateTensors:
    """Carry state onto ``device`` as torch int32 tensors.

    ``fields``: any object with the eight StateTensors attributes (this
    package's, or the reference package's) or a mapping of them, holding
    numpy-convertible arrays."""
    dev = resolve_device(device)
    get = fields.__getitem__ if isinstance(fields, dict) else (
        lambda f: getattr(fields, f))
    return StateTensors(**{
        f: torch.from_numpy(
            np.ascontiguousarray(np.asarray(get(f)), dtype=np.int32)
        ).to(dev)
        for f in STATE_ROW_FIELDS
    })


def host_tensor(a) -> torch.Tensor:
    """A CPU tensor sharing ``a``'s memory (contiguous int arrays). The
    packer freezes its event tensors; readers here never write them."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(np.ascontiguousarray(a))


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def state_to_numpy(state) -> StateTensors:
    """Bring a StateTensors (torch on any device, or numpy) back to the
    host as numpy int32 arrays."""
    return StateTensors(**{
        f: np.asarray(_to_numpy(getattr(state, f)), dtype=np.int32)
        for f in STATE_ROW_FIELDS
    })


# --------------------------------------------------------------------------
# Per-history state rows (the checkpoint unit; the packer's resume path
# seeds segment carries from them). Timestamps inside a row are
# epoch-relative, so a row moved between batches with different epochs is
# shifted by ``rebase_state_row``.
# --------------------------------------------------------------------------

STATE_ROW_FIELDS = (
    "exec_info", "activities", "timers", "children", "cancels",
    "signals", "vh_items", "vh_len",
)

# epoch-relative timestamp positions per field: (column index gated on > 0)
ROW_TS_COLS = {
    "exec_info": (
        X_START_TS, X_DEC_SCHEDULED_TS, X_DEC_STARTED_TS,
        X_DEC_ORIGINAL_SCHEDULED_TS, X_WF_EXPIRATION_TS,
    ),
    "activities": (
        AC_SCHEDULED_TS, AC_STARTED_TS, AC_EXPIRATION_TS, AC_LAST_HB_TS,
    ),
    "timers": (TI_EXPIRY_TS,),
}


# --------------------------------------------------------------------------
# Per-column update algebra — the metadata the parallel-in-time replay
# (ops/assoc.py) and the ASSOC-UNPROVEN static-analysis rule share.
#
# Every kernel write to a state cell must compose associatively for the
# segmented-scan replay to be sound. Four algebras cover the transition
# surface:
#
#   set      x -> v            the mul=0 affine case (last-writer-wins;
#                              provenance resolution). The default.
#   counter  x -> x + d        the mul=1 affine case (prefix sums).
#   fsm      x -> f(x)         bounded function table closed under
#                              composition (X_STATE's Created->Running
#                              promotion; {identity, promote, const}).
#   rle      run-length        the version-history add_or_update: append
#                              on version change, recovered from a
#                              segmented prefix count of change flags.
#
# A column NOT listed here is "set". A new kernel transition that reads
# prior state in any other shape (cross-column arithmetic, data-
# dependent control) has no declared algebra — the analysis gate then
# reports ASSOC-UNPROVEN and the runtime classifier routes the type to
# the sequential fallback.
# --------------------------------------------------------------------------

UPDATE_ALGEBRA = {
    "exec:X_STATE": "fsm",
    "exec:X_SIGNAL_COUNT": "counter",
    "exec:X_DEC_ATTEMPT": "counter",
    "vh:event_id": "rle",
    "vh:version": "rle",
    "vh:len": "rle",
}

DEFAULT_ALGEBRA = "set"

ALGEBRAS = ("set", "counter", "fsm", "rle")


def update_algebra(label: str) -> str:
    """Composition algebra of one state-cell label (``exec:X_*``,
    ``vh:*``, or a slot-table label like ``activities:AC_*``)."""
    return UPDATE_ALGEBRA.get(label, DEFAULT_ALGEBRA)


# (prefix, count constant) per column table — the reflection surface
# shared with analysis/transition_surface.py
_COLUMN_GROUPS = (
    ("EV_", "EV_N"), ("X_", "X_N"), ("AC_", "AC_N"), ("TI_", "TI_N"),
    ("CH_", "CH_N"), ("RC_", "RC_N"), ("SG_", "SG_N"),
)


def validate(ns: Dict[str, Any] = None) -> None:
    """Assert column-constant density and uniqueness, and that every
    ROW_TS_COLS entry names a real column of its field.

    The cheapest invariant of the transition-surface checker
    (analysis/), also enforced at import time so a botched
    column renumber fails the FIRST import, not the next lint run. Cost
    is a few hundred dict lookups.
    """
    ns = ns if ns is not None else globals()
    for prefix, count_name in _COLUMN_GROUPS:
        n = ns[count_name]
        seen: Dict[int, str] = {}
        for k, v in ns.items():
            if not k.startswith(prefix) or k == count_name:
                continue
            if not isinstance(v, int) or isinstance(v, bool):
                continue
            if v in seen:
                raise AssertionError(
                    f"schema column collision: {seen[v]} and {k} both = {v}"
                )
            if not 0 <= v < n:
                raise AssertionError(
                    f"schema column {k} = {v} outside [0, {count_name}={n})"
                )
            seen[v] = k
        if len(seen) != n:
            missing = sorted(set(range(n)) - set(seen))
            raise AssertionError(
                f"schema columns not dense: {prefix}* has no constant for "
                f"value(s) {missing} under {count_name}={n}"
            )
    counts = {
        "exec_info": ns["X_N"], "activities": ns["AC_N"],
        "timers": ns["TI_N"], "children": ns["CH_N"],
        "cancels": ns["RC_N"], "signals": ns["SG_N"],
    }
    for field, cols in ns["ROW_TS_COLS"].items():
        for c in cols:
            if not 0 <= c < counts[field]:
                raise AssertionError(
                    f"ROW_TS_COLS[{field!r}] column {c} outside its table "
                    f"(N={counts[field]})"
                )
    for label, algebra in ns["UPDATE_ALGEBRA"].items():
        if algebra not in ns["ALGEBRAS"]:
            raise AssertionError(
                f"UPDATE_ALGEBRA[{label!r}] = {algebra!r} is not one of "
                f"{ns['ALGEBRAS']}"
            )
        kind, _, col = label.partition(":")
        if kind == "exec" and col not in ns:
            raise AssertionError(
                f"UPDATE_ALGEBRA names unknown exec column {col!r}"
            )


validate()


def state_row(state: StateTensors, b: int) -> Dict[str, Any]:
    """Copy workflow ``b``'s slice of a StateTensors batch to a row dict."""
    return {
        f: np.array(np.asarray(getattr(state, f))[b], dtype=np.int32)
        for f in STATE_ROW_FIELDS
    }


def set_state_row(state: StateTensors, b: int, row: Dict[str, Any]) -> None:
    """Write a row dict into slice ``b`` of a numpy StateTensors."""
    for f in STATE_ROW_FIELDS:
        np.asarray(getattr(state, f))[b] = row[f]


def rebase_state_row(row: Dict[str, Any], delta_s: int) -> Dict[str, Any]:
    """Shift every set (non-zero) epoch-relative timestamp by ``delta_s``
    seconds — moves a row from epoch e_old to e_new = e_old - delta_s.
    Returns a new row; the input is untouched."""
    out = {f: np.array(v, dtype=np.int32) for f, v in row.items()}
    if delta_s:
        for field, cols in ROW_TS_COLS.items():
            arr = out[field]
            for c in cols:
                col = arr[..., c]
                col[col > 0] += delta_s
    return out


def empty_state(batch: int, caps: Capacities) -> StateTensors:
    """Fresh (pre-start) state for `batch` workflows, numpy int32.

    Sentinel initialization mirrors a fresh mutableStateBuilder: decision
    IDs empty, versions empty.
    """
    ex = np.zeros((batch, X_N), dtype=np.int32)
    ex[:, X_NEXT_EVENT_ID] = FIRST_EVENT_ID
    ex[:, X_LAST_FIRST_EVENT_ID] = EMPTY_EVENT_ID
    ex[:, X_LAST_EVENT_TASK_ID] = EMPTY_EVENT_ID
    ex[:, X_LAST_PROCESSED_EVENT] = EMPTY_EVENT_ID
    ex[:, X_DEC_VERSION] = EMPTY_VERSION
    ex[:, X_DEC_SCHEDULE_ID] = EMPTY_EVENT_ID
    ex[:, X_DEC_STARTED_ID] = EMPTY_EVENT_ID
    ex[:, X_COMPLETION_EVENT_BATCH_ID] = EMPTY_EVENT_ID
    ex[:, X_PARENT_INITIATED_ID] = EMPTY_EVENT_ID
    ex[:, X_CUR_VERSION] = EMPTY_VERSION
    return StateTensors(
        exec_info=ex,
        activities=np.zeros((batch, caps.max_activities, AC_N), dtype=np.int32),
        timers=np.zeros((batch, caps.max_timers, TI_N), dtype=np.int32),
        children=np.zeros((batch, caps.max_children, CH_N), dtype=np.int32),
        cancels=np.zeros((batch, caps.max_request_cancels, RC_N), dtype=np.int32),
        signals=np.zeros((batch, caps.max_signals_ext, SG_N), dtype=np.int32),
        vh_items=np.zeros((batch, caps.max_version_items, 2), dtype=np.int32),
        vh_len=np.zeros((batch,), dtype=np.int32),
    )
