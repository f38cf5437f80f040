"""Pass 1 — transition-surface checker.

The FSM kernel (``ops/csrc/replay_fsm.cu``) and its plain PyTorch version
(``ops/replay_cuda._step_plain``) mirror the host oracle's event-type ×
state transition function. Fuzz differentials sample that surface; this
pass covers it:

* **Kernel matrix** — probed, not traced. The plain step is not
  specialised by type (it runs every block under a mask on ``EV_TYPE``),
  so a dispatch-level trace would show every label depending on every
  group. Instead one step runs per transition group on seeded states
  built to reach every branch the oracle has (empty, occupied and
  random tables; slots at -1, inside capacity and past it; a version
  equal to the last version-history item or new; a version history
  full and past capacity; a workflow in ``Created``) and on event rows
  of the group's types; the labels whose values change are the group's
  writes. A valid event of no group's type gives the common preamble.
  Each timestamp-bearing event column (``EV_TS`` and the ``EV_A{i}``
  the packer fills from ``rel_ts``) is then perturbed; the labels that
  follow are the epoch-bearing columns. The probe takes the
  implementation as an argument: ``replay_rows_plain`` on the CPU (the
  gate's ``--device cpu``), the CUDA kernel ``replay_rows`` (the gate's
  default ``--device cuda``) on int32 events and on the int16 narrow
  stream, ``replay_rows_packed`` with one segment a
  lane, or the parallel-in-time ``replay_assoc``. Probing sees only
  writes that change a value; the CPU tests hold the probed matrix
  against the reference package's traced one label for label.
* **Oracle table** — AST extraction (oracle_ast.py) of
  ``StateBuilder.apply_events``'s dispatch chain and the
  ``MutableState.replicate_*`` write sets, mapped onto schema columns.
* **Diff** — unhandled-by-kernel event types, dead transition blocks,
  per-group column/table writes outside the oracle's mask (and oracle
  writes the kernel misses).
* **Schema invariants** — column constants dense + unique per table,
  pack.py ``attrs[i]`` stores inside the EV_A window, and
  ``ROW_TS_COLS`` (the epoch-rebase set ``rebase_state_row`` shifts)
  exactly equal to the probed set of epoch-bearing columns.

A copy of the reference package's ``analysis/transition_surface.py``,
pointed at the port's sources, with the kernel matrix probed instead of
traced from a jaxpr.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .findings import Finding
from . import oracle_ast

# --------------------------------------------------------------------------
# Schema column-group reflection
# --------------------------------------------------------------------------

# (prefix, count constant) per column table — schema.py owns the tuple
# so a new table added there is automatically covered by this pass
from ..ops.schema import _COLUMN_GROUPS as COLUMN_GROUPS  # noqa: E402


def _schema_ns() -> dict:
    from ..ops import schema as S

    return vars(S)


def column_names(
    prefix: str, count_name: str, ns: Optional[dict] = None
) -> Dict[int, List[str]]:
    """{column value → constant names} for one prefix (a well-formed
    table has exactly one name per value 0..N-1)."""
    ns = ns if ns is not None else _schema_ns()
    out: Dict[int, List[str]] = {}
    for k, v in ns.items():
        if (
            k.startswith(prefix)
            and k != count_name
            and isinstance(v, int)
            and not isinstance(v, bool)
        ):
            out.setdefault(v, []).append(k)
    for names in out.values():
        names.sort()
    return out


def check_column_groups(ns: Optional[dict] = None) -> List[Finding]:
    """Density + uniqueness of the schema column constants."""
    ns = ns if ns is not None else _schema_ns()
    findings: List[Finding] = []
    for prefix, count_name in COLUMN_GROUPS:
        if count_name not in ns:
            findings.append(Finding(
                "SCHEMA-COLUMNS", f"schema:{prefix}",
                f"missing count constant {count_name}",
            ))
            continue
        n = ns[count_name]
        by_val = column_names(prefix, count_name, ns)
        for v, names in sorted(by_val.items()):
            if len(names) > 1:
                findings.append(Finding(
                    "SCHEMA-COLUMNS", f"schema:{prefix}{v}:dup",
                    f"column value {v} claimed by {', '.join(names)}",
                ))
            if not (0 <= v < n):
                findings.append(Finding(
                    "SCHEMA-COLUMNS", f"schema:{prefix}{v}:range",
                    f"{names[0]} = {v} outside [0, {count_name}={n})",
                ))
        missing = sorted(set(range(n)) - set(by_val))
        if missing:
            findings.append(Finding(
                "SCHEMA-COLUMNS", f"schema:{prefix}:dense",
                f"no constant for column value(s) {missing} "
                f"(table not dense under {count_name}={n})",
            ))
    return findings


def check_pack_attrs(pack_source: str, ns: Optional[dict] = None) -> List[Finding]:
    """Every ``attrs[i]`` store in pack_workflow must land inside the
    EV_A0..EV_A(window-1) event-row window."""
    ns = ns if ns is not None else _schema_ns()
    window = ns["EV_N"] - ns["EV_A0"]
    findings: List[Finding] = []
    for i in sorted(oracle_ast.extract_attr_indices(pack_source)):
        if not (0 <= i < window):
            findings.append(Finding(
                "SCHEMA-PACK-ATTR", f"pack:attrs[{i}]",
                f"pack_workflow stores attrs[{i}] but the event row has "
                f"only {window} attribute columns (EV_A0..EV_A{window - 1})",
            ))
    return findings


# --------------------------------------------------------------------------
# Kernel matrix: one probed step per transition group
# --------------------------------------------------------------------------

# the probe's table sizes: every table holds at least two slots, so a
# slot inside capacity, the last one and one past it are all reachable
PROBE_CAPS = dict(
    max_events=8, max_activities=3, max_timers=2, max_children=2,
    max_request_cancels=2, max_signals_ext=2, max_version_items=2,
)
PROBE_SEED = 20240601
# what a timestamp-bearing event column is shifted by to see which state
# labels follow it
TS_DELTA = 7919

_TABLES = (
    # (label head, row-offset attribute of RowMap, caps field, prefix, N)
    ("activities", "act0", "max_activities", "AC_", "AC_N"),
    ("timers", "tim0", "max_timers", "TI_", "TI_N"),
    ("children", "chd0", "max_children", "CH_", "CH_N"),
    ("cancels", "rc0", "max_request_cancels", "RC_", "RC_N"),
    ("signals", "sg0", "max_signals_ext", "SG_", "SG_N"),
)


def probe_caps():
    from ..ops import schema as S

    return S.Capacities(**PROBE_CAPS)


def row_labels(caps) -> List[Optional[str]]:
    """The state label of each row of the kernel's ``[R_pad, B]`` matrix
    (``ops/replay_cuda.RowMap``), in the reference's label names; None
    for the padding rows."""
    from ..ops.replay_cuda import RowMap

    ns = _schema_ns()
    rm = RowMap(caps)
    out: List[Optional[str]] = [None] * rm.rows_padded

    def names(prefix: str, count: str) -> List[str]:
        by_val = column_names(prefix, count, ns)
        return [by_val[i][0] for i in range(ns[count])]

    for c, n in enumerate(names("X_", "X_N")):
        out[rm.exec0 + c] = f"exec:{n}"
    for i in range(caps.max_version_items):
        out[rm.vh0 + 2 * i] = "vh:event_id"
        out[rm.vh0 + 2 * i + 1] = "vh:version"
    out[rm.vhlen] = "vh:len"
    for head, r0, cap_field, prefix, count in _TABLES:
        cols = names(prefix, count)
        base = getattr(rm, r0)
        for s in range(getattr(caps, cap_field)):
            for c, n in enumerate(cols):
                out[base + s * len(cols) + c] = f"{head}:{n}"
    return out


def _probe_states(caps, rng) -> List[dict]:
    """Seeded single-lane states that reach every branch of the step:
    the empty state, and random states (every cell random, so a write of
    any value is seen) with the version history empty, part full, full
    and past capacity, and the workflow in ``Created``."""
    from ..core.enums import WorkflowState
    from ..ops import schema as S

    empty = S.empty_state(1, caps)
    out = [{f: np.asarray(getattr(empty, f))[0].copy()
            for f in S.STATE_ROW_FIELDS}]
    cap_v = caps.max_version_items
    vh_lens = (0, 1, cap_v, cap_v + 3, 1, cap_v)
    for k, vh_len in enumerate(vh_lens):
        st = {}
        for f in S.STATE_ROW_FIELDS:
            shape = np.asarray(getattr(empty, f)).shape[1:]
            st[f] = rng.integers(1, 1 << 30, size=shape, dtype=np.int64
                                 ).astype(np.int32)
        st["vh_len"] = np.int32(vh_len)
        if k % 3 == 1:
            st["exec_info"][S.X_STATE] = int(WorkflowState.Created)
        out.append(st)
    return out


def _last_vh_version(st: dict, cap_v: int) -> int:
    """The version the step compares an event's against: the last
    materialized item's, read at a clamped index."""
    if not cap_v:
        return 0
    idx = min(max(int(st["vh_len"]) - 1, 0), cap_v - 1)
    return int(st["vh_items"][idx, 1])


def probe_inputs(types: Sequence[int], caps, seed: int = PROBE_SEED):
    """The probe of one type set: (events [1, EV_N, B] int32, rows
    [R_pad, B] int32). Lanes are every combination of a probe state, a
    member type, a slot (-1, each slot of the widest table, one past
    it), a version (the last version-history item's, or new) and
    attributes (random int31, or small values 0-3 that reach the
    attribute-dependent branches)."""
    from ..ops import schema as S
    from ..ops.replay_cuda import RowMap, state_to_rows

    rng = np.random.default_rng(seed)
    states = _probe_states(caps, rng)
    widest = max(getattr(caps, t[2]) for t in _TABLES)
    slots = list(range(-1, widest + 1))
    lanes = []
    for st in states:
        for t in types:
            for slot in slots:
                for same in (True, False):
                    for small in (False, True):
                        lanes.append((st, int(t), slot, same, small))
    b = len(lanes)
    ev = rng.integers(1, 1 << 30, size=(S.EV_N, b), dtype=np.int64
                      ).astype(np.int32)
    state = S.empty_state(b, caps)
    for i, (st, t, slot, same, small) in enumerate(lanes):
        for f in S.STATE_ROW_FIELDS:
            np.asarray(getattr(state, f))[i] = st[f]
        ev[S.EV_TYPE, i] = t
        ev[S.EV_SLOT, i] = slot
        if same:
            ev[S.EV_VERSION, i] = _last_vh_version(
                st, caps.max_version_items)
        if small:
            ev[S.EV_A0:, i] = rng.integers(0, 4, size=S.EV_N - S.EV_A0)
    rows = state_to_rows(S.state_from_numpy(state, "cpu"), RowMap(caps))
    return ev[None], rows.numpy()


# An implementation of one probed step: (events [T, EV_N, B] int32,
# rows [R_pad, B] int32, caps) -> rows after the steps, all numpy.
ProbeImpl = Callable[[np.ndarray, np.ndarray, object], np.ndarray]

IMPLS = ("replay_rows_plain", "replay_rows", "replay_rows[int16]",
         "replay_rows_packed", "replay_assoc[segscan]")


def probe_impl(name: str = "replay_rows_plain",
               device="cpu") -> ProbeImpl:
    """The named implementation of a probed step on ``device``:

    * ``replay_rows_plain`` — the plain PyTorch step (CPU tensors);
    * ``replay_rows`` — the kernel wrapper on int32 events (on a CUDA
      device it launches ``replay_fsm.cu``, on the CPU it runs the plain
      step);
    * ``replay_rows[int16]`` — the same on the int16 narrow stream, with
      its affine ``base`` and ``wide_cols``;
    * ``replay_rows_packed`` — the packed route with one segment a lane
      ending on the last step, read from its flushed output rows;
    * ``replay_assoc[segscan]`` — the parallel-in-time replay, whose exec
      columns run the segmented affine scan (``affine_segscan.cu`` on a
      CUDA device)."""
    import torch

    from ..ops import replay_cuda as RC
    from ..ops import schema as S

    dev = S.resolve_device(device)

    def to_dev(a: np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def host(t) -> np.ndarray:
        return t.detach().cpu().numpy()

    if name == "replay_rows_plain":
        if dev.type != "cpu":
            raise ValueError("replay_rows_plain runs on the CPU")

        def run(ev, rows, caps):
            return host(RC.replay_rows_plain(to_dev(ev), to_dev(rows), caps))
    elif name == "replay_rows":
        def run(ev, rows, caps):
            return host(RC.replay_rows(to_dev(ev), to_dev(rows), caps))
    elif name == "replay_rows[int16]":
        def run(ev, rows, caps):
            narrowed = RC.narrow_events_teb(ev, force_wide=())
            if narrowed is None:
                raise ValueError("the probe's events do not narrow")
            ev16, base, wide = narrowed
            return host(RC.replay_rows(to_dev(ev16), to_dev(rows), caps,
                                       base=base, wide_cols=wide))
    elif name == "replay_rows_packed":
        def run(ev, rows, caps):
            t, _, lanes = ev.shape
            seg_end = np.zeros((lanes, t), bool)
            seg_end[:, t - 1] = True
            out_row = np.zeros((lanes, t), np.int32)
            out_row[:, t - 1] = np.arange(lanes)
            ptr, ends = RC.segment_list(seg_end, out_row)
            init = np.zeros((rows.shape[0], 1), np.int32)
            _, out = RC.replay_rows_packed(
                to_dev(ev), to_dev(rows), caps, to_dev(ptr), to_dev(ends),
                to_dev(np.zeros_like(rows)), to_dev(init))
            return host(out)
    elif name == "replay_assoc[segscan]":
        from ..ops.assoc import replay_assoc

        def run(ev, rows, caps):
            rm = RC.RowMap(caps)
            state = RC.rows_to_state(torch.from_numpy(rows), rm)
            out = replay_assoc(state, ev.transpose(0, 2, 1), impl="segscan",
                               device=dev)
            return host(RC.state_to_rows(out, rm))
    else:
        raise ValueError(f"unknown probe implementation {name!r} "
                         f"(have: {IMPLS})")
    return run


def _changed(before: np.ndarray, after: np.ndarray,
             labels: Sequence[Optional[str]]) -> Set[str]:
    rows = np.nonzero((before != after).any(axis=1))[0]
    return {labels[r] for r in rows if labels[r] is not None}


def _ev_label_col(label: str) -> int:
    """Event column of an ``ev:EV_*`` label."""
    return int(_schema_ns()[label.split(":", 1)[1]])


@dataclasses.dataclass
class ProbeRun:
    """One implementation's probes: the matrix and every output, keyed
    ``(group key, variant)`` — the group key ``"common"`` or the group's
    sorted types, the variant ``"base"`` or the perturbed ``ev:`` label."""

    matrix: "KernelMatrix"
    outputs: Dict[Tuple[object, str], np.ndarray]


def _probe_group(run: ProbeImpl, types, ts_in: Set[str], caps, labels,
                 outputs: dict, key) -> Tuple[Set[str], Set[str]]:
    """(changed labels, labels that follow a timestamp input) of one
    type set."""
    ev, rows = probe_inputs(types, caps)
    out = run(ev, rows, caps)
    outputs[(key, "base")] = out
    written = _changed(rows, out, labels)
    ts_cols: Set[str] = set()
    for lab in sorted(ts_in):
        shifted = ev.copy()
        shifted[:, _ev_label_col(lab)] += TS_DELTA
        out_ts = run(shifted, rows, caps)
        outputs[(key, lab)] = out_ts
        ts_cols |= _changed(out, out_ts, labels)
    return written, ts_cols


def _common_types() -> Tuple[int, ...]:
    """Valid event types of no transition group: each runs the preamble
    alone."""
    from ..core.enums import EventType
    from ..ops.replay import TYPE_GROUPS

    grouped = {int(t) for g in TYPE_GROUPS for t in g}
    return tuple(int(t) for t in EventType if int(t) not in grouped)


def probe(
    impl: str = "replay_rows_plain",
    device="cpu",
    rel_ts_attrs: Optional[Dict[str, Set[int]]] = None,
    groups: Optional[Sequence[Sequence[int]]] = None,
) -> ProbeRun:
    """Probe the preamble (every valid type of no group) and every
    transition group (or ``groups``) through ``impl``, a name of
    ``IMPLS``; ``rel_ts_attrs`` comes from
    oracle_ast.extract_rel_ts_attrs over ops/pack.py (empty: only EV_TS
    counts as timestamp-bearing)."""
    from ..ops.replay import TYPE_GROUPS

    run = probe_impl(impl, device)
    rel_ts_attrs = rel_ts_attrs or {}
    caps = probe_caps()
    labels = row_labels(caps)
    outputs: Dict[Tuple[object, str], np.ndarray] = {}
    common, common_ts = _probe_group(
        run, _common_types(), _ts_inputs_for([], rel_ts_attrs), caps,
        labels, outputs, "common")
    out_groups: List[GroupTrace] = []
    for g in (TYPE_GROUPS if groups is None else groups):
        types = tuple(sorted(int(t) for t in g))
        written, ts_cols = _probe_group(
            run, types, _ts_inputs_for(types, rel_ts_attrs), caps, labels,
            outputs, types)
        out_groups.append(GroupTrace(
            types=types,
            written=written - common,
            ts_cols=ts_cols - common,
        ))
    return ProbeRun(
        matrix=KernelMatrix(common=common, common_ts=common_ts,
                            groups=out_groups),
        outputs=outputs)


@dataclasses.dataclass
class GroupTrace:
    types: Tuple[int, ...]           # event types gating the block
    written: Set[str]                # state labels written (beyond common)
    ts_cols: Set[str]                # labels whose value derives from a
                                     # timestamp-bearing event column


@dataclasses.dataclass
class KernelMatrix:
    common: Set[str]                 # preamble writes (every valid event)
    common_ts: Set[str]
    groups: List[GroupTrace]

    def handled_types(self) -> Set[int]:
        out: Set[int] = set()
        for g in self.groups:
            out.update(g.types)
        return out

    def ts_columns(self) -> Set[str]:
        out = set(self.common_ts)
        for g in self.groups:
            out.update(g.ts_cols)
        return out


def _ts_inputs_for(
    types: Sequence[int], rel_ts_attrs: Dict[str, Set[int]]
) -> Set[str]:
    """Event-column labels carrying epoch-relative timestamps for this
    group: EV_TS always, plus every EV_A{i} the packer fills from
    rel_ts() for a member type."""
    from ..core.enums import EventType

    out = {"ev:EV_TS"}
    for t in types:
        for i in rel_ts_attrs.get(EventType(t).name, ()):
            out.add(f"ev:EV_A{i}")
    return out


def kernel_matrix(
    rel_ts_attrs: Optional[Dict[str, Set[int]]] = None,
    impl: str = "replay_rows_plain",
    device="cpu",
) -> KernelMatrix:
    """Probe every transition group through ``impl`` (the plain step on
    the CPU by default); ``rel_ts_attrs`` as for :func:`probe`."""
    return probe(impl, device, rel_ts_attrs).matrix


def kernel_handled_types() -> Set[int]:
    """Event types with a transition block in the kernel — no probe
    needed, the group table is the source of truth."""
    from ..ops.replay import TYPE_GROUPS

    return {int(t) for g in TYPE_GROUPS for t in g}


# --------------------------------------------------------------------------
# Oracle table → schema columns
# --------------------------------------------------------------------------

# MutableState.execution_info field → kernel exec column label.
EXEC_FIELD_TO_COL = {
    "state": "exec:X_STATE",
    "close_status": "exec:X_CLOSE_STATUS",
    "next_event_id": "exec:X_NEXT_EVENT_ID",
    "last_first_event_id": "exec:X_LAST_FIRST_EVENT_ID",
    "last_event_task_id": "exec:X_LAST_EVENT_TASK_ID",
    "last_processed_event": "exec:X_LAST_PROCESSED_EVENT",
    "start_timestamp": "exec:X_START_TS",
    "workflow_timeout": "exec:X_WORKFLOW_TIMEOUT",
    "decision_timeout_value": "exec:X_DECISION_TIMEOUT_VALUE",
    "decision_version": "exec:X_DEC_VERSION",
    "decision_schedule_id": "exec:X_DEC_SCHEDULE_ID",
    "decision_started_id": "exec:X_DEC_STARTED_ID",
    "decision_timeout": "exec:X_DEC_TIMEOUT",
    "decision_attempt": "exec:X_DEC_ATTEMPT",
    "decision_scheduled_timestamp": "exec:X_DEC_SCHEDULED_TS",
    "decision_started_timestamp": "exec:X_DEC_STARTED_TS",
    "decision_original_scheduled_timestamp":
        "exec:X_DEC_ORIGINAL_SCHEDULED_TS",
    "cancel_requested": "exec:X_CANCEL_REQUESTED",
    "signal_count": "exec:X_SIGNAL_COUNT",
    "attempt": "exec:X_ATTEMPT",
    "has_retry_policy": "exec:X_HAS_RETRY_POLICY",
    "completion_event_batch_id": "exec:X_COMPLETION_EVENT_BATCH_ID",
    "initiated_id": "exec:X_PARENT_INITIATED_ID",
    "expiration_time": "exec:X_WF_EXPIRATION_TS",
}

# Host-only execution_info fields: strings, payloads, client metadata,
# retry-policy details kept host-side, persistence bookkeeping. Writes
# here have no device column, by design (the side table carries them).
EXEC_FIELD_IGNORE = {
    "domain_id", "workflow_id", "run_id", "parent_domain_id",
    "parent_workflow_id", "parent_run_id", "task_list",
    "workflow_type_name", "execution_context", "last_updated_timestamp",
    "create_request_id", "decision_request_id", "cancel_request_id",
    "sticky_task_list", "sticky_schedule_to_start_timeout",
    "client_library_version", "client_feature_version", "client_impl",
    "auto_reset_points", "memo", "search_attributes",
    "initial_interval", "backoff_coefficient", "maximum_interval",
    "maximum_attempts", "non_retriable_errors", "branch_token",
    "cron_schedule", "expiration_seconds",
    "first_decision_backoff_deadline", "history_size",
}


@dataclasses.dataclass
class OracleEntry:
    handlers: Tuple[str, ...]
    is_noop: bool
    tables: Set[str]          # pending-map tables touched
    exec_cols: Set[str]       # mapped exec column labels
    unmapped_fields: Set[str]  # exec fields neither mapped nor ignored

    def device_writes(self) -> Set[str]:
        return set(self.exec_cols) | set(self.tables)


def oracle_table(
    state_builder_source: str, mutable_state_source: str
) -> Dict[str, OracleEntry]:
    """{EventType name → oracle write surface in schema terms}."""
    dispatch = oracle_ast.extract_event_dispatch(state_builder_source)
    writes = oracle_ast.extract_replicate_writes(mutable_state_source)
    out: Dict[str, OracleEntry] = {}
    for tname, branch in dispatch.items():
        tables: Set[str] = set()
        exec_cols: Set[str] = set()
        unmapped: Set[str] = set()
        for h in branch.handler_calls:
            ws = writes.get(h)
            if ws is None:
                continue
            tables |= ws.tables
            for f in ws.exec_fields:
                if f in EXEC_FIELD_TO_COL:
                    exec_cols.add(EXEC_FIELD_TO_COL[f])
                elif f not in EXEC_FIELD_IGNORE:
                    unmapped.add(f)
        out[tname] = OracleEntry(
            handlers=branch.handler_calls,
            is_noop=branch.is_noop,
            tables=tables,
            exec_cols=exec_cols,
            unmapped_fields=unmapped,
        )
    return out


def _split_kernel_writes(written: Set[str]) -> Tuple[Set[str], Set[str]]:
    """(exec column labels, pending-map tables) of a kernel write set.
    Slot tables are compared at table granularity: the kernel writes
    whole rows under one-hot masks, the oracle mutates map entries —
    per-field comparison across that boundary would only mirror the
    kernel back at itself."""
    exec_cols = {w for w in written if w.startswith("exec:")}
    tables = {
        w.split(":", 1)[0]
        for w in written
        if w.split(":", 1)[0] in (
            "activities", "timers", "children", "cancels", "signals"
        )
    }
    return exec_cols, tables


def diff_surface(
    kmat: KernelMatrix,
    otable: Dict[str, OracleEntry],
    pack_handled: Optional[Set[str]] = None,
) -> List[Finding]:
    """Diff the kernel matrix against the oracle table."""
    from ..core.enums import EventType

    findings: List[Finding] = []
    handled = kmat.handled_types()
    handled_names = {EventType(t).name for t in handled}

    # oracle handlers without unmapped-field contract coverage
    for tname, entry in sorted(otable.items()):
        if entry.unmapped_fields:
            findings.append(Finding(
                "SURFACE-UNMAPPED-FIELD", f"surface:{tname}:unmapped",
                f"oracle handler(s) {', '.join(entry.handlers)} write "
                f"execution_info fields {sorted(entry.unmapped_fields)} "
                "that are neither mapped to a device column nor in the "
                "host-only ignore set — extend "
                "analysis.transition_surface.EXEC_FIELD_TO_COL",
            ))

    # unhandled-by-kernel: the oracle mutates device-mapped state for a
    # type the kernel has no transition block for
    for tname, entry in sorted(otable.items()):
        if tname in handled_names:
            continue
        if entry.device_writes():
            findings.append(Finding(
                "SURFACE-UNHANDLED", f"surface:{tname}:unhandled",
                f"event type {tname} writes {sorted(entry.device_writes())} "
                "in the host oracle but has no kernel transition block",
            ))

    # dead transition blocks: kernel block for a type the oracle
    # dispatch chain does not even accept
    for t in sorted(handled):
        tname = EventType(t).name
        if tname not in otable:
            findings.append(Finding(
                "SURFACE-DEAD-BLOCK", f"surface:{tname}:dead",
                f"kernel has a transition block for {tname} but the "
                "oracle dispatch chain does not handle it",
            ))

    # pack-layer coverage: every oracle-handled type must be packable
    if pack_handled is not None:
        for tname in sorted(otable):
            if tname not in pack_handled:
                findings.append(Finding(
                    "SURFACE-PACK-UNKNOWN", f"surface:{tname}:pack",
                    f"oracle handles {tname} but pack_workflow's dispatch "
                    "chain would reject it (PackError: unknown event type)",
                ))

    # per-group mask diff
    for g in kmat.groups:
        names = sorted(EventType(t).name for t in g.types)
        anchor_base = f"surface:{names[0]}"
        k_exec, k_tables = _split_kernel_writes(g.written)
        o_exec: Set[str] = set()
        o_tables: Set[str] = set()
        for t in g.types:
            entry = otable.get(EventType(t).name)
            if entry is None:
                continue
            o_exec |= entry.exec_cols
            o_tables |= entry.tables
        # columns in the kernel's common preamble (written for EVERY
        # valid event) can never be "missing" from a group
        common_exec, common_tables = _split_kernel_writes(kmat.common)
        extra = sorted((k_exec - o_exec) | (k_tables - o_tables))
        missing = sorted(
            (o_exec - k_exec - common_exec)
            | (o_tables - k_tables - common_tables)
        )
        if extra:
            findings.append(Finding(
                "SURFACE-EXTRA-WRITE", f"{anchor_base}:extra",
                f"kernel group {names} writes {extra} which the oracle "
                "handlers never touch (write outside the type's mask)",
            ))
        if missing:
            findings.append(Finding(
                "SURFACE-MISSING-WRITE", f"{anchor_base}:missing",
                f"oracle handlers for {names} write {missing} which the "
                "kernel group never writes",
            ))
    return findings


def _assoc_write_names(written: Set[str]) -> Set[str]:
    """Kernel write labels → the names ASSOC_COVERAGE declares: exec
    and vh labels stay per-column, slot tables collapse to table names
    (the emission derives whole-row masked writes per table)."""
    out: Set[str] = set()
    for w in written:
        head = w.split(":", 1)[0]
        if head in ("activities", "timers", "children", "cancels",
                    "signals"):
            out.add(head)
        else:
            out.add(w)
    return out


def check_assoc_coverage(kmat: KernelMatrix) -> List[Finding]:
    """ASSOC-UNPROVEN — prove the affine decomposition covers the probed
    write matrix.

    The parallel-in-time replay (ops/assoc.py) re-derives every kernel
    transition as a composable update; its declared coverage
    (``ASSOC_COVERAGE`` + ``ASSOC_COMMON``) is diffed here against the
    *probed* writes of the FSM step. A new transition block (or a
    new column in an existing block) that the emission does not cover
    fails CI instead of silently diverging between the sequential and
    associative kernels; the runtime classifier additionally routes any
    type outside ``assoc_types()`` to the sequential fallback. Stale
    ``schema.UPDATE_ALGEBRA`` entries (naming cells no emission covers)
    are flagged too.
    """
    from ..core.enums import EventType
    from ..ops import schema as S
    from ..ops.assoc import (
        ASSOC_COMMON, ASSOC_COVERAGE, assoc_types,
    )

    findings: List[Finding] = []
    provable = assoc_types()

    common = _assoc_write_names(kmat.common)
    miss = sorted(common - ASSOC_COMMON)
    if miss:
        findings.append(Finding(
            "ASSOC-UNPROVEN", "assoc:common",
            f"the kernel preamble writes {miss} which the affine "
            "decomposition's common coverage (ops/assoc.py ASSOC_COMMON)"
            " does not declare — replay_assoc would silently diverge",
        ))

    declared: Set[str] = set(ASSOC_COMMON)
    for g in kmat.groups:
        names = sorted(EventType(t).name for t in g.types)
        key = tuple(sorted(int(t) for t in g.types))
        cov = ASSOC_COVERAGE.get(key)
        bad_types = sorted(
            EventType(t).name for t in g.types if int(t) not in provable
        )
        if bad_types:
            findings.append(Finding(
                "ASSOC-UNPROVEN", f"assoc:{names[0]}:types",
                f"event type(s) {bad_types} have a kernel transition "
                "block but are outside assoc_types() — the associative "
                "path would mis-classify them as no-ops",
            ))
        if cov is None:
            findings.append(Finding(
                "ASSOC-UNPROVEN", f"assoc:{names[0]}:group",
                f"kernel transition group {names} has no declared "
                "affine coverage (ops/assoc.py ASSOC_COVERAGE) — its "
                "writes are unproven for the associative path",
            ))
            continue
        declared |= cov
        miss = sorted(_assoc_write_names(g.written) - cov - ASSOC_COMMON)
        if miss:
            findings.append(Finding(
                "ASSOC-UNPROVEN", f"assoc:{names[0]}:writes",
                f"kernel group {names} writes {miss} which its declared "
                "affine coverage does not include — extend the "
                "ops/assoc.py emission (and ASSOC_COVERAGE) or route "
                "the type to the sequential fallback",
            ))

    for label in sorted(S.UPDATE_ALGEBRA):
        if label not in declared:
            findings.append(Finding(
                "ASSOC-UNPROVEN", f"assoc:algebra:{label}",
                f"schema.UPDATE_ALGEBRA declares {label!r} "
                f"({S.UPDATE_ALGEBRA[label]}) but no transition group's "
                "assoc coverage writes it — stale metadata",
            ))
    return findings


def check_ts_coverage(
    kmat: KernelMatrix, ns: Optional[dict] = None
) -> List[Finding]:
    """ROW_TS_COLS (what rebase_state_row shifts between epochs) must
    equal the probed set of epoch-bearing state columns."""
    ns = ns if ns is not None else _schema_ns()
    row_ts = ns["ROW_TS_COLS"]
    field_prefix = {
        "exec_info": ("exec", "X_", "X_N"),
        "activities": ("activities", "AC_", "AC_N"),
        "timers": ("timers", "TI_", "TI_N"),
        "children": ("children", "CH_", "CH_N"),
        "cancels": ("cancels", "RC_", "RC_N"),
        "signals": ("signals", "SG_", "SG_N"),
    }
    declared: Set[str] = set()
    for field, cols in row_ts.items():
        label, prefix, count = field_prefix[field]
        by_val = column_names(prefix, count, ns)
        for c in cols:
            declared.add(f"{label}:{by_val[c][0]}")
    probed = {
        c for c in kmat.ts_columns()
        if not c.startswith("vh:")  # vh carries ids/versions, never ts
    }
    findings: List[Finding] = []
    for c in sorted(probed - declared):
        findings.append(Finding(
            "SURFACE-TS-UNCOVERED", f"ts:{c}",
            f"{c} derives from an epoch-relative timestamp in the kernel "
            "but is missing from schema.ROW_TS_COLS — rebase_state_row "
            "will not shift it and cross-epoch checkpoint resume will "
            "read a stale absolute time",
        ))
    for c in sorted(declared - probed):
        findings.append(Finding(
            "SURFACE-TS-STALE", f"ts:{c}",
            f"schema.ROW_TS_COLS declares {c} epoch-bearing but no "
            "kernel transition derives it from a timestamp column",
        ))
    return findings


# --------------------------------------------------------------------------
# Orchestration + matrix artifact
# --------------------------------------------------------------------------


def _read(repo_root: str, rel: str) -> str:
    with open(os.path.join(repo_root, rel)) as f:
        return f.read()


def build(repo_root: str, device="cuda"):
    """(kernel matrix, oracle table, pack-handled names, rel_ts attrs).
    The matrix probes the plain step on the CPU and the kernel wrapper
    ``replay_rows`` on any other device."""
    sb_src = _read(repo_root, "cadence_tpu_torch/core/state_builder.py")
    ms_src = _read(repo_root, "cadence_tpu_torch/core/mutable_state.py")
    pack_src = _read(repo_root, "cadence_tpu_torch/ops/pack.py")
    rel_ts = oracle_ast.extract_rel_ts_attrs(pack_src)
    impl = "replay_rows_plain" if str(device) == "cpu" else "replay_rows"
    kmat = kernel_matrix(rel_ts_attrs=rel_ts, impl=impl, device=device)
    otable = oracle_table(sb_src, ms_src)
    pack_handled = set(
        oracle_ast.extract_event_dispatch(
            pack_src, func_name="pack_workflow"
        )
    )
    return kmat, otable, pack_handled, rel_ts


def run(repo_root: str, device="cuda") -> List[Finding]:
    pack_src = _read(repo_root, "cadence_tpu_torch/ops/pack.py")
    findings = check_column_groups()
    findings += check_pack_attrs(pack_src)
    kmat, otable, pack_handled, _ = build(repo_root, device)
    findings += diff_surface(kmat, otable, pack_handled=pack_handled)
    findings += check_ts_coverage(kmat)
    findings += check_assoc_coverage(kmat)
    return findings


def emit_matrix(repo_root: str, path: str, device="cuda") -> None:
    """Write the transition coverage matrix as a JSON build artifact
    (versioned via the shared artifact envelope, like the queue
    conflict matrix — downstream consumers validate schema_version +
    kind instead of guessing from the file name)."""
    from ..core.enums import EventType

    from .artifact import write_artifact

    kmat, otable, pack_handled, rel_ts = build(repo_root, device)
    doc = {
        "common": sorted(kmat.common),
        "common_ts": sorted(kmat.common_ts),
        "kernel_handled_types": sorted(
            EventType(t).name for t in kmat.handled_types()
        ),
        "pack_handled_types": sorted(pack_handled),
        "rel_ts_attrs": {k: sorted(v) for k, v in sorted(rel_ts.items())},
        "groups": [
            {
                "types": sorted(EventType(t).name for t in g.types),
                "written": sorted(g.written),
                "ts_columns": sorted(g.ts_cols),
            }
            for g in kmat.groups
        ],
        "oracle": {
            tname: {
                "handlers": list(e.handlers),
                "noop": e.is_noop,
                "tables": sorted(e.tables),
                "exec_cols": sorted(e.exec_cols),
            }
            for tname, e in sorted(otable.items())
        },
    }
    write_artifact(path, "transition_matrix", doc)
