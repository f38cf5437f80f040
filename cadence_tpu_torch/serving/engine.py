"""Persistent megabatch serving engine: resident hot state with O(Δ)
replay-on-append, the replays on the card.

A port of the reference package's ``serving/engine.py``, with the same
names, contracts and return values. At scale the dominant operation is
"N new events arrived on a live workflow", not "rebuild 1k events from
zero". This engine keeps hot workflows' state rows resident in a
fixed-shape [S]-lane store and turns each append into an O(Δ) suffix
replay:

* ``admit()`` seats a workflow into a free lane, from its
  ``ReplayCheckpoint`` (a suffix-only resume through the packer's
  ``ResumeState`` seam) or by replaying the prefix through the pipelined
  dispatcher (``ops.dispatch.replay_stream``, lane-packed);
* ``append()`` stages just the Δ suffix against the workflow's lane;
* ``tick()`` packs every pending suffix against its lane's resident row
  (``pack_lanes`` with one resume per lane) and replays each group in one
  launch of the FSM kernel's packed route (``replay_packed_lanes``).
  Lanes whose Δ carries a type the classifier cannot prove affine form
  a second group (``scan``), as in the reference. On the card both groups
  run the sequential FSM kernel: ``scan_mode="auto"`` never reaches the
  segmented affine-scan kernel, as on a TPU, where every mode is
  sequential. So a tick makes at most two launches, one per non-empty
  group;
* ``read()`` answers decision and query requests straight from the
  resident row: no replay, no history read;
* eviction (idle LRU and on close) flushes a lane's row through
  ``CheckpointManager.flush`` and refills the slot from the fair
  admission queue.

Where things live. The resident store is host numpy
(``S.empty_state(lanes, caps)``), as in the reference: the packer rebases
each resumed row to the pack's epoch on the host, and reads, flushes and
the rebuilder's consult all take numpy row dicts. The replays run on
``device`` (``"cuda"`` by default; ``"cpu"`` runs the kernels' plain
versions), resolved at construction, so an engine without a card raises
instead of slipping onto the host. A seat's replayed batch comes back to
the host in one copy before its rows commit; ``_commit_row`` refuses
device tensors.

Failure isolation, narrowed. The reference isolates a poisoned history
with a bare ``except Exception`` in the seat, the compose and the cold
read, retrying per admission or per lane. Here a history counts as
malformed only when the packer refuses it: a ``PackError`` from
``pack_lanes``, or a ``DispatchError`` whose cause is one. The catches
wrap the pack alone, never the replay, so any error of the replay (a
kernel build or launch failure, a ``ValueError`` from the kernel's
wrapper, a CUDA fault) raises out of the verb: a seat first releases
the lanes it reserved, and a tick puts the group's Δs back in front of
the lanes' pending ones, so no Δ is lost and no lane serves a row that
missed one. The per-admission and per-lane retries of a malformed batch
still replay on the card.

Correctness invariants (``tests/test_torch_serving.py``):

* **differential**: resident state after K appends equals, byte for
  byte, the reference engine's on the same calls and a cold replay of
  the full history, for affine-only Δs, all-sequential Δs,
  recycle-then-readmit, and checkpoint-resume seeding;
* **generation stamp**: every lane slot carries a generation bumped on
  recycle, so a stale append (a ticket from a previous tenancy) can
  never land on a recycled slot.

Concurrency: one engine ``threading.Lock`` (``_lock``) guards the slots,
the key map and the admission queue, and nothing blocking runs under it
(packing, replays, checkpoint flushes and store reads all happen outside;
lane state is snapshotted and committed under it in plain-python critical
sections). Ticks serialize on ``_tick_lock``, and ``_lock`` is only ever
taken inside it. Both are built through the lock sanitizer's factory
(``utils/locks.make_lock``), and the hot shared containers (the lane
table, the key map, the admission queue's parked table) are declared
through ``make_guarded`` and ``testing/race_witness.GUARDED_FIELDS``, as
in the reference.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.events import HistoryEvent
from ..ops import schema as S
from ..ops.assoc import classify_types
from ..ops.dispatch import DispatchError, replay_stream
from ..ops.grid import round_scan_len
from ..ops.pack import PackError, ResumeState, pack_lanes
from ..ops.replay import replay_packed_lanes
from ..ops.unpack import state_row_to_mutable_state, state_row_to_snapshot
from ..utils import locks
from ..utils.log import get_logger
from ..utils.metrics import NOOP, Scope
from .admission import AdmissionPolicy, FairAdmissionQueue

Batches = Sequence[Sequence[HistoryEvent]]


@dataclasses.dataclass(frozen=True)
class LaneTicket:
    """A seat handle: (slot, generation) at seat time. The generation
    is the stale-append guard: a ticket outlives its tenancy only as a
    rejected append, never as a write onto a recycled slot."""

    workflow_id: str
    run_id: str
    lane: int
    generation: int


@dataclasses.dataclass
class ResidentRead:
    """One resident-row read: the canonical snapshot plus everything
    needed to rehydrate a full MutableState lazily."""

    snapshot: Dict
    side: object
    epoch_s: int
    domain_id: str
    resident: bool
    state_row: Dict
    branch_token: bytes = b""

    def mutable_state(self):
        one = S.empty_state(1, _caps_of_row(self.state_row))
        S.set_state_row(one, 0, self.state_row)
        return state_row_to_mutable_state(
            one, 0, self.side, domain_id=self.domain_id,
            epoch_s=self.epoch_s,
        )


def _caps_of_row(row: Dict) -> S.Capacities:
    return S.Capacities(
        max_events=1,  # not represented in a state row
        max_activities=row["activities"].shape[0],
        max_timers=row["timers"].shape[0],
        max_children=row["children"].shape[0],
        max_request_cancels=row["cancels"].shape[0],
        max_signals_ext=row["signals"].shape[0],
        max_version_items=row["vh_items"].shape[0],
    )


@dataclasses.dataclass
class _Lane:
    """One seated workflow's lane bookkeeping (the resident state row
    itself lives in the engine's [S] StateTensors at this slot)."""

    domain_id: str
    workflow_id: str
    run_id: str
    branch_token: bytes
    side: object                 # WorkflowSideTable; .resume at the tip
    epoch_s: int
    generation: int
    last_used: int               # tick number
    seated: bool = False         # False while the seat replay is in flight
    closed: bool = False
    pending: List[List[HistoryEvent]] = dataclasses.field(
        default_factory=list
    )
    pending_events: int = 0
    # staged tip: the next event id NOT yet staged into this lane
    # (committed row tip + every pending Δ). The append-idempotence
    # watermark: a duplicate or overlapping batch is dropped here
    next_staged: int = 0
    # persist feed high-water mark (``on_persisted``): history has
    # advanced to this next_event_id; the next tick fetches the
    # [next_staged, behind_through) suffix (O(Δ)) and stages it
    behind_through: int = 0
    # wall time the lane first went dirty (staged Δ or persist debt)
    # since its last compose: the ``serving_staleness_ms`` input
    dirty_since: float = 0.0

    @property
    def key(self) -> Tuple[str, str]:
        return (self.workflow_id, self.run_id)


@dataclasses.dataclass
class _Admission:
    domain_id: str
    workflow_id: str
    run_id: str
    branch_token: bytes
    batches: List
    resume: Optional[ResumeState]

    @property
    def key(self) -> Tuple[str, str]:
        return (self.workflow_id, self.run_id)


class ResidentEngine:
    """Fixed-S-lane resident serving megabatch (module docstring).

    ``tick_interval_s``: kept for the reference's constructor contract
    only; nothing in the port reads it until the runtime wiring starts a
    ``TickPump`` at that cadence.
    ``device``: where seats, ticks and cold reads replay (``"cuda"``,
    the default, or ``"cpu"`` for the kernels' plain versions); resolved
    here, so without a card the constructor raises.
    ``metrics``: a ``Scope``; the engine's counters, gauge and timers
    land under ``layer=serving``. Besides the reference's, the timers
    ``serving_tick_pack``, ``serving_tick_replay`` and
    ``serving_tick_commit`` split each compose group's time."""

    def __init__(
        self,
        lanes: int = 64,
        caps: Optional[S.Capacities] = None,
        checkpoints=None,
        history=None,
        metrics: Optional[Scope] = None,
        idle_ticks: int = 256,
        affine_types: Optional[frozenset] = None,
        admission: Optional[AdmissionPolicy] = None,
        tick_interval_s: float = 0.0,
        device="cuda",
    ) -> None:
        if lanes < 1:
            raise ValueError("serving: lanes must be >= 1")
        if idle_ticks < 1:
            raise ValueError("serving: idle_ticks must be >= 1")
        # no quiet host route: a missing card raises here
        self.device = S.resolve_device(device)
        self.caps = caps or S.Capacities()
        self.lanes = int(lanes)
        # checkpoint.CheckpointManager: eviction flush target and the
        # resume source for admits; None = cold admits, flush-less
        # evictions (the history store stays the source of truth)
        self.checkpoints = checkpoints
        # persistence HistoryManager for admit_from_store / read-through
        self.history = history
        self.idle_ticks = int(idle_ticks)
        # test seam mirroring replay_assoc(affine_types=...): may only
        # shrink the proven-affine set (forces lanes into the scan
        # group), never grow it
        self._affine_types = affine_types
        self._metrics = (
            metrics if metrics is not None else NOOP
        ).tagged(layer="serving")
        self._log = get_logger("cadence_tpu_torch.serving")
        # -- guarded state (everything below is touched only under
        # _lock; blocking work never runs while it is held) -----------
        self._lock = locks.make_lock("ResidentEngine._lock")
        # tick serialization: the snapshot → compose → commit cycle of
        # one tick must be atomic with respect to other ticks, or two
        # concurrent ticks could compose disjoint pending Δs from the
        # same base row snapshot and the later commit would silently
        # discard the earlier Δ. Strict order: _tick_lock first, _lock
        # only inside it (no path holds _lock while acquiring this)
        self._tick_lock = locks.make_lock("ResidentEngine._tick_lock")
        self._slots: List[Optional[_Lane]] = locks.make_guarded(
            [None] * self.lanes, "ResidentEngine._slots", self._lock
        )
        self._by_key: Dict[Tuple[str, str], int] = locks.make_guarded(
            {}, "ResidentEngine._by_key", self._lock
        )
        # fair admission (serving/admission.py): weighted, deadline-aged
        # and per-domain-quota'd refill; its parked table is guarded by
        # this engine lock
        self._admit_queue = FairAdmissionQueue(admission, self._lock)
        # the tick pump's cadence (serving/pump.py; 0 = no pump); unread
        # until the runtime wiring owns the pump thread
        self.tick_interval_s = float(tick_interval_s)
        self._slot_gen = [0] * self.lanes
        self._tick_no = 0
        # the resident store: one [S]-row host StateTensors, rows
        # scattered in place under the lock
        self._state = S.empty_state(self.lanes, self.caps)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def admit(
        self,
        domain_id: str,
        workflow_id: str,
        run_id: str,
        branch_token: bytes = b"",
        batches: Optional[Batches] = None,
        checkpoint=None,
    ) -> Optional[LaneTicket]:
        """Seat one workflow; returns its ticket, or None when every
        lane is occupied (the admission queued for the next recycle).

        ``batches`` is the full history prefix (cold admit). With a
        ``checkpoint`` (ReplayCheckpoint) the engine seats from the
        snapshot and ``batches``, when given, is filtered down to the
        suffix past it; with a CheckpointManager attached, admits
        consult the store the same way ``rebuild_many`` does."""
        out = self.admit_many([
            dict(domain_id=domain_id, workflow_id=workflow_id,
                 run_id=run_id, branch_token=branch_token,
                 batches=batches, checkpoint=checkpoint)
        ])
        return out.get((workflow_id, run_id))

    def admit_from_store(
        self, domain_id: str, workflow_id: str, run_id: str,
        branch_token: bytes,
    ) -> Optional[LaneTicket]:
        """Production admission: the full history from the attached
        history manager (the checkpoint consult inside ``admit`` trims it
        to the suffix when a snapshot resumes)."""
        if self.history is None:
            raise RuntimeError("admit_from_store needs a history manager")
        return self.admit(
            domain_id, workflow_id, run_id, branch_token=branch_token,
            batches=self._read_batches(branch_token),
        )

    def admit_many(self, requests: Sequence[Dict], _requeued=None) -> Dict:
        """Bulk admission; returns {(workflow_id, run_id): ticket|None}.

        Free lanes are reserved under the lock, then every seat replay
        runs as one stream through the dispatcher (``replay_stream``:
        pack overlap, lane packing), and the rows commit back under the
        lock. ``_requeued`` (internal, the refill path): key → the
        original parked entry, so an admission that fails to seat
        re-parks at its original age."""
        admissions = [self._prepare_admission(r) for r in requests]
        out: Dict = {}
        seat: List[Tuple[int, int, _Admission]] = []
        queued = resumed = cold = 0
        with self._lock:
            for adm in admissions:
                slot = self._by_key.get(adm.key)
                if slot is not None:
                    lane = self._slots[slot]
                    lane.last_used = self._tick_no
                    out[adm.key] = LaneTicket(
                        adm.workflow_id, adm.run_id, slot,
                        lane.generation,
                    )
                    continue
                free = self._free_slot()
                if free is None:
                    self._admit_queue.park(
                        adm,
                        requeued_from=(_requeued or {}).get(adm.key),
                    )
                    queued += 1
                    out[adm.key] = None
                    continue
                gen = self._slot_gen[free]
                lane = _Lane(
                    domain_id=adm.domain_id,
                    workflow_id=adm.workflow_id, run_id=adm.run_id,
                    branch_token=adm.branch_token, side=None,
                    epoch_s=0, generation=gen,
                    last_used=self._tick_no, seated=False,
                )
                self._slots[free] = lane
                self._by_key[adm.key] = free
                seat.append((free, gen, adm))
                if adm.resume is not None:
                    resumed += 1
                else:
                    cold += 1
        if seat:
            seated = self._seat(seat)
            out.update(seated)
        scope = self._metrics
        if queued:
            scope.inc("serving_admit_queued", queued)
        if resumed:
            scope.inc("serving_admit_resume", resumed)
        if cold:
            scope.inc("serving_admit_cold", cold)
        return out

    def _prepare_admission(self, r: Dict) -> _Admission:
        """Resolve one admit request's seeding (checkpoint consult and
        suffix trim): store I/O, so it runs before the lock."""
        batches = list(r.get("batches") or [])
        ckpt = r.get("checkpoint")
        branch_token = r.get("branch_token") or b""
        if ckpt is None and self.checkpoints is not None and branch_token:
            from ..checkpoint.manager import HIT

            try:
                cand, status = self.checkpoints.lookup(
                    branch_token, caps=self.caps
                )
                if status == HIT:
                    ckpt = cand
            except Exception:  # the checkpoint store's boundary: cold
                ckpt = None
        resume = None
        if ckpt is not None:
            suffix = [
                b for b in batches if b and b[0].event_id > ckpt.event_id
            ]
            straddles = any(
                b and b[0].event_id <= ckpt.event_id < b[-1].event_id
                for b in batches
            )
            if not straddles:
                try:
                    resume = ckpt.resume_state()
                    batches = suffix
                except Exception:
                    resume = None  # corrupt snapshot: cold admit
        return _Admission(
            domain_id=r.get("domain_id", ""),
            workflow_id=r["workflow_id"], run_id=r["run_id"],
            branch_token=branch_token, batches=batches, resume=resume,
        )

    def _seat(self, seat: List[Tuple[int, int, _Admission]]) -> Dict:
        """Replay the reserved admissions (outside the lock) and commit
        the rows; a malformed history fails only its own admission. A
        fault of the card releases the reservations and raises."""
        out: Dict = {}
        failures = 0
        try:
            rows = self._seat_rows(seat)
        except BaseException:
            with self._lock:
                for slot, gen, adm in seat:
                    if self._slot_gen[slot] == gen:
                        self._release_slot(slot, adm.key)
            raise
        admitted = 0
        with self._lock:
            for (slot, gen, adm), row in zip(seat, rows):
                if row is None:
                    failures += 1
                    # release only our own reservation: the slot may
                    # have been recycled and re-seated while the replay
                    # ran (drain/evict bump the generation)
                    if self._slot_gen[slot] == gen:
                        self._release_slot(slot, adm.key)
                    out[adm.key] = None
                    continue
                packed, final, j = row
                if self._slot_gen[slot] != gen:
                    failures += 1  # recycled mid-seat (drain/shutdown)
                    out[adm.key] = None
                    continue
                lane = self._slots[slot]
                self._commit_row(slot, lane, packed, final, j)
                lane.seated = True
                admitted += 1
                out[adm.key] = LaneTicket(
                    adm.workflow_id, adm.run_id, slot, gen
                )
        if admitted:
            self._metrics.inc("serving_admits", admitted)
        if failures:
            self._metrics.inc("serving_admit_failures", failures)
        return out

    def _seat_rows(self, seat) -> List[Optional[Tuple]]:
        """(packed, host state, row) per reserved admission, or None for
        a malformed history."""
        histories = [
            (adm.workflow_id, adm.run_id, adm.batches)
            for _, _, adm in seat
        ]
        resumes = [adm.resume for _, _, adm in seat]
        try:
            results = replay_stream(
                histories, caps=self.caps, lane_pack=True,
                resume=resumes, device=self.device,
            )
        except DispatchError as e:
            if not isinstance(e.cause, PackError):
                raise  # a fault of the replay, not of a history
            # one malformed history fails the strict stream: seat
            # individually, drop only the bad ones
            rows: List[Optional[Tuple]] = []
            for hist, rs in zip(histories, resumes):
                try:
                    packed = pack_lanes(
                        [hist], caps=self.caps, resume=[rs]
                    )
                except PackError:
                    rows.append(None)
                    continue
                final = self._replay(packed, scan_mode="auto")
                rows.append((packed, final, 0))
            return rows
        rows = []
        for packed, final in results:
            # one device-to-host copy a batch, not one a row
            final = S.state_to_numpy(final)
            rows.extend(
                (packed, final, j) for j in range(packed.n_histories)
            )
        return rows

    def _free_slot(self) -> Optional[int]:
        for i in range(self.lanes):
            if self._slots[i] is None:
                return i
        return None

    def _release_slot(self, slot: int, key) -> None:
        self._slot_gen[slot] += 1
        self._slots[slot] = None
        if self._by_key.get(key) == slot:
            del self._by_key[key]

    def _commit_row(self, slot, lane, packed, final, j) -> None:
        """Install one replay-result row into its lane (under _lock).
        ``final`` is host numpy state: indexing a device tensor here
        would copy each field of each row on its own."""
        if not isinstance(final.exec_info, np.ndarray):
            raise TypeError(
                "serving: replay results must reach the host before "
                "their rows commit")
        row = S.state_row(final, j)
        S.set_state_row(self._state, slot, row)
        lane.side = packed.side[j]
        lane.epoch_s = packed.epoch_s
        lane.closed = bool(row["exec_info"][S.X_CLOSE_STATUS] != 0)
        lane.last_used = self._tick_no
        lane.next_staged = max(
            lane.next_staged, int(row["exec_info"][S.X_NEXT_EVENT_ID])
        )

    # ------------------------------------------------------------------
    # append + the tick
    # ------------------------------------------------------------------

    def append(self, ticket, batches: Batches) -> bool:
        """Stage a Δ suffix against a seated lane.

        ``ticket``: a LaneTicket (generation-checked: the stale-append
        guard) or a (workflow_id, run_id) key. Returns False (and counts
        ``serving_stale_appends``) when the ticket's tenancy is gone; the
        caller re-admits and retries. At-least-once feeds (the persist
        catch-up and an explicit append may overlap, with any
        re-chunking): events at or below the staged tip are trimmed, and
        a batch that straddles the tip keeps its unseen tail. A batch
        past the tip (a gap: events between the tip and the batch never
        arrived here) is never composed over: lanes with a history feed
        record the debt and the next tick's catch-up fetches the whole
        span; bare lanes refuse the append (False,
        ``serving_gapped_appends``) so divergent state is never served as
        resident truth."""
        batches = [list(b) for b in batches if b]
        stale = gapped = False
        n_events = 0
        with self._lock:
            lane = self._resolve_lane(ticket)
            if lane is None:
                stale = True
            else:
                for b in batches:
                    if b[0].event_id < lane.next_staged:
                        b = [
                            e for e in b
                            if e.event_id >= lane.next_staged
                        ]
                        if not b:
                            continue  # duplicate delivery, whole
                    if b[0].event_id > lane.next_staged:
                        if self.history is not None and lane.branch_token:
                            lane.behind_through = max(
                                lane.behind_through,
                                b[-1].event_id + 1,
                            )
                            if not lane.dirty_since:
                                lane.dirty_since = _time.monotonic()
                            continue
                        gapped = True
                        break
                    lane.pending.append(b)
                    lane.pending_events += len(b)
                    n_events += len(b)
                    lane.next_staged = b[-1].event_id + 1
                    if not lane.dirty_since:
                        lane.dirty_since = _time.monotonic()
        if stale:
            self._metrics.inc("serving_stale_appends")
            return False
        if gapped:
            self._metrics.inc("serving_gapped_appends")
            return False
        self._metrics.inc("serving_appends")
        if n_events:
            self._metrics.inc("serving_append_events", n_events)
        return True

    def on_persisted(
        self, domain_id: str, workflow_id: str, run_id: str,
        next_event_id: int, running: bool = True,
    ) -> None:
        """The persist-path feed (fired after every durable write):
        O(1), it records that the workflow's history advanced to
        ``next_event_id``. The next tick fetches just the
        [staged_tip, next_event_id) suffix from the history manager and
        composes it, with no I/O on the persist caller's thread.
        Unseated workflows are a dict miss."""
        with self._lock:
            slot = self._by_key.get((workflow_id, run_id))
            if slot is None:
                return
            lane = self._slots[slot]
            if lane is None:
                return
            # reserved-but-unseated lanes record the debt too: events
            # persisted during the seating window would otherwise be
            # dropped and the fresh lane would serve a stale tip; the
            # post-seat catch-up heals the recorded span instead
            lane.behind_through = max(lane.behind_through, next_event_id)
            if not lane.dirty_since:
                lane.dirty_since = _time.monotonic()
            if not running:
                # close hint: once the debt composes (the close events
                # are in it), the committed row confirms and the
                # on-close eviction recycles the lane
                lane.closed = True

    def _catch_up(self) -> None:
        """Fetch and stage the persist-feed suffixes of behind lanes
        (tick phase 0). History reads run outside the lock; a failed
        read leaves the lane behind, retried next tick."""
        if self.history is None:
            return
        fetch: List[Tuple[int, int, Tuple, bytes, int, int]] = []
        with self._lock:
            for slot in range(self.lanes):
                lane = self._slots[slot]
                if (lane is None or not lane.seated
                        or not lane.branch_token
                        or lane.behind_through <= lane.next_staged):
                    continue
                fetch.append((
                    slot, lane.generation, lane.key, lane.branch_token,
                    lane.next_staged, lane.behind_through,
                ))
        for slot, gen, key, token, lo, hi in fetch:
            try:
                batches = self._read_batches(
                    token, min_event_id=lo, max_event_id=hi
                )
                first = next((b for b in batches if b), None)
                if first is None or first[0].event_id > lo:
                    # the node containing ``lo`` starts below it (the
                    # store pages by node id, and an explicit append's
                    # re-chunking can leave the tip mid-node): refetch
                    # from the start; the staging trim below drops the
                    # already-staged prefix
                    batches = self._read_batches(
                        token, max_event_id=hi
                    )
            except Exception:  # the history store's boundary
                continue  # still behind; next tick retries
            released = 0
            with self._lock:
                if self._slot_gen[slot] != gen:
                    continue  # recycled mid-fetch: never lands
                lane = self._slots[slot]
                if lane is None or lane.key != key:
                    continue
                for b in batches:
                    if not b:
                        continue
                    if b[0].event_id < lane.next_staged:
                        b = [
                            e for e in b
                            if e.event_id >= lane.next_staged
                        ]
                        if not b:
                            continue
                    if b[0].event_id > lane.next_staged:
                        # even the start-of-branch refetch cannot
                        # provide [next_staged, b[0]): the span is gone
                        # from the store. The lane can never heal, and
                        # composing over the hole would serve divergent
                        # state as resident truth, so free it
                        self._release_slot(slot, lane.key)
                        released = 1
                        break
                    lane.pending.append(list(b))
                    lane.pending_events += len(b)
                    lane.next_staged = b[-1].event_id + 1
                if not released and (
                    lane.behind_through <= lane.next_staged
                ):
                    lane.behind_through = 0
            if released:
                self._metrics.inc("serving_compose_failures")

    def _resolve_lane(self, ticket) -> Optional[_Lane]:
        """Under _lock: the live lane a ticket or key addresses, or None.
        Tickets check slot and generation: the recycled-slot guard."""
        if isinstance(ticket, LaneTicket):
            if not 0 <= ticket.lane < self.lanes:
                return None
            if self._slot_gen[ticket.lane] != ticket.generation:
                return None
            lane = self._slots[ticket.lane]
            return lane if lane is not None and lane.seated else None
        slot = self._by_key.get(tuple(ticket))
        if slot is None:
            return None
        lane = self._slots[slot]
        return lane if lane is not None and lane.seated else None

    def tick(self) -> Dict:
        """One serving tick: every pending Δ replays against its lane
        (one packed launch per non-empty group), then eviction, recycle
        and admission refill. Returns tick stats. Ticks serialize
        (``_tick_lock``): concurrent callers queue behind the running
        tick instead of racing its base-row snapshots; Δs staged while a
        tick composes stay pending and ride the next one."""
        with self._tick_lock:
            return self._tick_locked()

    def _tick_locked(self) -> Dict:
        t0 = _time.perf_counter()
        self._catch_up()
        work: List[Tuple[int, int, _Lane, List, ResumeState]] = []
        with self._lock:
            self._tick_no += 1
            tick_no = self._tick_no
            for slot in range(self.lanes):
                lane = self._slots[slot]
                if lane is None or not lane.seated or not lane.pending:
                    continue
                rs = ResumeState(
                    pack=lane.side.resume, side=lane.side,
                    state_row=S.state_row(self._state, slot),
                )
                work.append(
                    (slot, lane.generation, lane, lane.pending, rs)
                )
                lane.pending = []
                lane.pending_events = 0
                lane.last_used = tick_no
        composed, replayed, failures, stale = self._compose(work)
        evicted, recycled, flush_failed = self._evict_and_refill(tick_no)
        dt = _time.perf_counter() - t0
        scope = self._metrics
        scope.inc("serving_ticks")
        scope.record("serving_tick_seconds", dt)
        if composed:
            # batches counted per grid-rounded width, like the
            # dispatcher's batch_width (bounded tag cardinality)
            scope.tagged(width=str(round_scan_len(composed))).inc(
                "serving_append_width"
            )
        if replayed:
            scope.inc("serving_events_replayed", replayed)
        if stale:
            scope.inc("serving_stale_appends", stale)
        if failures:
            scope.inc("serving_compose_failures", failures)
        if evicted:
            scope.inc("serving_evictions", evicted)
        if recycled:
            scope.inc("serving_recycles", recycled)
        if flush_failed:
            scope.inc("serving_flush_failures", flush_failed)
        scope.gauge("serving_lane_occupancy", self.occupancy())
        return {
            "tick": tick_no, "composed": composed,
            "events_replayed": replayed, "evicted": evicted,
            "recycled": recycled, "tick_seconds": dt,
        }

    def _delta_types(self, batches) -> frozenset:
        return frozenset(
            int(e.event_type) for b in batches for e in b
        )

    def _replay(self, packed, scan_mode: str):
        """One lane-packed replay on the engine's device; host numpy
        state out."""
        return replay_packed_lanes(
            packed, scan_mode=scan_mode, device=self.device
        )

    def _compose(self, work) -> Tuple[int, int, int, int]:
        """Split pending lanes into the affine group and the scan group,
        pack and replay each as one batch, commit rows under the lock."""
        if not work:
            return 0, 0, 0, 0
        groups: Dict[str, List] = {"auto": [], "scan": []}
        for item in work:
            _, non = classify_types(
                self._delta_types(item[3]), self._affine_types
            )
            groups["scan" if non else "auto"].append(item)
        composed = replayed = failures = stale = 0
        staleness_ms: List[float] = []
        scope = self._metrics
        for mode, items in groups.items():
            if not items:
                continue
            histories = [
                (lane.workflow_id, lane.run_id, batches)
                for _, _, lane, batches, _ in items
            ]
            resumes = [rs for *_, rs in items]
            try:
                results = self._compose_group(
                    mode, histories, resumes, scope)
            except BaseException:
                # a fault of the card: the group's Δs go back in front
                # of whatever was staged since, to ride the next tick
                with self._lock:
                    for slot, gen, lane, batches, _ in items:
                        if (self._slot_gen[slot] == gen
                                and self._slots[slot] is lane):
                            lane.pending = batches + lane.pending
                            lane.pending_events += sum(
                                len(b) for b in batches)
                raise
            t_commit = _time.perf_counter()
            with self._lock:
                for (slot, gen, lane, batches, _), row in zip(
                    items, results
                ):
                    if row is None:
                        # the Δ is unreplayable: free the lane; the
                        # history store remains the source of truth and
                        # a readmit-from-store recovers the workflow.
                        # Generation-checked like the commit branch: a
                        # slot recycled and re-seated mid-step must not
                        # be clobbered
                        failures += 1
                        if (self._slot_gen[slot] == gen
                                and self._slots[slot] is lane):
                            self._release_slot(slot, lane.key)
                        continue
                    if (self._slot_gen[slot] != gen
                            or self._slots[slot] is not lane):
                        stale += 1  # recycled mid-step: never lands
                        continue
                    packed, final, j = row
                    self._commit_row(slot, lane, packed, final, j)
                    composed += 1
                    replayed += sum(len(b) for b in batches)
                    if lane.dirty_since:
                        # staleness: first dirty → composed. Reset to
                        # "now" (not 0) when Δs staged mid-compose:
                        # their clock started while this step ran
                        now = _time.monotonic()
                        staleness_ms.append(
                            (now - lane.dirty_since) * 1e3
                        )
                        lane.dirty_since = now if (
                            lane.pending
                            or lane.behind_through > lane.next_staged
                        ) else 0.0
            scope.record("serving_tick_commit",
                         _time.perf_counter() - t_commit)
        for ms in staleness_ms:
            self._metrics.record("serving_staleness_ms", ms)
        return composed, replayed, failures, stale

    def _compose_group(self, mode, histories, resumes, scope):
        """(packed, host state, row) per lane of one group, or None for
        a lane whose Δ is malformed."""
        try:
            with scope.timer("serving_tick_pack"):
                packed = pack_lanes(
                    histories, caps=self.caps, resume=resumes
                )
        except PackError:
            packed = None
        if packed is not None:
            with scope.timer("serving_tick_replay"):
                final = self._replay(packed, scan_mode=mode)
            return [(packed, final, j) for j in range(len(histories))]
        # one malformed Δ must not poison the whole tick: degrade to
        # per-lane composition, fail only the bad one
        results: List[Optional[Tuple]] = []
        for hist, rs in zip(histories, resumes):
            try:
                pk = pack_lanes([hist], caps=self.caps, resume=[rs])
            except PackError:
                results.append(None)
                continue
            results.append((pk, self._replay(pk, scan_mode=mode), 0))
        return results

    # ------------------------------------------------------------------
    # eviction / recycle
    # ------------------------------------------------------------------

    def _evict_and_refill(self, tick_no: int) -> Tuple[int, int, int]:
        """Idle-LRU and on-close eviction, then admission-queue refill.
        Slots are freed (generation bumped) under the lock; the flush
        itself, store I/O, runs after release."""
        flush: List[Tuple[_Lane, Dict]] = []
        with self._lock:
            for slot in range(self.lanes):
                lane = self._slots[slot]
                if (lane is None or not lane.seated or lane.pending
                        or lane.behind_through > lane.next_staged):
                    continue  # dirty lanes compose before they evict
                idle = tick_no - lane.last_used
                if not lane.closed and idle < self.idle_ticks:
                    continue
                flush.append((lane, S.state_row(self._state, slot)))
                self._release_slot(slot, lane.key)
        flush_failed = 0
        for lane, row in flush:
            if not self._flush_row(lane, row):
                flush_failed += 1
        recycled = 0
        # refill whenever a free slot exists (slots freed by seat or
        # compose failures or an explicit evict() too). The refill order
        # is the fair scheduler's: only as many admissions as there are
        # free slots are taken, and a take that fails to seat re-parks at
        # its original age
        with self._lock:
            n_free = sum(1 for s in self._slots if s is None)
            backlog = (
                self._admit_queue.take(n_free) if n_free else []
            )
            ages_ms = [
                self._admit_queue.parked_age_s(e) * 1e3 for e in backlog
            ]
        if backlog:
            # store reads and the bulk admission run outside the lock
            reqs = []
            for entry in backlog:
                a = entry.adm
                batches = a.batches
                if self.history is not None and a.branch_token:
                    try:
                        # queue-time batches go stale while the
                        # admission waits (on_persisted is a dict miss
                        # for unseated workflows): re-read the tip so a
                        # refilled lane never serves a stale row
                        batches = self._read_batches(a.branch_token)
                    except Exception:  # the history store's boundary
                        pass  # queue-time prefix: still consistent
                reqs.append(dict(
                    domain_id=a.domain_id,
                    workflow_id=a.workflow_id, run_id=a.run_id,
                    branch_token=a.branch_token, batches=batches,
                ))
            readmitted = self.admit_many(
                reqs,
                _requeued={e.adm.key: e for e in backlog},
            )
            recycled = sum(
                1 for t in readmitted.values() if t is not None
            )
            # a taken admission whose seat replay failed was dropped by
            # admit_many (only the no-free-slot branch re-parks): put it
            # back at its original age, at most 3 attempts, so a
            # poisoned history drops after 3 tries
            with self._lock:
                for entry in backlog:
                    if (readmitted.get(entry.adm.key) is None
                            and entry.attempts < 3
                            and not self._admit_queue.has_key(
                                entry.adm.key)):
                        self._admit_queue.park(
                            entry.adm, requeued_from=entry
                        )
            # the parked-age distribution at seat time (the starvation
            # observable)
            for ms, entry in zip(ages_ms, backlog):
                if readmitted.get(entry.adm.key) is not None:
                    self._metrics.record(
                        "serving_admit_starvation_age_ms", ms
                    )
        return len(flush), recycled, flush_failed

    def _flush_row(self, lane: _Lane, row: Dict) -> bool:
        """Flush one evicted lane's row through the checkpoint plane
        (policy-free write). True when durable; False counts as a flush
        failure but is never fatal: the history store is still the
        source of truth and a readmit cold-replays."""
        if self.checkpoints is None or not lane.branch_token:
            return True
        one = S.empty_state(1, self.caps)
        S.set_state_row(one, 0, row)
        return self.checkpoints.flush(
            lane.branch_token, one, 0, lane.side, epoch_s=lane.epoch_s,
            caps=self.caps, domain_id=lane.domain_id,
            workflow_id=lane.workflow_id, run_id=lane.run_id,
        )

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------

    def read(
        self,
        workflow_id: str,
        run_id: str,
        domain_id: str = "",
        branch_token: Optional[bytes] = None,
    ) -> Optional[ResidentRead]:
        """Answer a decision or query read.

        Resident lanes answer straight from the row: no replay, no
        history read. A lane with staged Δs composes first (one tick) so
        reads always reflect acknowledged appends. A miss falls through
        to a cold single-history replay when the engine has a history
        manager and the caller names the branch (counted as
        ``serving_cold_misses``); otherwise None."""
        t0 = _time.perf_counter()
        scope = self._metrics
        out = self.resident_row(workflow_id, run_id, domain_id=domain_id)
        if out is not None:
            scope.inc("serving_resident_hits")
            scope.record(
                "serving_read_seconds", _time.perf_counter() - t0
            )
            return out
        scope.inc("serving_cold_misses")
        return self._cold_read(
            workflow_id, run_id, domain_id, branch_token, t0
        )

    def _cold_read(
        self, workflow_id: str, run_id: str, domain_id: str,
        branch_token: Optional[bytes], t0: float,
    ) -> Optional[ResidentRead]:
        """One-shot cold replay of the full history on the engine's
        device: the miss path shared by ``read`` and ``read_through`` (no
        lane is touched). A history the serving caps cannot pack returns
        None, counted ``serving_cold_read_failures``; a fault of the card
        raises."""
        if self.history is None or not branch_token:
            self._metrics.record(
                "serving_read_seconds", _time.perf_counter() - t0
            )
            return None
        try:  # the history store's boundary, and the packer's
            batches = self._read_batches(branch_token)
            packed = pack_lanes(
                [(workflow_id, run_id, batches)], caps=self.caps
            )
        except Exception as e:
            self._log.warn(f"serving cold read failed ({e}); miss")
            self._metrics.inc("serving_cold_read_failures")
            self._metrics.record(
                "serving_read_seconds", _time.perf_counter() - t0
            )
            return None
        final = self._replay(packed, scan_mode="auto")
        row = S.state_row(final, 0)
        one = S.empty_state(1, self.caps)
        S.set_state_row(one, 0, row)
        out = ResidentRead(
            snapshot=state_row_to_snapshot(one, 0, packed.epoch_s),
            side=packed.side[0], epoch_s=packed.epoch_s,
            domain_id=domain_id, resident=False, state_row=row,
            branch_token=branch_token or b"",
        )
        self._metrics.record(
            "serving_read_seconds", _time.perf_counter() - t0
        )
        return out

    def resident_row(
        self, workflow_id: str, run_id: str, domain_id: str = "",
    ) -> Optional[ResidentRead]:
        """The resident view of one seated lane, or None: no cold
        fallback and no hit/miss accounting (``read`` adds both; the
        rebuilder's serving consult counts its own hits). A dirty lane
        (staged Δs or a persist-feed debt) composes first so the row
        always reflects acknowledged appends."""
        key = (workflow_id, run_id)
        got = None
        for _ in range(4):
            dirty = False
            with self._lock:
                slot = self._by_key.get(key)
                if slot is not None:
                    lane = self._slots[slot]
                    if lane is not None and lane.seated:
                        if (lane.pending
                                or lane.behind_through > lane.next_staged):
                            dirty = True
                        else:
                            lane.last_used = self._tick_no
                            got = (
                                S.state_row(self._state, slot),
                                lane.side, lane.epoch_s,
                                lane.domain_id, lane.branch_token,
                            )
            if got is not None or not dirty:
                break
            self.tick()
        if got is None:
            return None
        row, side, epoch_s, dom, token = got
        one = S.empty_state(1, self.caps)
        S.set_state_row(one, 0, row)
        return ResidentRead(
            snapshot=state_row_to_snapshot(one, 0, epoch_s),
            side=side, epoch_s=epoch_s,
            domain_id=domain_id or dom, resident=True,
            state_row=row, branch_token=token,
        )

    def read_through(
        self, domain_id: str, workflow_id: str, run_id: str,
        branch_token: bytes,
    ) -> Optional[ResidentRead]:
        """The serving-plane read verb: resident hit, else admit the
        workflow (full-history seat through the dispatcher, suffix-only
        when a checkpoint resumes) and answer from the fresh lane, so the
        next read is resident. Falls back to a one-shot cold replay when
        every lane is occupied (the admission queued)."""
        t0 = _time.perf_counter()
        got = self.resident_row(workflow_id, run_id, domain_id=domain_id)
        scope = self._metrics
        if got is not None:
            scope.inc("serving_resident_hits")
            scope.record(
                "serving_read_seconds", _time.perf_counter() - t0
            )
            return got
        scope.inc("serving_cold_misses")
        try:
            batches = self._read_batches(branch_token)
        except Exception:  # the history store's boundary
            batches = None  # unreadable branch: the cold path misses
        ticket = None
        if batches is not None:
            ticket = self.admit(
                domain_id, workflow_id, run_id,
                branch_token=branch_token, batches=batches,
            )
        if ticket is not None:
            got = self.resident_row(
                workflow_id, run_id, domain_id=domain_id
            )
        if got is not None:
            scope.record(
                "serving_read_seconds", _time.perf_counter() - t0
            )
            return got
        return self._cold_read(
            workflow_id, run_id, domain_id, branch_token, t0
        )

    def _read_batches(
        self, branch_token: bytes, min_event_id: int = 1,
        max_event_id: int = 1 << 60,
    ) -> List:
        from ..runtime.persistence.records import BranchToken

        branch = BranchToken.from_json(
            branch_token.decode()
            if isinstance(branch_token, bytes) else str(branch_token)
        )
        out: List = []
        token = 0
        while True:
            batches, token = self.history.read_history_branch(
                branch, max(1, min_event_id), max_event_id,
                page_size=256, next_token=token,
            )
            out.extend(batches)
            if not token:
                return out

    # ------------------------------------------------------------------
    # lifecycle / introspection
    # ------------------------------------------------------------------

    def evict(self, workflow_id: str, run_id: str) -> bool:
        """Explicit eviction (operator or test entry): compose pending,
        flush, free the lane."""
        key = (workflow_id, run_id)
        with self._lock:
            slot = self._by_key.get(key)
            lane = self._slots[slot] if slot is not None else None
            has_pending = lane is not None and bool(
                lane.pending
                or lane.behind_through > lane.next_staged
            )
        if slot is None:
            return False
        if has_pending:
            self.tick()
        flush = None
        with self._lock:
            slot = self._by_key.get(key)
            if slot is None:
                return False
            lane = self._slots[slot]
            flush = (lane, S.state_row(self._state, slot))
            self._release_slot(slot, key)
        ok = self._flush_row(*flush)
        self._metrics.inc("serving_evictions")
        if not ok:
            self._metrics.inc("serving_flush_failures")
        return True

    def drain(self) -> Dict:
        """Shutdown: compose everything pending, flush and free every
        lane. Returns {"flushed", "flush_failed", "queued_dropped"};
        clean means flush_failed == 0 and the engine is empty after."""
        # compose until quiescent (appends racing the drain get one
        # more tick; a live producer should be stopped first)
        for _ in range(8):
            with self._lock:
                dirty = any(
                    l is not None
                    and (l.pending or l.behind_through > l.next_staged)
                    for l in self._slots
                )
            if not dirty:
                break
            self.tick()
        flush: List[Tuple[_Lane, Dict]] = []
        with self._lock:
            for slot in range(self.lanes):
                lane = self._slots[slot]
                if lane is None:
                    continue
                flush.append((lane, S.state_row(self._state, slot)))
                self._release_slot(slot, lane.key)
            queued = self._admit_queue.drain()
        failed = 0
        for lane, row in flush:
            if not self._flush_row(lane, row):
                failed += 1
        if flush:
            self._metrics.inc("serving_evictions", len(flush))
        if failed:
            self._metrics.inc("serving_flush_failures", failed)
        return {
            "flushed": len(flush), "flush_failed": failed,
            "queued_dropped": queued,
        }

    def retune_admission(
        self, quota_rps: float, quota_burst=None
    ) -> None:
        """Live retune of the admission queue's per-domain quota (the
        capacity autopilot's serving-plane actuator)."""
        with self._lock:
            self._admit_queue.set_quota_rps(quota_rps, burst=quota_burst)

    def admission_quota_rps(self) -> float:
        with self._lock:
            return self._admit_queue.policy.quota_rps

    def occupancy(self) -> float:
        with self._lock:
            seated = sum(
                1 for l in self._slots if l is not None and l.seated
            )
        return seated / self.lanes

    def describe(self) -> Dict:
        with self._lock:
            seated = [
                {
                    "lane": i, "workflow_id": l.workflow_id,
                    "run_id": l.run_id, "generation": l.generation,
                    "pending_events": l.pending_events,
                    "closed": l.closed, "last_used": l.last_used,
                }
                for i, l in enumerate(self._slots)
                if l is not None
            ]
            queued = len(self._admit_queue)
            tick = self._tick_no
        return {
            "lanes": self.lanes, "seated": len(seated),
            "queued": queued, "tick": tick, "lanes_detail": seated,
        }
