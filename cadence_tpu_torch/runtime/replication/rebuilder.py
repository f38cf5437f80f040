"""State rebuilder: (history branch) → fresh MutableState + tasks.

A port of the reference package's ``runtime/replication/rebuilder.py``
(Cadence service/history/nDCStateRebuilder.go:92-160: page through the
history branch, replay every batch through a fresh state builder, refresh
the tasks).

``rebuild`` is the host oracle: one run through ``core.StateBuilder``.
``rebuild_many`` is the batched path: it reads each request's history
from the history store, consults the checkpoint plane, depth-buckets and
lane-packs the histories through the port's ``DeviceDispatcher``, whose
CUDA FSM kernel replays each batch in one launch, then rehydrates every
replayed row into a full ``MutableState`` on the host, refreshes its
tasks and writes fresh checkpoints. A batch the packer refuses (capacity
overflow, a value the device encoding cannot hold) falls back, run by
run, to the host oracle, and that route is counted.

Resident-lane consult: with a serving engine attached, a request whose
pinned tip, branch and (when given) version-history items match a
resident lane exactly rehydrates from the lane's row, with no history
read and no replay (``serving_resident_hits``). Anything else falls
through to the checkpoint and cold paths.

Checkpointed incremental replay: with a ``CheckpointManager`` attached a
request whose newest valid snapshot is found reads and replays only the
event suffix past it (the snapshot row seeds the lane's carry), and one
at the branch tip skips the device (rehydrate and refresh only). Any
checkpoint-plane failure degrades that request to a full replay.

The metrics scope also reaches the dispatcher, which then reports its
device-step telemetry (``DEVICE_METRICS``) for every rebuilt batch.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

from ...checkpoint.manager import HIT
from ...core.events import HistoryEvent
from ...core.mutable_state import MutableState
from ...core.state_builder import StateBuilder
from ...core.task_refresher import refresh_tasks
from ...core.version_history import VersionHistories
from ...ops import schema as S
from ...ops.dispatch import DeviceDispatcher, DispatchError, depth_buckets
from ...ops.grid import staging_depth
from ...ops.pack import PackError
from ...ops.unpack import state_row_to_mutable_state
from ...utils.metrics import NOOP
from ..persistence.interfaces import HistoryManager
from ..persistence.records import BranchToken

# rebuild_many's histories per dispatched batch when the caller sets no
# chunk: large on the card, where a launch's fixed cost is amortized over
# many lanes; small on the CPU, where the plain replay runs
_CHUNK_BY_DEVICE = {"cuda": 32768, "cpu": 4096}


class RebuildRequest:
    """One run to rebuild.

    ``version_history_items``: the target branch's (event_id, version)
    items when the caller knows them (the NDC conflict path does): the
    checkpoint manager's divergence guard, and the key that lets a forked
    branch resume from a sibling's snapshot below the LCA.
    """

    def __init__(
        self,
        domain_id: str,
        workflow_id: str,
        run_id: str,
        branch_token: bytes,
        next_event_id: int = 0,
        request_id: str = "rebuild",
        version_history_items: Optional[Sequence[Tuple[int, int]]] = None,
    ) -> None:
        self.domain_id = domain_id
        self.workflow_id = workflow_id
        self.run_id = run_id
        self.branch_token = branch_token
        self.next_event_id = next_event_id
        self.request_id = request_id
        self.version_history_items = version_history_items


class StateRebuilder:
    """Rebuilds runs from a history store, on the card by default.

    ``device``: where ``rebuild_many`` replays (``"cuda"``, the port's
    default, or ``"cpu"`` for the kernels' plain versions). Without a card
    ``rebuild_many(use_device=True)`` raises: it never slips onto the host
    route (``use_device=False`` asks for that explicitly).
    ``chunk_size``: histories per dispatched batch, an int or a callable
    read at every ``rebuild_many``; 0 takes the device's default.
    ``lane_len``: lane capacity (events) for ragged lane packing: shallow
    histories share lanes back to back instead of each padding a lane to
    the deepest.
    ``checkpoints``: a ``CheckpointManager``, or None (every rebuild cold).
    ``serving``: a ``serving.ResidentEngine``, or None; consulted first
    (``_consult_serving``), its hits counted as ``serving_resident_hits``
    under ``layer=serving``.
    ``metrics``: a ``Scope``; the checkpoint counters land under
    ``layer=checkpoint`` (``checkpoint_hit`` / ``_miss`` /
    ``_invalidated``, ``events_replayed_saved``) and the rebuild's own
    under ``layer=rebuild``: ``host_fallbacks`` (runs the host oracle
    rebuilt after the packer refused their batch), and the timers
    ``history_read`` (checkpoint consult and history read),
    ``dispatch_wait`` (waiting for the dispatcher's packed and replayed
    batches), ``rehydrate`` (rows to MutableStates, task refresh,
    checkpoint writes) and ``host_fallback``. The raw scope goes to the
    dispatcher too, for its device-step telemetry (``layer=device``);
    None turns off every plane together.
    """

    def __init__(self, history: HistoryManager,
                 domain_resolver=lambda name: name,
                 chunk_size=0, lane_len: int = 1024,
                 checkpoints=None, metrics=None, serving=None,
                 device="cuda") -> None:
        self.history = history
        self.domain_resolver = domain_resolver
        self.chunk_size = chunk_size
        self.lane_len = lane_len
        self.checkpoints = checkpoints
        self.serving = serving
        self.device = device
        self._raw_metrics = metrics
        scope = metrics if metrics is not None else NOOP
        self._metrics = scope.tagged(layer="checkpoint")
        self._rebuild_metrics = scope.tagged(layer="rebuild")
        self._serving_metrics = scope.tagged(layer="serving")

    def _resolve_chunk(self, device) -> int:
        configured = (
            self.chunk_size() if callable(self.chunk_size)
            else self.chunk_size
        )
        if configured and configured > 0:
            return int(configured)
        return _CHUNK_BY_DEVICE[device.type]

    # -- history paging ------------------------------------------------

    def _read_batches(
        self, req: RebuildRequest, min_event_id: int = 1,
    ) -> List[List[HistoryEvent]]:
        branch = BranchToken.from_json(req.branch_token.decode())
        out: List[List[HistoryEvent]] = []
        token = 0
        while True:
            batches, token = self.history.read_history_branch(
                branch, min_event_id, req.next_event_id or 1 << 60,
                page_size=256, next_token=token,
            )
            out.extend(batches)
            if not token:
                return out

    # -- single rebuild (host oracle) ----------------------------------

    def rebuild(self, req: RebuildRequest) -> Tuple[MutableState, list, list]:
        """Replay one run from scratch; returns (ms, transfer, timer)."""
        batches = self._read_batches(req)
        if not batches:
            raise ValueError(
                f"rebuild: empty history for {req.workflow_id}/{req.run_id}"
            )
        ms = MutableState(domain_id=req.domain_id)
        ms.version_histories = VersionHistories.new_empty()
        sb = StateBuilder(ms, domain_resolver=self.domain_resolver)
        sb.apply_batches(
            req.domain_id, req.request_id, req.workflow_id, req.run_id,
            batches,
        )
        ms.execution_info.branch_token = req.branch_token
        transfer, timer = refresh_tasks(ms)
        return ms, transfer, timer

    # -- resident-lane consult -----------------------------------------

    def _consult_serving(self, req: RebuildRequest):
        """Rehydrate one rebuild from a resident serving lane, or None.

        Sound only under exact-match guards: the caller pinned the target
        tip (``next_event_id``) and the lane is at it, the lane was seated
        from the same branch, and, when the caller supplied them (the NDC
        path), the lane's version-history items equal the target's.
        Anything else, a dirty lane the engine fails to compose included,
        falls through to the checkpoint and cold paths. A fault of the
        card while the engine composes a dirty lane raises, as every
        device fault of the port does."""
        if self.serving is None or not req.next_event_id:
            return None
        got = self.serving.resident_row(
            req.workflow_id, req.run_id, domain_id=req.domain_id
        )
        if got is None:
            return None
        if got.branch_token and got.branch_token != req.branch_token:
            return None
        row = got.state_row
        if int(row["exec_info"][S.X_NEXT_EVENT_ID]) != req.next_event_id:
            return None
        if req.version_history_items is not None:
            n = int(row["vh_len"])
            items = [(int(e), int(v)) for e, v in row["vh_items"][:n]]
            want = [
                (int(e), int(v)) for e, v in req.version_history_items
            ]
            if items != want:
                return None
        ms = got.mutable_state()
        ms.execution_info.branch_token = req.branch_token
        transfer, timer = refresh_tasks(ms)
        self._serving_metrics.inc("serving_resident_hits")
        return ms, transfer, timer

    # -- checkpoint consult --------------------------------------------

    def _consult_checkpoint(self, req: RebuildRequest, caps):
        """The resumable checkpoint for one request, or None; never
        raises. Misses and invalidations count here (they are final); a
        hit counts only once the resume sticks (``_commit_hit`` /
        ``_degrade_hit``), so a degraded resume reports as the full
        replay it became."""
        if self.checkpoints is None:
            return None
        try:
            ckpt, status = self.checkpoints.lookup(
                req.branch_token, caps=caps,
                version_history_items=req.version_history_items,
                max_event_id=(
                    req.next_event_id - 1 if req.next_event_id else None
                ),
            )
        except Exception:
            self._metrics.inc("checkpoint_miss")
            return None
        if status == HIT and ckpt is not None:
            return ckpt
        self._metrics.inc(f"checkpoint_{status}")
        return None

    def _commit_hit(self, ckpt) -> None:
        self._metrics.inc("checkpoint_hit")
        # events before the snapshot are never read or replayed
        self._metrics.inc("events_replayed_saved", ckpt.event_id)

    def _degrade_hit(self) -> None:
        self._metrics.inc("checkpoint_miss")

    def _record_checkpoint(self, req, packed, final, row) -> None:
        """``final``: the batch's numpy state (``maybe_record`` copies
        one row of it)."""
        if self.checkpoints is None:
            return
        self.checkpoints.maybe_record(
            req.branch_token, final, row, packed.side[row],
            epoch_s=packed.epoch_s, caps=packed.caps,
            domain_id=req.domain_id, workflow_id=req.workflow_id,
            run_id=req.run_id,
        )

    def _prepare(self, reqs, caps, out):
        """Consult resident lanes and checkpoints, and read what must be
        replayed. Fills ``out`` for resident and tip hits; returns the
        pending (wf, run, batches) histories, their resume states and
        their request indices."""
        histories, resumes, pend_req = [], [], []
        for gi, r in enumerate(reqs):
            hit = self._consult_serving(r)
            if hit is not None:
                out[gi] = hit
                continue
            ckpt = self._consult_checkpoint(r, caps)
            if ckpt is None:
                batches = self._read_batches(r)
                resume = None
            else:
                try:
                    batches = self._read_batches(
                        r, min_event_id=ckpt.event_id + 1
                    )
                    resume = self.checkpoints.resume_state(ckpt)
                except Exception:  # degraded store/decode: full replay
                    batches, resume = self._read_batches(r), None
                    self._degrade_hit()
                if resume is not None and not batches:
                    # tip hit: nothing to replay, rehydrate directly
                    try:
                        ms = self.checkpoints.rehydrate(
                            ckpt, domain_id=r.domain_id
                        )
                        ms.execution_info.branch_token = r.branch_token
                        transfer, timer = refresh_tasks(ms)
                        out[gi] = (ms, transfer, timer)
                        self._commit_hit(ckpt)
                        continue
                    except Exception:
                        batches, resume = self._read_batches(r), None
                        self._degrade_hit()
                if resume is not None:
                    self._commit_hit(ckpt)
            histories.append((r.workflow_id, r.run_id, batches))
            resumes.append(resume)
            pend_req.append(gi)
        return histories, resumes, pend_req

    def _host_fallback(self, reqs, idxs, out) -> None:
        """Rebuild the runs of a batch the packer refused on the host
        oracle. One refused history fails its whole batch, so every run
        of that batch takes this route: the reference's semantics."""
        scope = self._rebuild_metrics
        scope.inc("host_fallbacks", len(idxs))
        with scope.timer("host_fallback"):
            for gi in idxs:
                out[gi] = self.rebuild(reqs[gi])

    def rebuild_many(
        self, reqs: Sequence[RebuildRequest], use_device: bool = True,
    ) -> List[Tuple[MutableState, list, list]]:
        """Rebuild N runs at once, in request order.

        ``use_device=True`` replays on ``self.device`` through the
        dispatcher (module docstring); it raises without that device
        before it reads anything, and a batch that fails for any reason
        other than the packer's refusal (a kernel or device fault)
        raises too: no fault of the card sends a batch to the host.
        ``use_device=False`` is the host oracle, run by run."""
        if not use_device or len(reqs) == 0:
            return [self.rebuild(r) for r in reqs]
        # no quiet host route: a missing card raises here (the
        # reference's rebuilder fell back to the host when its device
        # stack failed to import; the port does not)
        dev = S.resolve_device(self.device)
        scope = self._rebuild_metrics
        caps = S.Capacities()
        out: List[Optional[Tuple[MutableState, list, list]]] = (
            [None] * len(reqs)
        )

        with scope.timer("history_read"):
            histories, resumes, pend_req = self._prepare(reqs, caps, out)

        # storm drain: depth-bucket the stream (a few deep stragglers
        # must not stretch every lane; a resumed run buckets by its
        # suffix depth), lane-pack each bucket and pump the chunks
        # through the pipelined dispatcher, so packing batch k+1 overlaps
        # replaying batch k
        chunk = self._resolve_chunk(dev)
        plan = []
        for idxs, hs in depth_buckets(histories):
            for j in range(0, len(hs), chunk):
                plan.append((idxs[j : j + chunk], hs[j : j + chunk]))
        if not plan:
            return out
        with DeviceDispatcher(
            caps=caps, depth=staging_depth(len(plan)),
            domain_resolver=self.domain_resolver, lane_pack=True,
            lane_len=self.lane_len, metrics=self._raw_metrics, device=dev,
        ) as d:
            for sub, hs in plan:
                d.submit(
                    tuple(pend_req[i] for i in sub),
                    hs,
                    resume=[resumes[i] for i in sub],
                )
            d.finish()
            results = d.results(strict=False)
            while True:
                t0 = time.perf_counter()
                item = next(results, None)
                scope.record("dispatch_wait", time.perf_counter() - t0)
                if item is None:
                    break
                if isinstance(item, DispatchError):
                    if not isinstance(item.cause, PackError):
                        raise item from item.cause
                    self._host_fallback(reqs, item.batch_id, out)
                    continue
                with scope.timer("rehydrate"):
                    self._rehydrate(reqs, *item, out)
        return out

    def _rehydrate(self, reqs, idxs, packed, final, out) -> None:
        """One replayed batch to MutableStates, tasks and checkpoints.
        The batch comes to the host in one copy: indexing a device
        tensor row by row would copy each field of each row on its own."""
        final = S.state_to_numpy(final)
        for j, gi in enumerate(idxs):
            r = reqs[gi]
            ms = state_row_to_mutable_state(
                final, j, packed.side[j],
                domain_id=r.domain_id, epoch_s=packed.epoch_s,
            )
            ms.execution_info.branch_token = r.branch_token
            transfer, timer = refresh_tasks(ms)
            out[gi] = (ms, transfer, timer)
            self._record_checkpoint(r, packed, final, j)
