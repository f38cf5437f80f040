"""Bandwidth-adaptive replication transport.

The geographic-SMR state-transfer adaptation ("A State Transfer Method
That Adapts to Network Bandwidth Variations in Geographic SMR",
PAPERS.md): a standby cluster behind a slow or lossy WAN link should
switch between **event-stream shipping** (the NDC pull plane's normal
mode — cheap on healthy links, O(backlog bytes) on degraded ones) and
**snapshot shipping** (a delta-compressed ``ReplayCheckpoint`` row per
workflow, applied through the existing suffix-only resume path) per the
measured link budget.

Three pieces, all consumer-side:

* ``LinkEstimator`` — EWMA observations of every transfer on one link
  (bytes, wall seconds → bandwidth; events per fetch → bytes/event;
  snapshot blob sizes and apply times), plus the lag view derived from
  the ``source_time_ns`` clock every ``ReplicationMessages`` carries.
* ``ReplicationModeController`` — the decision rule with hysteresis.
  For a catch-up gap of G events the estimated costs are::

      t_events   = G * bytes_per_event / bandwidth
      t_snapshot = snapshot_bytes / bandwidth + snapshot_apply_s

  Snapshot mode is chosen when ``t_snapshot * hysteresis < t_events``
  for ``min_dwell`` consecutive decisions (and back symmetrically), so
  a noisy estimate cannot flap the mode; with no bandwidth sample yet
  the controller always answers "events" (the safe default — event
  shipping is the correctness baseline).
* ``AdaptiveTransport`` — one per (remote cluster) link: owns the
  estimator + controller, wraps the remote client's snapshot/backlog
  calls with byte/latency measurement, and serializes checkpoints for
  the wire.

Checkpoint wire codec: the state-row int32 tensors (the bulk of a
``ReplayCheckpoint``) ship through the ``native`` varint+zigzag delta
codec (``tensor_compress``); the remainder rides the persistence serde
JSON. Decode validates shapes and falls back loudly — a torn or
corrupt snapshot transfer must degrade to event shipping, never apply
garbage state.

A copy of the reference package's ``runtime/replication/transport.py``
over the port's ``checkpoint/record.ReplayCheckpoint``, its sidecar's
codec (``native.tensor_compress``) and its copy of the wire codec
(``rpc/codec``). The checkpoint's fingerprint covers the port's CUDA
sources, so a snapshot ships and installs only between port clusters.
Deviation: ``decode_checkpoint_wire`` raises ``CheckpointWireError`` (a
``ValueError``) for any malformed blob, so the snapshot path's fallback
can name a bad blob without catching every ``ValueError``.
"""

from __future__ import annotations

import base64
import json
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ...utils.log import get_logger
from ...utils.metrics import NOOP

logger = get_logger("cadence_tpu_torch.replication.transport")

MODE_EVENTS = "events"
MODE_SNAPSHOT = "snapshot"


# ---------------------------------------------------------------------------
# wire sizing + checkpoint codec
# ---------------------------------------------------------------------------


def wire_size(payload: Any) -> int:
    """Honest byte count of one replication transfer: what the rpc
    codec would put on the wire. ``bytes`` payloads (already-encoded
    snapshot blobs) are counted as-is. The size is cached on the
    payload where the object allows it — a fetched page is measured by
    both the chaos link and the consumer's estimator, and re-encoding
    a large event batch twice per cycle is pure waste."""
    if payload is None:
        return 0
    if isinstance(payload, (bytes, bytearray)):
        return len(payload)
    cached = getattr(payload, "_wire_size", None)
    if cached is not None:
        return cached
    from ...rpc import codec

    try:
        n = len(codec.dumps(payload))
    except TypeError:
        # non-wire type (in-process test double): coarse repr estimate
        n = len(repr(payload))
    try:
        payload._wire_size = n
    except (AttributeError, TypeError):
        pass  # tuples/dicts can't carry the cache; recompute is fine
    return n


_WIRE_VERSION = 1


class CheckpointWireError(ValueError):
    """A snapshot blob that does not decode: torn, truncated or
    corrupt on the wire, or of an unknown wire version."""


def encode_checkpoint_wire(ckpt) -> bytes:
    """``ReplayCheckpoint`` → compressed wire blob. The int32 state-row
    tensors ride the native varint+zigzag delta codec; everything else
    (resume tables, side table, version history) rides the persistence
    serde JSON the record already defines."""
    from ... import native

    meta = json.loads(ckpt.to_json())
    rows = meta.pop("state_row")
    packed: Dict[str, Dict[str, Any]] = {}
    for name, values in rows.items():
        arr = np.asarray(values, dtype=np.int32)
        blob, shape = native.tensor_compress(arr)
        packed[name] = {
            "b": base64.b64encode(blob).decode(),
            "shape": list(shape),
        }
    return json.dumps(
        {"v": _WIRE_VERSION, "meta": meta, "rows": packed}
    ).encode()


def decode_checkpoint_wire(raw: bytes):
    """Wire blob → ``ReplayCheckpoint``. Raises ``CheckpointWireError``
    on any truncation/corruption (the codec validates element counts),
    which the callers translate into the event-shipping fallback."""
    from ... import native
    from ...checkpoint.record import ReplayCheckpoint

    try:
        frame = json.loads(raw.decode())
        if frame.get("v") != _WIRE_VERSION:
            raise CheckpointWireError(
                f"checkpoint wire: unknown version {frame.get('v')!r}"
            )
        meta = frame["meta"]
        rows: Dict[str, list] = {}
        for name, rec in frame["rows"].items():
            blob = base64.b64decode(rec["b"])
            arr = native.tensor_decompress(blob, tuple(rec["shape"]))
            rows[name] = arr.tolist()
        meta["state_row"] = rows
        return ReplayCheckpoint.from_json(json.dumps(meta))
    except CheckpointWireError:
        raise
    except (ValueError, KeyError, TypeError, AttributeError) as e:
        raise CheckpointWireError(f"checkpoint wire: {e}") from e


# ---------------------------------------------------------------------------
# link estimation
# ---------------------------------------------------------------------------


class LinkEstimator:
    """EWMA view of one replication link, fed by the consumer around
    every remote call. Thread-safe: several shards' processors share
    one link (one fetcher per remote cluster)."""

    # priors used before the first observation of each kind; chosen so
    # an unobserved link never prefers snapshots (bandwidth None gates
    # the controller anyway)
    BYTES_PER_EVENT_PRIOR = 512.0
    BYTES_PER_TASK_PRIOR = 2048.0
    SNAPSHOT_BYTES_PRIOR = 64 * 1024.0
    SNAPSHOT_APPLY_S_PRIOR = 0.05

    def __init__(self, alpha: float = 0.3) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError("estimator alpha must be in (0, 1]")
        self.alpha = alpha
        self._lock = threading.Lock()
        self._bandwidth_bps: Optional[float] = None
        self._bytes_per_event: Optional[float] = None
        self._bytes_per_task: Optional[float] = None
        self._snapshot_bytes: Optional[float] = None
        self._snapshot_apply_s: Optional[float] = None
        self.bytes_total = 0
        self.lag_events = 0
        self.lag_seconds = 0.0

    def _ewma(self, prev: Optional[float], sample: float) -> float:
        if prev is None:
            return sample
        return prev + self.alpha * (sample - prev)

    # -- observations --------------------------------------------------

    def observe_transfer(self, nbytes: int, seconds: float,
                         n_events: int = 0, n_tasks: int = 0) -> None:
        """One completed transfer on the link (any payload kind)."""
        with self._lock:
            self.bytes_total += max(0, nbytes)
            if nbytes > 0 and seconds > 1e-6:
                self._bandwidth_bps = self._ewma(
                    self._bandwidth_bps, nbytes / seconds
                )
            if n_events > 0 and nbytes > 0:
                self._bytes_per_event = self._ewma(
                    self._bytes_per_event, nbytes / n_events
                )
            if n_tasks > 0 and nbytes > 0:
                self._bytes_per_task = self._ewma(
                    self._bytes_per_task, nbytes / n_tasks
                )

    def observe_snapshot(self, nbytes: int, apply_seconds: float) -> None:
        with self._lock:
            if nbytes > 0:
                self._snapshot_bytes = self._ewma(
                    self._snapshot_bytes, float(nbytes)
                )
            if apply_seconds > 0:
                self._snapshot_apply_s = self._ewma(
                    self._snapshot_apply_s, apply_seconds
                )

    def observe_lag(self, lag_events: int, lag_seconds: float) -> None:
        with self._lock:
            self.lag_events = max(0, lag_events)
            self.lag_seconds = max(0.0, lag_seconds)

    # -- views ---------------------------------------------------------

    def bandwidth_bps(self) -> Optional[float]:
        with self._lock:
            return self._bandwidth_bps

    def bytes_per_event(self) -> float:
        with self._lock:
            return self._bytes_per_event or self.BYTES_PER_EVENT_PRIOR

    def bytes_per_task(self) -> float:
        with self._lock:
            return self._bytes_per_task or self.BYTES_PER_TASK_PRIOR

    def snapshot_bytes(self) -> float:
        with self._lock:
            return self._snapshot_bytes or self.SNAPSHOT_BYTES_PRIOR

    def snapshot_apply_s(self) -> float:
        with self._lock:
            return self._snapshot_apply_s or self.SNAPSHOT_APPLY_S_PRIOR

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "bandwidth_bps": self._bandwidth_bps,
                "bytes_per_event": self._bytes_per_event,
                "bytes_per_task": self._bytes_per_task,
                "snapshot_bytes": self._snapshot_bytes,
                "snapshot_apply_s": self._snapshot_apply_s,
                "bytes_total": self.bytes_total,
                "lag_events": self.lag_events,
                "lag_seconds": self.lag_seconds,
            }


class ReplicationModeController:
    """Event-vs-snapshot decision with hysteresis.

    The mode is LINK-WIDE (one controller per remote cluster, like the
    estimator); ``decide(gap_events)`` evaluates one catch-up decision
    and returns the mode to use for that gap. Switching requires the
    challenger mode to win the cost comparison by ``hysteresis`` for
    ``min_dwell`` CONSECUTIVE decisions — a single burst of noise in
    the bandwidth EWMA cannot flap the mode. Gaps below
    ``min_gap_events`` always ship events (a snapshot cannot beat a
    handful of events no matter the link)."""

    def __init__(
        self,
        estimator: LinkEstimator,
        hysteresis: float = 1.5,
        min_dwell: int = 2,
        min_gap_events: int = 32,
        force_mode: Optional[str] = None,
        metrics=None,
    ) -> None:
        if hysteresis < 1.0:
            raise ValueError("controller hysteresis must be >= 1.0")
        if min_dwell < 1:
            raise ValueError("controller min_dwell must be >= 1")
        self.estimator = estimator
        self.hysteresis = hysteresis
        self.min_dwell = min_dwell
        self.min_gap_events = min_gap_events
        # pin the mode (bench comparison arms); None = adaptive
        self.force_mode = force_mode
        self._lock = threading.Lock()
        self.mode = MODE_EVENTS
        self.switches = 0
        self._streak = 0
        self._metrics = (metrics or NOOP).tagged(layer="replication")

    def _preferred(self, gap_events: int) -> str:
        """Raw (hysteresis-free) cost comparison for one gap."""
        est = self.estimator
        bw = est.bandwidth_bps()
        if bw is None or bw <= 0:
            return MODE_EVENTS
        t_events = gap_events * est.bytes_per_event() / bw
        t_snap = est.snapshot_bytes() / bw + est.snapshot_apply_s()
        challenger = MODE_SNAPSHOT if self.mode == MODE_EVENTS else MODE_EVENTS
        if challenger == MODE_SNAPSHOT:
            return (
                MODE_SNAPSHOT
                if t_snap * self.hysteresis < t_events
                else MODE_EVENTS
            )
        return (
            MODE_EVENTS
            if t_events * self.hysteresis < t_snap
            else MODE_SNAPSHOT
        )

    def decide(self, gap_events: int) -> str:
        if self.force_mode is not None:
            return self.force_mode
        if gap_events < self.min_gap_events:
            # a below-floor gap ships events AND breaks any pending
            # switch streak — min_dwell means CONSECUTIVE qualifying
            # wins, not wins bridged across unrelated small gaps
            with self._lock:
                self._streak = 0
            return MODE_EVENTS
        with self._lock:
            want = self._preferred(gap_events)
            if want == self.mode:
                self._streak = 0
                return self.mode
            self._streak += 1
            if self._streak < self.min_dwell:
                return self.mode
            self.mode = want
            self._streak = 0
            self.switches += 1
        self._metrics.inc("replication_mode_switches")
        self._metrics.gauge(
            "replication_mode", 1 if want == MODE_SNAPSHOT else 0
        )
        return want


# ---------------------------------------------------------------------------
# the per-link transport bundle
# ---------------------------------------------------------------------------


class AdaptiveTransport:
    """One remote cluster's adaptive replication plane, shared by every
    shard's processor the way the fetcher is (the estimator/controller
    describe the LINK, not a shard).

    ``client`` is the fetcher's ``RemoteClusterClient``; the two extra
    verbs (``get_replication_backlog`` / ``get_replication_checkpoint``)
    are probed lazily so a transport pointed at a pre-adaptive remote
    degrades to pure event shipping instead of erroring."""

    def __init__(
        self,
        client: Any,
        cluster: str,
        hysteresis: float = 1.5,
        min_dwell: int = 2,
        min_gap_events: int = 32,
        snapshot_bytes_prior: float = 64 * 1024.0,
        force_mode: Optional[str] = None,
        metrics=None,
    ) -> None:
        self.client = client
        self.cluster = cluster
        self.estimator = LinkEstimator()
        self.estimator.SNAPSHOT_BYTES_PRIOR = float(snapshot_bytes_prior)
        self._metrics = (metrics or NOOP).tagged(
            layer="replication", cluster=cluster
        )
        self.controller = ReplicationModeController(
            self.estimator,
            hysteresis=hysteresis,
            min_dwell=min_dwell,
            min_gap_events=min_gap_events,
            force_mode=force_mode,
            metrics=self._metrics,
        )

    # -- measured remote calls ----------------------------------------

    def _measured(self, payload: Any, t0: float, n_events: int = 0,
                  mode: str = MODE_EVENTS) -> int:
        nbytes = wire_size(payload)
        self.estimator.observe_transfer(
            nbytes, time.monotonic() - t0, n_events=n_events
        )
        self._metrics.tagged(mode=mode).inc(
            "replication_bytes_shipped", nbytes
        )
        return nbytes

    def observe_messages(self, msgs, seconds: float) -> None:
        """Account one regular fetch cycle (the processor performs the
        call; the transport does the bookkeeping)."""
        n_events = sum(len(t.events) for t in msgs.tasks)
        nbytes = wire_size(msgs)
        self.estimator.observe_transfer(
            nbytes, seconds, n_events=n_events, n_tasks=len(msgs.tasks)
        )
        self._metrics.tagged(mode=MODE_EVENTS).inc(
            "replication_bytes_shipped", nbytes
        )

    # -- dynamic fetch paging -----------------------------------------

    # one fetch should occupy the link for about this long; on a
    # throttled link the page shrinks accordingly instead of one huge
    # hydrated page timing out (or sleeping the chaos link for minutes)
    FETCH_TARGET_S = 2.0
    MIN_FETCH_PAGE = 4
    MAX_FETCH_PAGE = 512

    def page_size(self) -> Optional[int]:
        """Per-link emit-page cap for the next fetch, from the measured
        bandwidth and bytes-per-task EWMAs: the task count whose
        hydrated bytes fit ``FETCH_TARGET_S`` of link time, clamped to
        [MIN_FETCH_PAGE, MAX_FETCH_PAGE]. None before the first
        bandwidth sample — the emit side's static default applies (an
        unmeasured link is not presumed slow)."""
        bw = self.estimator.bandwidth_bps()
        if bw is None or bw <= 0:
            return None
        tasks = int(bw * self.FETCH_TARGET_S / self.estimator.bytes_per_task())
        page = max(self.MIN_FETCH_PAGE, min(self.MAX_FETCH_PAGE, tasks))
        self._metrics.gauge("replication_fetch_page_limit", page)
        return page

    def fetch_backlog(self, shard_id: int,
                      last_retrieved_id: int) -> Optional[dict]:
        """Per-run backlog spans past the cursor (tiny transfer — no
        event payloads), or None when the remote lacks the verb."""
        fn = getattr(self.client, "get_replication_backlog", None)
        if fn is None:
            return None
        t0 = time.monotonic()
        summary = fn(shard_id, last_retrieved_id)
        self._measured(summary, t0)
        return summary

    def fetch_snapshot(self, domain_id: str, workflow_id: str,
                       run_id: str) -> Optional[Tuple[Any, int]]:
        """(decoded ReplayCheckpoint, wire bytes), or None when the
        remote lacks the verb or has no shippable snapshot."""
        fn = getattr(self.client, "get_replication_checkpoint", None)
        if fn is None:
            return None
        t0 = time.monotonic()
        raw = fn(domain_id, workflow_id, run_id)
        if not raw:
            return None
        nbytes = self._measured(raw, t0, mode=MODE_SNAPSHOT)
        ckpt = decode_checkpoint_wire(raw)
        return ckpt, nbytes

    def fetch_raw_history(self, domain_id: str, workflow_id: str,
                          run_id: str, start_event_id: int,
                          end_event_id: int):
        t0 = time.monotonic()
        batches, items = self.client.get_workflow_history_raw(
            domain_id, workflow_id, run_id, start_event_id, end_event_id
        )
        self._measured(
            (batches, items), t0,
            n_events=sum(len(b) for b in batches),
        )
        return batches, items

    # -- lag bookkeeping ----------------------------------------------

    def record_lag(self, lag_events: int, lag_seconds: float) -> None:
        self.estimator.observe_lag(lag_events, lag_seconds)
        self._metrics.gauge("replication_lag_events", max(0, lag_events))
        self._metrics.gauge(
            "replication_lag_seconds", max(0.0, lag_seconds)
        )
