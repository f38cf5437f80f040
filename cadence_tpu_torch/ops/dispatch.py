"""Pipelined host→device replay dispatch.

While the GPU replays batch k, a pack thread packs batch k+1, stages its
tensors in pinned host memory and copies them to the device on a copy
stream of their own. An event recorded after the copy orders it before
the replay, which runs on the device's current stream in a second
thread; the bounded stage queue (``depth``) is the double-buffer
backpressure.

Two storm levers ride on top of the pipeline, as in the reference
package's ``ops/dispatch.py``:

* **ragged lane packing** (``lane_pack=True``): several whole histories
  share each lane (``ops/pack.pack_lanes``) and the replay takes the
  kernel's packed route, one launch per batch that flushes each finished
  history at its own last step;
* **depth bucketing** (``replay_stream(bucket=True)``): histories sort
  into geometric depth classes first, so a few deep stragglers don't
  stretch every lane.

Under ``scan_mode="assoc"`` a batch whose event types are all provably
affine replays in parallel in time (``ops/assoc.py``, the default
``impl="resolve"``): unpacked batches in ``hist_assoc`` mode, lane-packed
ones in ``lanes_assoc`` mode, staged through the same pinned copy
stream. A batch with a nonaffine type keeps the sequential kernel.
``"auto"`` and ``"scan"`` always run the sequential kernel.

Device-step telemetry (``utils/metrics_defs.DEVICE_METRICS``) is off
unless a metrics scope is wired in (``metrics=``, not None and not the
shared ``NOOP``). Then every batch reports its staging time, padding,
lane occupancy and width as it is staged, and its step time once the
replay's stream has finished it: the run pump synchronises that stream
after each batch, which is the cost of the mode (the pack pump still
overlaps). The batch's tags are ``layer=device``, ``kernel=cuda`` on the
card or ``kernel=plain`` on the CPU, and its ``mode``.

Usage::

    with DeviceDispatcher(caps) as d:
        for i, batch in enumerate(batches):
            d.submit(i, batch)
        d.finish()
        for batch_id, packed, final in d.results():
            ...  # final: torch StateTensors on the device
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from time import perf_counter
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.log import get_logger
from ..utils.metrics import NOOP, Scope
from . import _build
from . import schema as S
from .assoc import _assoc_core, assoc_lanes_operands, classify_types
from .grid import round_scan_len, staging_depth
from .pack import pack_histories, pack_lanes
from .replay import check_scan_mode, type_signature
from .replay_cuda import narrow_events_teb, replay_scan_packed, replay_scan_teb

_log = get_logger("cadence_tpu_torch.ops.dispatch")

# the growth baseline of the loaded kernel libraries (jit_retraces) lives
# at module scope, as the libraries do: the rebuilder builds a dispatcher
# per rebuild_many call, and a baseline per dispatcher would miss a load
# that happens between two of them
_libs_baseline_lock = threading.Lock()
_libs_prev: Optional[int] = None


def _libs_growth(entries: int) -> int:
    global _libs_prev
    with _libs_baseline_lock:
        prev = _libs_prev
        _libs_prev = entries
    if prev is not None and entries > prev:
        return entries - prev
    return 0


class DispatchError(Exception):
    def __init__(self, batch_id, cause: BaseException) -> None:
        super().__init__(f"batch {batch_id}: {cause!r}")
        self.batch_id = batch_id
        self.cause = cause


def history_depth(batches) -> int:
    """Total event count of one history (its replay depth)."""
    return sum(len(b) for b in batches)


def depth_buckets(
    histories: Sequence[Tuple],
) -> List[Tuple[Tuple[int, ...], List[Tuple]]]:
    """Sort histories by depth and group them into geometric depth
    buckets (``round_scan_len`` grid), shallowest first.

    Returns ``[(original_indices, bucket_histories), ...]`` so callers
    can reassemble results in submission order."""
    keyed = sorted(
        range(len(histories)),
        key=lambda i: (round_scan_len(history_depth(histories[i][2])), i),
    )
    out: List[Tuple[Tuple[int, ...], List[Tuple]]] = []
    cur_key = None
    for i in keyed:
        key = round_scan_len(history_depth(histories[i][2]))
        if key != cur_key:
            out.append(((), []))
            cur_key = key
        idxs, hs = out[-1]
        out[-1] = (idxs + (i,), hs)
        hs.append(histories[i])
    return out


@dataclasses.dataclass
class _Staged:
    """One packed batch, its tensors on their way to the device.

    ``mode``: "hist" / "lanes" (the sequential kernel's unpacked and
    packed routes) or "hist_assoc" / "lanes_assoc" (the parallel-in-time
    replay; ``events`` then stays batch-major [L, T, EV_N] int32)."""

    batch_id: Any
    packed: Any
    mode: str
    events: torch.Tensor
    base: Optional[np.ndarray]
    wide_cols: tuple
    state0: S.StateTensors
    init: Optional[S.StateTensors]   # lanes mode, checkpoint resume
    ready: Optional[torch.cuda.Event]   # None on the CPU
    rows: int                        # result rows that hold histories
    # lanes_assoc: (hist_bm, seg_pos, seg_lane, seg_start) on the device
    geometry: tuple = ()
    types: Optional[tuple] = None    # assoc modes: the type signature

    def tensors(self):
        """Every device tensor of the batch."""
        out = [self.events, *self.geometry]
        for st in (self.state0, self.init):
            if st is not None:
                out += [getattr(st, f) for f in S.STATE_ROW_FIELDS]
        return out


class DeviceDispatcher:
    """Pipelines pack (host) → H2D (copy stream) → replay (device).

    ``depth`` bounds how many packed batches may be staged ahead of the
    device; 2 is classic double buffering. ``narrow`` streams events as
    the int16 narrow stream where a batch allows it (half the bytes of
    both the copy and the kernel's event stream; bit-identical result).
    ``tb``: lane packing aligns segments to it (``pack_lanes(seg_align=
    tb)``, as the reference dispatcher packs); the packed route itself
    needs no alignment. ``scan_mode="assoc"`` sends affine batches to the
    parallel-in-time replay (module docstring). ``metrics``: a ``Scope``
    for the device-step telemetry (module docstring); None or ``NOOP``
    turns it off, and then the pumps neither time nor synchronise
    anything. Results come back in submission order from
    :meth:`results`."""

    def __init__(
        self,
        caps: Optional[S.Capacities] = None,
        depth: int = 2,
        narrow: bool = True,
        domain_resolver=None,
        tb: int = 16,
        lane_pack: bool = False,
        lane_len: Optional[int] = None,
        scan_mode: str = "auto",
        metrics: Optional[Scope] = None,
        device="cuda",
    ) -> None:
        check_scan_mode(scan_mode)
        self.caps = caps or S.Capacities()
        self.device = S.resolve_device(device)
        self._telemetry = metrics is not None and metrics is not NOOP
        self._metrics = (metrics if metrics is not None else NOOP).tagged(
            layer="device")
        self._kernel_tag = "cuda" if self.device.type == "cuda" else "plain"
        self.narrow = narrow
        # threaded into pack_workflow: side-table target domains must be
        # resolved ids
        self.domain_resolver = domain_resolver
        self.tb = tb
        self.lane_pack = lane_pack
        self.lane_len = lane_len
        self.scan_mode = scan_mode
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._in: "queue.Queue" = queue.Queue()
        self._staged: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._out: "queue.Queue" = queue.Queue()
        self._packer = threading.Thread(
            target=self._pack_pump, name="dispatch-pack", daemon=True)
        self._runner = threading.Thread(
            target=self._run_pump, name="dispatch-run", daemon=True)
        self._started = False
        self._finished = False
        self._drained = False

    # -- producer side --------------------------------------------------

    def submit(self, batch_id, histories: Sequence[Tuple],
               resume=None) -> None:
        """Enqueue one batch of (workflow_id, run_id, event_batches).

        ``resume``: optional per-history sequence of
        Optional[ops.pack.ResumeState]: resumed histories' events are
        their suffix, and the replay seeds them from the snapshot rows."""
        if not self._started:
            self._packer.start()
            self._runner.start()
            self._started = True
        self._in.put((batch_id, histories, resume))

    def finish(self) -> None:
        """No more submits; results() ends after the queued work.
        Idempotent."""
        if not self._finished:
            self._finished = True
            self._in.put(None)

    # -- pipeline stages -------------------------------------------------

    def _pack_pump(self) -> None:
        while True:
            item = self._in.get()
            if item is None:
                self._staged.put(None)
                return
            batch_id, histories, resume = item
            try:
                t0 = perf_counter() if self._telemetry else 0.0
                staged = self._pack(batch_id, histories, resume)
                if self._telemetry:
                    self._emit(self._emit_stage_telemetry, staged,
                               histories, perf_counter() - t0)
                # blocks when `depth` batches are already staged
                self._staged.put(staged)
            except Exception as e:
                self._staged.put(DispatchError(batch_id, e))

    def _pack(self, batch_id, histories, resume) -> _Staged:
        assoc = self.scan_mode == "assoc"
        present = None
        if self.lane_pack:
            packed = pack_lanes(
                histories, caps=self.caps, target_lane_len=self.lane_len,
                seg_align=self.tb, domain_resolver=self.domain_resolver,
                resume=resume)
            rows = packed.n_histories
            if assoc:
                present = packed.present_types
        else:
            # the assoc modes pad the batch to the round_scan_len grid, as
            # the reference dispatcher does
            packed = pack_histories(
                histories, caps=self.caps,
                pad_batch_to=round_scan_len(len(histories)) if assoc
                else None,
                domain_resolver=self.domain_resolver, resume=resume)
            rows = len(histories)
            if assoc:
                present = [int(t) for t in
                           np.unique(packed.events[:, :, S.EV_TYPE])
                           if t >= 0]
        # each batch decides on its own type set: one batch with a
        # nonaffine type must not send later batches to the sequential
        # kernel
        if present is not None and not classify_types(present)[1]:
            return self._stage_assoc(batch_id, packed, rows, present)
        return self._stage_scan(batch_id, packed, rows)

    def _stage_assoc(self, batch_id, packed, rows: int,
                     present) -> _Staged:
        """Stage a batch for the parallel-in-time replay: batch-major
        int32 events, the initial rows and, lane-packed, the segment
        geometry. The replay skips the masks of groups ``present`` does
        not touch."""
        if self.lane_pack:
            init, *geometry = assoc_lanes_operands(packed)
        else:
            init = (packed.initial if packed.initial is not None
                    else S.empty_state(packed.batch, self.caps))
            geometry = []
        host = ([packed.events] + [getattr(init, f)
                                   for f in S.STATE_ROW_FIELDS] + geometry)
        dev, ready = self._to_device(host)
        n = len(S.STATE_ROW_FIELDS)
        return _Staged(
            batch_id=batch_id, packed=packed,
            mode="lanes_assoc" if self.lane_pack else "hist_assoc",
            events=dev[0], base=None, wide_cols=(),
            state0=S.StateTensors(*dev[1 : 1 + n]), init=None, ready=ready,
            geometry=tuple(dev[1 + n :]),
            types=type_signature(present), rows=rows)

    def _stage_scan(self, batch_id, packed, rows: int) -> _Staged:
        """Stage a batch for the sequential kernel: the field-major event
        stream (int16 where the batch narrows) and the lane carries."""
        init = None
        if self.lane_pack:
            state0 = packed.lane_state0()
            init = packed.initial
        else:
            state0 = (packed.initial if packed.initial is not None
                      else S.empty_state(packed.batch, self.caps))
        teb, base, wide = packed.teb(), None, ()
        narrowed = narrow_events_teb(teb) if self.narrow else None
        if narrowed is not None:
            teb, base, wide = narrowed
        host = [teb] + [getattr(state0, f) for f in S.STATE_ROW_FIELDS]
        if init is not None:
            host += [getattr(init, f) for f in S.STATE_ROW_FIELDS]
        dev, ready = self._to_device(host)
        n = len(S.STATE_ROW_FIELDS)
        return _Staged(
            batch_id=batch_id, packed=packed,
            mode="lanes" if self.lane_pack else "hist", events=dev[0],
            base=base, wide_cols=wide,
            state0=S.StateTensors(*dev[1 : 1 + n]),
            init=S.StateTensors(*dev[1 + n :]) if init is not None else None,
            ready=ready, rows=rows)

    def _to_device(self, arrays):
        """Copy host arrays to the device: staged in pinned memory and
        copied on the copy stream. Returns (tensors, ready event)."""
        tensors = [S.host_tensor(a) for a in arrays]
        if self._copy_stream is None:
            return tensors, None
        with torch.cuda.stream(self._copy_stream):
            dev = [t.pin_memory().to(self.device, non_blocking=True)
                   for t in tensors]
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return dev, ready

    def _run_pump(self) -> None:
        while True:
            item = self._staged.get()
            if item is None:
                self._out.put(None)
                return
            if isinstance(item, DispatchError):
                self._out.put(item)
                continue
            try:
                t0 = perf_counter() if self._telemetry else 0.0
                final = self._replay(item)
                if self._telemetry:
                    if item.ready is not None:
                        # the step ends when the replay's stream has run
                        # it; a fault of the replay raises here, as it
                        # would where the result is read
                        torch.cuda.current_stream(self.device).synchronize()
                    self._emit(self._emit_step_telemetry, item.mode,
                               perf_counter() - t0)
                self._out.put((item.batch_id, item.packed, final))
            except Exception as e:
                self._out.put(DispatchError(item.batch_id, e))

    # -- device-step telemetry ---------------------------------------------

    def _emit(self, emission, *args) -> None:
        """Run one emission: a fault of the telemetry never fails the
        batch it describes."""
        try:
            emission(*args)
        except Exception as e:
            _log.debug("device telemetry emission failed", error=repr(e))

    def _device_scope(self, mode: str) -> Scope:
        return self._metrics.tagged(kernel=self._kernel_tag, mode=mode)

    def _emit_stage_telemetry(self, staged: _Staged, histories,
                              stage_s: float) -> None:
        """A staged batch: pack and H2D enqueue time, padding, lane
        occupancy and width, by the reference dispatcher's definitions."""
        scope = self._device_scope(staged.mode)
        scope.inc("device_batches")
        scope.record("host_stage_seconds", stage_s)
        packed = staged.packed
        if staged.mode.startswith("lanes"):
            # the packer's own waste and occupancy
            padding = packed.padding_frac
            width = packed.lanes
            if packed.lanes:
                scope.gauge("lane_occupancy",
                            packed.n_histories / packed.lanes)
        else:
            cells = packed.batch * packed.events.shape[1]
            real = sum(history_depth(h[2]) for h in histories)
            padding = (cells - real) / max(real, 1)
            width = packed.batch
        scope.gauge("padding_frac", padding)
        scope.tagged(width=str(width)).inc("batch_width")

    def _emit_step_telemetry(self, mode: str, step_s: float) -> None:
        """A replayed batch: its step time, and the kernel libraries
        loaded so far with their growth since the last batch: the port's
        counterpart of the reference's jit caches (a library loaded on
        the serving path is its compile), read without building
        anything; 0 on the CPU."""
        self._device_scope(mode).record("device_step_seconds", step_s)
        entries = len(_build._libs)
        self._metrics.gauge("jit_cache_entries", entries)
        grown = _libs_growth(entries)
        if grown:
            self._metrics.inc("jit_retraces", grown)

    def _replay(self, item: _Staged) -> S.StateTensors:
        if item.ready is not None:
            # the replay waits for its copy; the tensors were allocated
            # on the copy stream, so tell the allocator they are used here
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(item.ready)
            for t in item.tensors():
                t.record_stream(cur)
        packed = item.packed
        if item.mode in ("hist_assoc", "lanes_assoc"):
            # field-major column planes, transposed on the device
            evf = item.events.permute(2, 0, 1).contiguous()
            final = _assoc_core(evf, item.state0, *item.geometry,
                                types=item.types)
        elif item.mode == "hist":
            final = replay_scan_teb(item.state0, item.events, self.caps,
                                    base=item.base, wide_cols=item.wide_cols)
        else:
            out0 = S.state_from_numpy(
                S.empty_state(packed.n_histories, self.caps), self.device)
            kw = {}
            if item.init is not None:
                kw = dict(init=item.init, reset_row=packed.reset_rows())
            _, final = replay_scan_packed(
                item.state0, out0, item.events, packed.seg_end,
                packed.out_row, self.caps, base=item.base,
                wide_cols=item.wide_cols, **kw)
        if final.batch > item.rows:
            final = final.map(lambda x: x[: item.rows])
        return final

    # -- consumer side ----------------------------------------------------

    def results(self, strict: bool = True) -> Iterator[Tuple]:
        """Yields (batch_id, packed, final_state) in submission order.

        A failed batch raises its DispatchError when its turn comes
        (strict, default) or is yielded as the DispatchError itself
        (strict=False) so the caller can fall back per batch and keep
        consuming. On a strict raise the remaining queues are drained in
        the background first: the consumer abandons the iterator at the
        raise, and without the drain the pack pump could block forever on
        a full stage queue."""
        while True:
            item = self._out.get()
            if item is None:
                self._drained = True
                return
            if isinstance(item, DispatchError):
                if strict:
                    self._drain_async()
                    raise item
                yield item
                continue
            yield item

    def _drain_async(self) -> None:
        """Consume everything still in flight on a daemon thread so the
        pumps run to completion and exit; idempotent."""
        if self._drained:
            return
        self._drained = True
        self.finish()

        def _run() -> None:
            while self._out.get() is not None:
                pass

        threading.Thread(
            target=_run, name="dispatch-drain", daemon=True).start()

    def __enter__(self) -> "DeviceDispatcher":
        return self

    def __exit__(self, *exc) -> None:
        if not self._started:
            return
        self.finish()
        if not self._drained:
            # drain so the pumps exit even on abnormal exit
            while self._out.get() is not None:
                pass
            self._drained = True
        # a pump still inside a torch op when the interpreter exits
        # aborts the process, so leave none running
        self._packer.join()
        self._runner.join()


def replay_stream(
    histories: Sequence[Tuple],
    caps: Optional[S.Capacities] = None,
    batch_size: int = 4096,
    depth: int = 2,
    lane_pack: bool = False,
    lane_len: Optional[int] = None,
    bucket: bool = False,
    resume: Optional[Sequence] = None,
    scan_mode: str = "auto",
    narrow: bool = True,
    metrics: Optional[Scope] = None,
    device="cuda",
) -> List[Tuple]:
    """Replay a large history stream through the pipelined dispatcher.

    Splits ``histories`` into ``batch_size`` chunks and returns
    [(packed, final_state), ...] in order; ``final_state`` is a torch
    StateTensors on ``device``, one row per history of the chunk.

    ``bucket=True`` (implies lane packing) sorts the stream into
    geometric depth buckets first; the return value then carries the
    original indices per batch: [(indices, packed, final_state), ...]
    where row j of ``final_state`` is history ``indices[j]``.

    ``resume``: optional per-history Optional[ops.pack.ResumeState]
    aligned with ``histories``: resumed entries carry their event suffix
    and replay from the snapshot row; a resumed run buckets by its suffix
    depth. ``metrics``: the dispatcher's device-step telemetry scope."""
    out: List[Tuple] = []
    resume = list(resume) if resume is not None else [None] * len(histories)
    if len(resume) != len(histories):
        raise ValueError("resume list must align with histories")
    any_resume = any(r is not None for r in resume)
    if bucket:
        plan: List[Tuple] = []
        for idxs, hs in depth_buckets(histories):
            for j in range(0, len(hs), batch_size):
                plan.append((idxs[j : j + batch_size],
                             hs[j : j + batch_size]))
        if not plan:
            return out
        with DeviceDispatcher(
                caps=caps, depth=staging_depth(len(plan), depth),
                narrow=narrow, lane_pack=True, lane_len=lane_len,
                scan_mode=scan_mode, metrics=metrics, device=device) as d:
            for sub, hs in plan:
                d.submit(sub, hs, resume=[resume[i] for i in sub]
                         if any_resume else None)
            d.finish()
            out.extend(d.results())
        return out
    if not histories:
        return out
    n_batches = -(-len(histories) // batch_size)
    with DeviceDispatcher(
            caps=caps, depth=staging_depth(n_batches, depth), narrow=narrow,
            lane_pack=lane_pack, lane_len=lane_len, scan_mode=scan_mode,
            metrics=metrics, device=device) as d:
        for i in range(0, len(histories), batch_size):
            d.submit(i, histories[i : i + batch_size],
                     resume=resume[i : i + batch_size] if any_resume
                     else None)
        d.finish()
        out.extend((packed, final) for _, packed, final in d.results())
    return out
