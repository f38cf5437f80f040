"""The port's serving plane against the reference package's.

The same fuzzed histories (made by the reference's ``HistoryFuzzer``,
carried into the port's events through their dict form) drive
``cadence_tpu.serving.ResidentEngine`` and the port's engine on the
plain kernel versions (``device="cpu"``) through the same admit, append,
tick and read calls. Resident rows must equal each other and a cold
replay of the full history, exactly: every value is int32 or a string,
so the tolerance is 0. The histories start hours apart, so a tick's pack
rebases lanes seated at other epochs, and the lane that starts first
skips the first round, so a lane's epoch moves from tick to tick.

Beside the differential: the generation stamp and the staged-tip
watermark, the fair admission queue's take order, the arrival schedules
and the open-loop harness against the reference's, the tick pump's
drain-on-stop, the rebuilder's resident-lane consult, the device rule,
faults of the replay that must raise instead of freeing lanes, and
concurrent ticks that must lose no Δ."""

import dataclasses
import random
import sys
import threading

import numpy as np
import pytest
import torch

from cadence_tpu.checkpoint import (
    CheckpointManager as JCheckpointManager,
    CheckpointPolicy as JCheckpointPolicy,
    MemoryCheckpointStore as JMemoryCheckpointStore,
)
from cadence_tpu.ops import schema as JS
from cadence_tpu.ops.pack import pack_histories as jpack_histories
from cadence_tpu.ops.replay import replay_packed as jreplay_packed
from cadence_tpu import serving as JSV
from cadence_tpu.serving import (
    AdmissionPolicy as JAdmissionPolicy,
    ArrivalProcess as JArrivalProcess,
    FairAdmissionQueue as JFairAdmissionQueue,
    ResidentEngine as JResidentEngine,
)
from cadence_tpu.testing.event_generator import (
    HistoryFuzzer as JHistoryFuzzer,
)
from cadence_tpu.utils import quotas as JQ
from cadence_tpu.utils.metrics import Scope as JScope

from cadence_tpu_torch.checkpoint import (
    CheckpointManager,
    CheckpointPolicy,
    MemoryCheckpointStore,
)
from cadence_tpu_torch.core import history_factory as F
from cadence_tpu_torch.core.events import HistoryEvent
from cadence_tpu_torch.core.mutable_state import SECOND
from cadence_tpu_torch.ops import replay_cuda as RC
from cadence_tpu_torch.ops import schema as S
from cadence_tpu_torch.ops.dispatch import DispatchError
from cadence_tpu_torch.ops.pack import pack_histories
from cadence_tpu_torch.ops.replay import replay_packed
from cadence_tpu_torch.ops.unpack import mutable_state_to_snapshot
from cadence_tpu_torch.runtime.persistence.memory import MemoryHistoryManager
from cadence_tpu_torch.runtime.persistence.records import BranchToken
from cadence_tpu_torch.runtime.replication.rebuilder import (
    RebuildRequest,
    StateRebuilder,
)
from cadence_tpu_torch import serving as SV
from cadence_tpu_torch.serving import (
    AdmissionPolicy,
    ArrivalProcess,
    FairAdmissionQueue,
    ResidentEngine,
    TickPump,
)
from cadence_tpu_torch.utils import quotas as Q
from cadence_tpu_torch.utils.metrics import Scope

CAPS = S.Capacities(max_events=256)
JCAPS = JS.Capacities(max_events=256)
START = 1_700_000_000 * SECOND
# histories start this far apart, so their epochs differ
EPOCH_STEP = 3607 * SECOND


def _fuzz(n, seed, target=40):
    """``n`` open fuzzed histories as (jax, port) lists of
    (workflow_id, run_id, batches)."""
    jh, ph = [], []
    for i in range(n):
        fz = JHistoryFuzzer(seed=seed + i, caps=JCAPS)
        batches = fz.generate(target_events=target + (i * 13) % 60,
                              start_time=START + i * EPOCH_STEP,
                              close=False)
        jh.append((f"wf-{i}", f"run-{i}", batches))
        ph.append((f"wf-{i}", f"run-{i}", _port(batches)))
    return jh, ph


def _port(batches):
    return [[HistoryEvent.from_dict(e.to_dict()) for e in b]
            for b in batches]


def _split(batches, k):
    """prefix + about k Δ groups covering the rest (each ≥ 1 batch)."""
    cut = max(1, len(batches) // 2)
    prefix, rest = batches[:cut], batches[cut:]
    per = max(1, len(rest) // k)
    return prefix, [rest[j : j + per] for j in range(0, len(rest), per)]


def _token(i):
    return BranchToken(tree_id=f"run-{i}",
                       branch_id=f"branch-{i}").to_json().encode()


def _cold(wf, run, batches):
    """The port's cold replay of one full history: (row, epoch_s)."""
    pk = pack_histories([(wf, run, batches)], caps=CAPS)
    return S.state_row(replay_packed(pk, device="cpu"), 0), pk.epoch_s


def _jcold(wf, run, batches):
    pk = jpack_histories([(wf, run, batches)], caps=JCAPS)
    return JS.state_row(jreplay_packed(pk), 0), pk.epoch_s


def _assert_rows_equal(got, want, msg=""):
    for f in S.STATE_ROW_FIELDS:
        np.testing.assert_array_equal(np.asarray(got[f]),
                                      np.asarray(want[f]),
                                      err_msg=f"{msg} field {f}")


def _assert_at_cold(read, cold, msg=""):
    """A resident read equals a cold (row, epoch_s): a row's timestamps
    are relative to its epoch, and a lane packed beside a lane seated
    earlier is rebased to that lane's epoch, so the read is moved to the
    cold replay's epoch first."""
    row, epoch = cold
    _assert_rows_equal(S.rebase_state_row(read.state_row,
                                          read.epoch_s - epoch),
                       row, msg=msg)


def _store(history, batches, tree):
    branch = history.new_history_branch(tree_id=tree)
    for txn, b in enumerate(batches, 1):
        history.append_history_nodes(branch, b, transaction_id=txn)
    return branch, len(batches) + 1


# ---------------------------------------------------------------------------
# the differential: the port's engine against the reference's
# ---------------------------------------------------------------------------


def _engine(make, case, caps, ckpt):
    if case == "sequential":
        return make(lanes=8, caps=caps, affine_types=frozenset())
    if case == "checkpoint":
        mgr, policy, store = ckpt
        return make(lanes=8, caps=caps, checkpoints=mgr(
            store(), policy=policy(every_events=1, keep_last=4)))
    return make(lanes=8, caps=caps)


def _drive(engine, hists, case, scope_cls):
    """Admit the prefixes, then one round a tick: every lane appends its
    next Δ, except lane 0, which skips round 0 and appends two Δs in
    round 1. ``recycle``/``checkpoint``: after round 1 every lane is
    evicted and re-admitted with its history so far (``checkpoint``
    seats from the flushed snapshots). Returns (rows, ticks, resumed)."""
    scope = scope_cls()
    engine._metrics = scope.tagged(layer="serving")
    splits = [_split(b, 4) for _, _, b in hists]
    tickets = {}
    for i, ((wf, run, _), (prefix, _)) in enumerate(zip(hists, splits)):
        tickets[i] = engine.admit("dom", wf, run, branch_token=_token(i),
                                  batches=prefix)
        assert tickets[i] is not None
    rounds = max(len(d) for _, d in splits)
    ticks = 0
    for r in range(rounds):
        for i, (prefix, deltas) in enumerate(splits):
            take = [] if (i, r) == (0, 0) else (
                [0, 1] if (i, r) == (0, 1) else [r])
            batches = [b for k in take if k < len(deltas)
                       for b in deltas[k]]
            if batches:
                assert engine.append(tickets[i], batches)
        engine.tick()
        ticks += 1
        if r == 1 and case in ("recycle", "checkpoint"):
            for wf, run, _ in hists:
                assert engine.evict(wf, run)
            assert engine.occupancy() == 0.0
            out = engine.admit_many([
                dict(domain_id="dom", workflow_id=wf, run_id=run,
                     branch_token=_token(i),
                     batches=prefix + [b for d in deltas[:2] for b in d])
                for i, ((wf, run, _), (prefix, deltas))
                in enumerate(zip(hists, splits))])
            tickets = {i: out[(wf, run)]
                       for i, (wf, run, _) in enumerate(hists)}
            assert None not in tickets.values()
    rows = []
    for wf, run, _ in hists:
        got = engine.read(wf, run)
        assert got is not None and got.resident
        rows.append(got)
    resumed = scope.registry.counter_value("serving_admit_resume")
    return rows, ticks, resumed


@pytest.mark.parametrize("case", [
    "affine", "sequential", "recycle", "checkpoint"])
def test_resident_rows_equal_reference_engine_and_cold(case):
    """After at least 3 ticks every resident row equals the reference
    engine's on the same calls, the reference's cold ``replay_packed``
    and the port's, byte for byte."""
    jh, ph = _fuzz(3, seed={"affine": 21, "sequential": 33,
                            "recycle": 55, "checkpoint": 61}[case])
    jrows, jticks, jresumed = _drive(
        _engine(JResidentEngine, case, JCAPS,
                (JCheckpointManager, JCheckpointPolicy,
                 JMemoryCheckpointStore)),
        jh, case, JScope)
    prows, pticks, presumed = _drive(
        _engine(lambda **kw: ResidentEngine(device="cpu", **kw), case,
                CAPS, (CheckpointManager, CheckpointPolicy,
                       MemoryCheckpointStore)),
        ph, case, Scope)
    assert pticks == jticks >= 3
    assert presumed == jresumed == (3 if case == "checkpoint" else 0)
    rebased = 0
    for (wf, run, jb), (_, _, pb), jgot, got in zip(jh, ph, jrows, prows):
        assert got.epoch_s == jgot.epoch_s
        _assert_rows_equal(got.state_row, jgot.state_row,
                           msg=f"{case} {wf} vs reference")
        assert got.snapshot == jgot.snapshot
        _assert_at_cold(got, _jcold(wf, run, jb),
                        msg=f"{case} {wf} vs reference cold")
        cold = _cold(wf, run, pb)
        _assert_at_cold(got, cold, msg=f"{case} {wf} vs port cold")
        rebased += got.epoch_s != cold[1]
    # the lanes seated after lane 0 were rebased to its epoch
    assert rebased == 2


def test_tick_groups_launch_once_each(monkeypatch):
    """A tick replays each non-empty group (affine, scan) in one packed
    call, at most two, every lane resumed from its resident row."""
    _, ph = _fuzz(3, seed=21)
    engine = ResidentEngine(lanes=8, caps=CAPS, device="cpu")
    calls = []
    real = engine._replay

    def spy(packed, scan_mode):
        calls.append((scan_mode, packed.n_histories,
                      packed.initial is not None))
        return real(packed, scan_mode=scan_mode)

    for wf, run, b in ph:
        prefix, deltas = _split(b, 4)
        t = engine.admit("dom", wf, run, batches=prefix)
        assert engine.append(t, deltas[0])
    monkeypatch.setattr(engine, "_replay", spy)
    engine.tick()
    assert 1 <= len(calls) <= 2
    assert len({m for m, _, _ in calls}) == len(calls)
    assert sum(n for _, n, _ in calls) == 3
    assert all(resumed for _, _, resumed in calls)


# ---------------------------------------------------------------------------
# the generation stamp and the staged-tip watermark
# ---------------------------------------------------------------------------


def test_stale_ticket_refused_after_recycle():
    scope = Scope()
    engine = ResidentEngine(lanes=1, caps=CAPS, metrics=scope, device="cpu")
    _, ((wf, run, b), (wf2, run2, b2)) = _fuzz(2, seed=71)
    prefix, deltas = _split(b, 2)
    stale = engine.admit("dom", wf, run, batches=prefix)
    assert engine.evict(wf, run)  # the generation bumps
    assert engine.admit("dom", wf2, run2, batches=b2) is not None
    before = engine.read(wf2, run2).state_row
    assert engine.append(stale, deltas[0]) is False
    assert scope.registry.counter_value("serving_stale_appends") == 1
    engine.tick()
    _assert_rows_equal(engine.read(wf2, run2).state_row, before,
                       msg="a stale append reached the new tenant")
    assert engine.append((wf, run), deltas[0]) is False


def test_straddling_append_trims_to_unseen_tail():
    _, ((wf, run, b),) = _fuzz(1, seed=171)
    cut = max(2, len(b) // 2)
    engine = ResidentEngine(lanes=2, caps=CAPS, device="cpu")
    t = engine.admit("dom", wf, run, batches=b[:cut])
    straddle = list(b[cut - 1]) + list(b[cut])
    assert engine.append(t, [straddle] + b[cut + 1 :])
    _assert_at_cold(engine.read(wf, run), _cold(wf, run, b), msg="straddle")


def test_gapped_append_refused_on_bare_lane():
    _, ((wf, run, b),) = _fuzz(1, seed=173)
    scope = Scope()
    engine = ResidentEngine(lanes=2, caps=CAPS, metrics=scope, device="cpu")
    t = engine.admit("dom", wf, run, batches=b[:1])
    assert not engine.append(t, b[2:])  # skips b[1]
    assert scope.registry.counter_value("serving_gapped_appends") == 1
    _assert_at_cold(engine.read(wf, run), _cold(wf, run, b[:1]),
                    msg="a refused gap must keep the pre-gap row")


@pytest.mark.parametrize("feed", ["gapped_append", "on_persisted"])
def test_gap_heals_through_persist_feed_catch_up(feed):
    """With a history store the gap is debt: the next tick reads the
    missing span from the port's ``MemoryHistoryManager`` and replays
    only the suffix past the seat."""
    _, ((wf, run, b),) = _fuzz(1, seed=175)
    hist = MemoryHistoryManager()
    cut = max(1, len(b) // 2)
    branch, txn = _store(hist, b[:cut], run)
    scope = Scope()
    engine = ResidentEngine(lanes=2, caps=CAPS, history=hist,
                            metrics=scope, device="cpu")
    t = engine.admit("dom", wf, run, branch_token=branch.to_json().encode(),
                     batches=b[:cut])
    for k, batch in enumerate(b[cut:]):
        hist.append_history_nodes(branch, batch, transaction_id=txn + k)
        if feed == "on_persisted":
            engine.on_persisted("dom", wf, run, batch[-1].event_id + 1)
    if feed == "gapped_append":
        assert engine.append(t, b[cut + 1 :])  # gap: b[cut]
    got = engine.read(wf, run)
    assert got is not None and got.resident
    _assert_at_cold(got, _cold(wf, run, b), msg=feed)
    assert (scope.registry.counter_value("serving_events_replayed")
            == sum(len(x) for x in b[cut:]))


def test_history_hole_frees_the_lane():
    _, ((wf, run, b),) = _fuzz(1, seed=183)
    hist = MemoryHistoryManager()
    branch = hist.new_history_branch(tree_id=run)
    hist.append_history_nodes(branch, b[0], transaction_id=1)
    for k, batch in enumerate(b[2:]):  # b[1] is the hole
        hist.append_history_nodes(branch, batch, transaction_id=2 + k)
    scope = Scope()
    engine = ResidentEngine(lanes=2, caps=CAPS, history=hist,
                            metrics=scope, device="cpu")
    assert engine.admit("dom", wf, run,
                        branch_token=branch.to_json().encode(),
                        batches=[b[0]]) is not None
    engine.on_persisted("dom", wf, run, b[-1][-1].event_id + 1)
    engine.tick()
    assert engine.occupancy() == 0.0
    assert scope.registry.counter_value("serving_compose_failures") == 1


def test_unreadable_branch_cold_read_is_a_counted_miss():
    scope = Scope()
    engine = ResidentEngine(lanes=2, caps=CAPS, metrics=scope,
                            history=MemoryHistoryManager(), device="cpu")
    assert engine.read("wf-x", "run-x", branch_token=b"not-a-token") is None
    assert scope.registry.counter_value("serving_cold_read_failures") == 1


def test_drain_flushes_every_lane_and_failed_flush_is_counted():
    """``drain`` composes what is pending and flushes one record per lane
    through ``CheckpointManager.flush``; a store that fails makes
    ``flush`` return False, counted, never raised."""
    _, ph = _fuzz(3, seed=91)
    store = MemoryCheckpointStore()
    engine = ResidentEngine(lanes=4, caps=CAPS, device="cpu",
                            checkpoints=CheckpointManager(store))
    for i, (wf, run, b) in enumerate(ph):
        prefix, deltas = _split(b, 2)
        t = engine.admit("dom", wf, run, branch_token=_token(i),
                         batches=prefix)
        assert engine.append(t, deltas[0])
    scope = Scope()
    engine._metrics = scope.tagged(layer="serving")
    engine.tick()
    assert scope.registry.gauge_value("serving_lane_occupancy") == 0.75
    out = engine.drain()
    assert out == {"flushed": 3, "flush_failed": 0, "queued_dropped": 0}
    assert store.count_checkpoints() == 3

    class Broken(MemoryCheckpointStore):
        def put_checkpoint(self, ckpt):
            raise OSError("disk gone")

    scope = Scope()
    engine = ResidentEngine(lanes=4, caps=CAPS, device="cpu", metrics=scope,
                            checkpoints=CheckpointManager(Broken()))
    wf, run, b = ph[0]
    engine.admit("dom", wf, run, branch_token=_token(0), batches=b)
    assert engine.drain()["flush_failed"] == 1
    assert scope.registry.counter_value("serving_flush_failures") == 1


# ---------------------------------------------------------------------------
# fair admission, arrivals, the open-loop harness, the tick pump
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Adm:
    domain_id: str
    workflow_id: str

    @property
    def key(self):
        return (self.workflow_id, "run")


class _VirtualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += max(dt, 1e-6)


@pytest.mark.parametrize("seed", [3, 17])
def test_fair_admission_take_order_equals_reference(seed):
    """A seeded park/take sequence with weights, per-domain quotas, aging
    and a live quota retune gives the reference queue's take order."""
    def policy(cls):
        return cls(domain_weights={"a": 3.0, "b": 1.5}, default_weight=1.0,
                   quota_rps=2.0, quota_burst=1, aging_boost=0.5,
                   starvation_recycles=3)

    clock = _VirtualClock()
    jlock, lock = threading.Lock(), threading.Lock()
    jq = JFairAdmissionQueue(policy(JAdmissionPolicy), jlock, clock=clock)
    q = FairAdmissionQueue(policy(AdmissionPolicy), lock, clock=clock)
    rng = random.Random(seed)
    taken = []
    for step in range(300):
        clock.t += rng.random() * 0.3
        op = rng.random()
        with jlock, lock:
            if op < 0.55:
                adm = _Adm(rng.choice("abcd"), f"wf-{step}")
                jq.park(adm)
                q.park(adm)
            elif op < 0.97:
                n = rng.randint(0, 3)
                got = [e.adm.key for e in jq.take(n)]
                assert [e.adm.key for e in q.take(n)] == got
                taken += got
            else:
                rps = rng.choice([0.0, 1.0, 4.0])
                jq.set_quota_rps(rps)
                q.set_quota_rps(rps)
            assert len(q) == len(jq)
            assert q.oldest_age_rounds() == jq.oldest_age_rounds()
    assert len(taken) > 50
    with jlock, lock:
        assert q.drain() == jq.drain()


def test_admission_policy_validation():
    for bad in (dict(default_weight=0), dict(domain_weights={"a": -1}),
                dict(quota_rps=-1), dict(aging_boost=0),
                dict(starvation_recycles=0)):
        with pytest.raises(ValueError):
            AdmissionPolicy(**bad).validate()


@pytest.mark.parametrize("kind", ["poisson", "bursty"])
def test_arrival_schedule_equals_reference(kind):
    kw = dict(qps=300.0, kind=kind, seed=7, burst_period_s=0.5)
    assert (ArrivalProcess(**kw).schedule(3000)
            == JArrivalProcess(**kw).schedule(3000))
    with pytest.raises(ValueError):
        ArrivalProcess(qps=10, kind="weird").validate()


class _DenyOnce:
    def __init__(self, deny_at):
        self.calls, self.deny_at = 0, deny_at

    def allow(self, n=1):
        self.calls += 1
        return self.calls != self.deny_at


@pytest.mark.parametrize("control", ["none", "deny_once", "limiter"])
def test_open_loop_harness_equals_reference_under_virtual_clock(control):
    """Under a virtual clock the port's harness completes with the
    reference's request, completion, shed and retry counts on the same
    workloads: with no admission control, with one shed arrival (its
    lane re-seats), and with a multi-stage limiter and a retry budget.
    Every lane ends at the cold row of its history up to its tip."""
    jh, ph = _fuzz(3, seed=141)

    def run(hists, engine, pkg, scope):
        serving, quotas = pkg
        loads = []
        for wf, run_id, b in hists:
            prefix, deltas = _split(b, 3)
            loads.append(serving.ServeWorkload(
                domain_id="dom", workflow_id=wf, run_id=run_id,
                branch_token=b"", prefix=prefix, deltas=deltas))
        clock = _VirtualClock()
        kw = {}
        if control == "deny_once":
            kw = dict(admission_bucket=_DenyOnce(4))
        elif control == "limiter":
            kw = dict(
                limiter=quotas.MultiStageRateLimiter(
                    40.0, lambda d: 30.0, clock=clock, global_burst=4),
                retry_budget=quotas.RetryBudget(ratio=0.5, cap=4.0,
                                                initial=2.0))
        out = serving.OpenLoopHarness(
            engine, loads, serving.ArrivalProcess(qps=50.0, seed=3),
            metrics=scope, clock=clock, sleep=clock.sleep, **kw).run()
        return out, loads

    jout, _ = run(jh, JResidentEngine(lanes=4, caps=JCAPS), (JSV, JQ),
                  JScope())
    scope = Scope()
    engine = ResidentEngine(lanes=4, caps=CAPS, device="cpu")
    out, loads = run(ph, engine, (SV, Q), scope)
    keys = ("requests", "completed", "shed", "retries", "offered", "wall_s",
            "domains")
    assert {k: out[k] for k in keys} == {k: jout[k] for k in keys}
    lost = {"none": 0, "deny_once": 1}.get(control)
    if lost is None:
        assert out["retries"] > 0 and out["offered"] > out["requests"]
    else:
        assert out["completed"] == out["requests"] - lost
    assert scope.registry.timer_stats("serve_decision").count == \
        out["completed"]
    for w in loads:
        got = engine.read(w.workflow_id, w.run_id)
        tip = int(got.state_row["exec_info"][S.X_NEXT_EVENT_ID])
        full = list(w.prefix) + [b for d in w.deltas for b in d]
        _assert_at_cold(got, _cold(w.workflow_id, w.run_id,
                                   [b for b in full
                                    if b[-1].event_id < tip]),
                        msg=f"harness {w.workflow_id}")


def test_tick_pump_drain_on_stop_composes_the_last_delta():
    _, ((wf, run, b),) = _fuzz(1, seed=191)
    prefix, deltas = _split(b, 2)
    engine = ResidentEngine(lanes=2, caps=CAPS, device="cpu")
    t = engine.admit("dom", wf, run, batches=prefix)
    pump = TickPump(engine, interval_s=3600.0).start()
    assert engine.append(t, [x for d in deltas for x in d])
    pump.stop(timeout_s=10.0)
    assert not pump.running
    assert (pump.cycles, pump.errors) == (1, 0)
    assert engine.describe()["lanes_detail"][0]["pending_events"] == 0
    _assert_at_cold(engine.resident_row(wf, run), _cold(wf, run, b),
                    msg="pump drain")


# ---------------------------------------------------------------------------
# the rebuilder's resident-lane consult
# ---------------------------------------------------------------------------


def _rebuilt(result):
    ms, transfer, timer = result
    return (mutable_state_to_snapshot(ms),
            [dataclasses.asdict(t) for t in transfer],
            [dataclasses.asdict(t) for t in timer],
            ms.execution_info.branch_token)


@pytest.mark.parametrize("case,hits", [
    ("exact_tip", 1), ("tip_one_off", 0), ("prefix_lane", 0),
    ("version_history_differs", 0)])
def test_rebuilder_consults_resident_lane_at_exact_tip(case, hits):
    """A rebuild pinned at the lane's tip rehydrates from the resident
    row (one ``serving_resident_hits``) and equals the cold
    ``rebuild_many``; any mismatch falls through to the cold path."""
    _, ((wf, run, b),) = _fuzz(1, seed=151)
    hist = MemoryHistoryManager()
    branch, _ = _store(hist, b, run)
    token = branch.to_json().encode()
    engine = ResidentEngine(lanes=2, caps=CAPS, history=hist, device="cpu")
    if case == "prefix_lane":
        engine.admit("dom", wf, run, branch_token=token,
                     batches=b[: max(1, len(b) // 2)])
    else:
        assert engine.admit_from_store("dom", wf, run, token) is not None
    tip = b[-1][-1].event_id + 1
    row, _ = _cold(wf, run, b)
    n = int(row["vh_len"])
    items = [(int(e), int(v)) for e, v in row["vh_items"][:n]]
    req = RebuildRequest(
        domain_id="dom", workflow_id=wf, run_id=run, branch_token=token,
        next_event_id=tip - (1 if case == "tip_one_off" else 0),
        version_history_items=(
            items[:-1] + [(items[-1][0], items[-1][1] + 1)]
            if case == "version_history_differs" else items))
    scope = Scope()
    got = StateRebuilder(hist, serving=engine, metrics=scope,
                         device="cpu").rebuild_many([req])
    want = StateRebuilder(hist, device="cpu").rebuild_many([req])
    assert scope.registry.counter_value(
        "serving_resident_hits", {"layer": "serving"}) == hits
    assert _rebuilt(got[0]) == _rebuilt(want[0])


# ---------------------------------------------------------------------------
# the device rule, faults of the replay, malformed histories
# ---------------------------------------------------------------------------


def test_engine_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResidentEngine()


def _raises_injected(fn, kind=RuntimeError):
    with pytest.raises(Exception) as ei:
        fn()
    err = ei.value
    cause = err.cause if isinstance(err, DispatchError) else err
    assert isinstance(cause, kind) and "kernel fault" in str(cause)


def test_replay_fault_in_seat_raises_and_releases_the_lane(monkeypatch):
    """A fault of the replay in a seat raises out of ``admit`` (it is no
    malformed history, so no per-admission retry and no None seat) and
    releases the reserved lane; once healed, the same admit seats."""
    _, ((wf, run, b),) = _fuzz(1, seed=201)
    engine = ResidentEngine(lanes=2, caps=CAPS, device="cpu")
    real = RC.replay_rows_packed

    def broken(*a, **k):
        raise RuntimeError("kernel fault")

    monkeypatch.setattr(RC, "replay_rows_packed", broken)
    _raises_injected(lambda: engine.admit("dom", wf, run, batches=b))
    assert engine.describe()["seated"] == 0
    monkeypatch.setattr(RC, "replay_rows_packed", real)
    assert engine.admit("dom", wf, run, batches=b) is not None
    _assert_at_cold(engine.read(wf, run), _cold(wf, run, b),
                    msg="after a seat fault")


def test_replay_fault_in_tick_raises_and_keeps_the_deltas(monkeypatch):
    """A fault of the replay in a tick raises out of ``tick`` instead of
    freeing lanes; the Δs stay staged and the next tick composes them."""
    _, ph = _fuzz(2, seed=211)
    scope = Scope()
    engine = ResidentEngine(lanes=2, caps=CAPS, metrics=scope, device="cpu")
    splits = []
    for wf, run, b in ph:
        prefix, deltas = _split(b, 2)
        t = engine.admit("dom", wf, run, batches=prefix)
        assert engine.append(t, deltas[0])
        splits.append((t, deltas))
    real = RC.replay_rows_packed

    def broken(*a, **k):
        raise RuntimeError("kernel fault")

    monkeypatch.setattr(RC, "replay_rows_packed", broken)
    _raises_injected(engine.tick)
    assert engine.occupancy() == 1.0
    assert scope.registry.counter_value("serving_compose_failures") == 0
    monkeypatch.setattr(RC, "replay_rows_packed", real)
    for t, deltas in splits:  # staged behind the restored Δs
        assert engine.append(t, [x for d in deltas[1:] for x in d])
    engine.tick()
    for wf, run, b in ph:
        _assert_at_cold(engine.read(wf, run), _cold(wf, run, b),
                    msg="after a tick fault")


def test_value_error_of_the_replay_is_no_malformed_history(monkeypatch):
    """The kernel's wrapper raises ``ValueError`` when it cannot run (a
    device or operand mismatch, state rows too tall for shared memory).
    That is a fault of the replay, not a malformed history: ``admit``,
    ``tick`` and a cold ``read`` raise it, no lane is freed, and no
    failure counter moves."""
    _, ph = _fuzz(3, seed=215)
    hist = MemoryHistoryManager()
    scope = Scope()
    engine = ResidentEngine(lanes=3, caps=CAPS, history=hist,
                            metrics=scope, device="cpu")
    tickets = []
    for wf, run, b in ph[:2]:
        prefix, deltas = _split(b, 2)
        t = engine.admit("dom", wf, run, batches=prefix)
        assert engine.append(t, deltas[0])
        tickets.append(t)
    cold_wf, cold_run, cold_b = ph[2]
    branch, _ = _store(hist, cold_b, cold_run)

    def broken(*a, **k):
        raise ValueError("kernel fault")

    monkeypatch.setattr(RC, "replay_rows_packed", broken)
    _raises_injected(
        lambda: engine.admit("dom", cold_wf, cold_run, batches=cold_b),
        ValueError)
    _raises_injected(engine.tick, ValueError)
    _raises_injected(
        lambda: engine.read(cold_wf, cold_run, "dom",
                            branch.to_json().encode()),
        ValueError)
    assert engine.describe()["seated"] == 2
    for name in ("serving_admit_failures", "serving_compose_failures",
                 "serving_cold_read_failures"):
        assert scope.registry.counter_value(name) == 0, name
    monkeypatch.setattr(RC, "replay_rows_packed", _REAL_REPLAY)
    engine.tick()
    for (wf, run, b), t in zip(ph[:2], tickets):
        prefix, deltas = _split(b, 2)
        _assert_at_cold(engine.read(wf, run),
                        _cold(wf, run, prefix + deltas[0]),
                        msg="after a ValueError of the replay")


_REAL_REPLAY = RC.replay_rows_packed


def _malformed_batch(after):
    """An activity started for a schedule that never happened: the
    packer refuses it."""
    e = after[-1][-1]
    return [F.activity_task_started(e.event_id + 1, e.version,
                                    e.timestamp, scheduled_event_id=99999)]


def test_malformed_history_costs_only_its_own_lane():
    """One malformed history in a bulk admission fails only its seat,
    and one malformed Δ in a tick frees only its lane; the others seat,
    compose and equal their cold rows."""
    _, ph = _fuzz(4, seed=221)
    scope = Scope()
    engine = ResidentEngine(lanes=4, caps=CAPS, metrics=scope, device="cpu")
    bad_wf, bad_run, bad_b = ph[3]
    out = engine.admit_many(
        [dict(domain_id="dom", workflow_id=wf, run_id=run,
              batches=_split(b, 2)[0]) for wf, run, b in ph[:3]]
        + [dict(domain_id="dom", workflow_id=bad_wf, run_id=bad_run,
                batches=bad_b + [_malformed_batch(bad_b)])])
    assert out[(bad_wf, bad_run)] is None
    assert scope.registry.counter_value("serving_admit_failures") == 1
    for i, (wf, run, b) in enumerate(ph[:3]):
        prefix, deltas = _split(b, 2)
        delta = [x for d in deltas for x in d]
        if i == 2:
            delta = [_malformed_batch(prefix)]
        assert engine.append(out[(wf, run)], delta)
    assert engine.tick()["composed"] == 2
    assert scope.registry.counter_value("serving_compose_failures") == 1
    assert engine.read(*ph[2][:2]) is None
    for wf, run, b in ph[:2]:
        _assert_at_cold(engine.read(wf, run), _cold(wf, run, b),
                    msg=f"isolated {wf}")


def test_only_host_rows_reach_commit(monkeypatch):
    """The seat's dispatcher hands back torch state; it must reach the
    host in one copy before rows commit, and ``_commit_row`` refuses a
    tensor outright."""
    _, ph = _fuzz(2, seed=231)
    engine = ResidentEngine(lanes=2, caps=CAPS, device="cpu")
    seen = []
    real = engine._commit_row

    def spy(slot, lane, packed, final, j):
        seen.append(type(final.exec_info))
        return real(slot, lane, packed, final, j)

    monkeypatch.setattr(engine, "_commit_row", spy)
    tickets = engine.admit_many([
        dict(domain_id="dom", workflow_id=wf, run_id=run,
             batches=_split(b, 2)[0]) for wf, run, b in ph])
    for (wf, run, b) in ph:
        assert engine.append(tickets[(wf, run)], _split(b, 2)[1][0])
    engine.tick()
    assert seen and all(t is np.ndarray for t in seen)
    dev = S.state_from_numpy(S.empty_state(1, CAPS), "cpu")
    with pytest.raises(TypeError):
        real(0, engine._slots[0], None, dev, 0)


def test_concurrent_ticks_and_appends_lose_no_delta():
    """Two threads tick while a third appends every Δ in order; once all
    are joined and a last tick runs, every lane equals its cold row. The
    tickers spin, so no lane may idle out of the engine meanwhile."""
    _, ph = _fuzz(3, seed=241)
    engine = ResidentEngine(lanes=4, caps=CAPS, device="cpu",
                            idle_ticks=1 << 30)
    plan = []
    for wf, run, b in ph:
        prefix, deltas = _split(b, 6)
        plan.append((engine.admit("dom", wf, run, batches=prefix), deltas))
    done = threading.Event()
    errors = []

    def appender():
        try:
            for k in range(max(len(d) for _, d in plan)):
                for t, deltas in plan:
                    if k < len(deltas):
                        assert engine.append(t, deltas[k])
        except BaseException as e:  # surfaced by the assertion below
            errors.append(e)
        finally:
            done.set()

    def ticker():
        try:
            while not done.is_set():
                engine.tick()
        except BaseException as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=f)
                   for f in (ticker, ticker, appender)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    engine.tick()
    for wf, run, b in ph:
        _assert_at_cold(engine.read(wf, run), _cold(wf, run, b),
                    msg=f"concurrent {wf}")
