"""The port's rebuild path against the reference package's:
``StateRebuilder.rebuild_many`` on the plain kernel versions
(``device="cpu"``) against the reference's batched rebuild and against
the port's own host oracle, ``state_row_to_mutable_state`` on the same
replayed rows, the per-workflow host fallback, and the device rule (no
card, no quiet host route).

Both history stores are filled from the same fuzzed batches under the
same branch tokens, so rebuilt states compare whole, exactly."""

import dataclasses

import numpy as np
import pytest
import torch

from cadence_tpu.core.events import HistoryEvent as JHistoryEvent
from cadence_tpu.ops import pack as JP
from cadence_tpu.ops import replay as JR
from cadence_tpu.ops import unpack as JU
from cadence_tpu.runtime.persistence.memory import (
    MemoryHistoryManager as JMemoryHistoryManager,
)
from cadence_tpu.runtime.persistence.records import BranchToken as JBranchToken
from cadence_tpu.runtime.replication.rebuilder import (
    RebuildRequest as JRebuildRequest,
    StateRebuilder as JStateRebuilder,
)
from cadence_tpu.testing.event_generator import (
    HistoryFuzzer as JHistoryFuzzer,
)

from cadence_tpu_torch.core import history_factory as F
from cadence_tpu_torch.core.events import HistoryEvent
from cadence_tpu_torch.ops import dispatch as D
from cadence_tpu_torch.ops import pack as P
from cadence_tpu_torch.ops import schema as S
from cadence_tpu_torch.ops.replay import replay_packed
from cadence_tpu_torch.ops.unpack import (
    mutable_state_to_snapshot,
    state_row_to_mutable_state,
)
from cadence_tpu_torch.runtime.persistence.memory import MemoryHistoryManager
from cadence_tpu_torch.runtime.persistence.records import BranchToken
from cadence_tpu_torch.runtime.replication.rebuilder import (
    RebuildRequest,
    StateRebuilder,
)
from cadence_tpu_torch.utils.metrics import Scope


def port_batches(batches):
    return [[HistoryEvent.from_dict(e.to_dict()) for e in b]
            for b in batches]


def task_dicts(tasks):
    return [{k: int(v) if k == "task_type" else v
             for k, v in dataclasses.asdict(t).items()} for t in tasks]


def store_both(histories):
    """Fill a reference and a port history store from the same batches
    under the same branch tokens; returns (jhist, jreqs, hist, reqs)."""
    jhist, hist = JMemoryHistoryManager(), MemoryHistoryManager()
    jreqs, reqs = [], []
    for i, batches in enumerate(histories):
        jbr = JBranchToken(tree_id=f"run-{i}", branch_id=f"branch-{i}")
        br = BranchToken(tree_id=f"run-{i}", branch_id=f"branch-{i}")
        assert br.to_json() == jbr.to_json()
        for txn, b in enumerate(batches, 1):
            jhist.append_history_nodes(jbr, b, transaction_id=txn)
            hist.append_history_nodes(br, port_batches([b])[0],
                                      transaction_id=txn)
        jreqs.append(JRebuildRequest(
            domain_id="dom", workflow_id=f"wf-{i}", run_id=f"run-{i}",
            branch_token=jbr.to_json().encode()))
        reqs.append(RebuildRequest(
            domain_id="dom", workflow_id=f"wf-{i}", run_id=f"run-{i}",
            branch_token=br.to_json().encode()))
    return jhist, jreqs, hist, reqs


def assert_same_rebuilds(got, want, whole=True):
    """``whole``: the full MutableState snapshot (device routes of both
    packages); otherwise the canonical replay snapshot (device against a
    host oracle, whose rehydration differs in host-only fields). Tasks
    always field by field."""
    assert len(got) == len(want)
    for (g, g_tr, g_ti), (w, w_tr, w_ti) in zip(got, want):
        assert g.execution_info.workflow_id == w.execution_info.workflow_id
        if whole:
            assert g.snapshot() == w.snapshot()
        assert mutable_state_to_snapshot(g) == JU.mutable_state_to_snapshot(w)
        assert task_dicts(g_tr) == task_dicts(w_tr)
        assert task_dicts(g_ti) == task_dicts(w_ti)


@pytest.fixture(scope="module")
def mixed():
    """The reference's mixed-depth shape: shallow runs and deep
    stragglers, so the stream splits into depth buckets."""
    fz = JHistoryFuzzer(seed=31)
    hs = [fz.generate(target_events=150 if i % 4 == 3 else 10)
          for i in range(9)]
    return store_both(hs)


def test_rebuild_many_mixed_depth_matches_reference_and_host(mixed):
    jhist, jreqs, hist, reqs = mixed
    metrics = Scope()
    rb = StateRebuilder(hist, lane_len=256, device="cpu", metrics=metrics)
    got = rb.rebuild_many(reqs)
    want = JStateRebuilder(jhist, lane_len=256).rebuild_many(jreqs)
    assert_same_rebuilds(got, want)
    # and the port's own host oracle, run by run, in request order
    host = [rb.rebuild(r) for r in reqs]
    for (g, g_tr, g_ti), (h, h_tr, h_ti) in zip(got, host):
        assert mutable_state_to_snapshot(g) == mutable_state_to_snapshot(h)
        assert task_dicts(g_tr) == task_dicts(h_tr)
        assert task_dicts(g_ti) == task_dicts(h_ti)
    reg = metrics.registry
    assert reg.counter_value("host_fallbacks") == 0
    # one dispatched batch per depth bucket, each rehydrated once
    n_buckets = len(D.depth_buckets(
        [(r.workflow_id, r.run_id, rb._read_batches(r)) for r in reqs]))
    assert n_buckets > 1
    assert reg.timer_stats("rehydrate").count == n_buckets
    assert reg.timer_stats("history_read").count == 1


def test_rebuild_many_matches_reference_and_host():
    """The reference's uniform shape at the default lane length, against
    both host oracles (the device routes of both packages meet in the
    mixed-depth tests, which pay the reference's compiles once)."""
    fz = JHistoryFuzzer(seed=23)
    jhist, jreqs, hist, reqs = store_both(
        [fz.generate(target_events=24) for _ in range(6)])
    rb = StateRebuilder(hist, device="cpu")
    got = rb.rebuild_many(reqs)
    assert_same_rebuilds(got, JStateRebuilder(jhist).rebuild_many(
        jreqs, use_device=False), whole=False)
    # use_device=False is the port's host oracle, run by run
    host = rb.rebuild_many(reqs, use_device=False)
    for (g, _, g_ti), (h, _, h_ti) in zip(got, host):
        assert mutable_state_to_snapshot(g) == mutable_state_to_snapshot(h)
        assert task_dicts(g_ti) == task_dicts(h_ti)


def test_rebuild_sets_branch_token(mixed):
    _, _, hist, reqs = mixed
    rb = StateRebuilder(hist, device="cpu")
    ms, _, _ = rb.rebuild(reqs[0])
    assert ms.execution_info.branch_token == reqs[0].branch_token
    assert ms.next_event_id > 1
    for r, (ms, _, _) in zip(reqs, rb.rebuild_many(reqs)):
        assert ms.execution_info.branch_token == r.branch_token


def test_state_row_to_mutable_state_matches_reference():
    """The same histories lane-packed (the rebuilder's route) and
    replayed by each package: every rehydrated MutableState equal,
    whole, to the reference's."""
    fz = JHistoryFuzzer(seed=5)
    hs = [(f"wf-{i}", f"run-{i}", fz.generate(target_events=30 + 17 * i))
          for i in range(6)]
    phs = [(w, r, port_batches(b)) for w, r, b in hs]
    jpk = JP.pack_lanes(hs, target_lane_len=128)
    pk = P.pack_lanes(phs, target_lane_len=128)
    jfinal = JR.replay_packed_lanes(jpk)
    final = replay_packed(pk, device="cpu")
    assert isinstance(final.exec_info, np.ndarray)
    for j in range(len(hs)):
        want = JU.state_row_to_mutable_state(
            jfinal, j, jpk.side[j], domain_id="dom", epoch_s=jpk.epoch_s)
        got = state_row_to_mutable_state(
            final, j, pk.side[j], domain_id="dom", epoch_s=pk.epoch_s)
        assert got.snapshot() == want.snapshot()


def test_state_row_to_mutable_state_refuses_tensors():
    """A torch row index would copy each field on its own; the rebuild
    path hands numpy state, and tensors are refused outright."""
    fz = JHistoryFuzzer(seed=5)
    pk = P.pack_histories([("wf", "run", port_batches(
        fz.generate(target_events=20)))], caps=S.Capacities(max_events=32))
    final = replay_packed(pk, device="cpu")
    with pytest.raises(TypeError, match="state_to_numpy"):
        state_row_to_mutable_state(
            S.state_from_numpy(final, "cpu"), 0, pk.side[0])


def _overflowing_history(n_activities):
    """A run that schedules ``n_activities`` activities in one decision:
    past the default capacity of 32 pending activities."""
    V, t = 1, 1_700_000_000_000_000_000
    batches = [
        [F.workflow_execution_started(1, V, t, task_list="tl",
                                      workflow_type="wt")],
        [F.decision_task_scheduled(2, V, t)],
        [F.decision_task_started(3, V, t, scheduled_event_id=2)],
    ]
    done = [F.decision_task_completed(4, V, t, scheduled_event_id=2,
                                      started_event_id=3)]
    for k in range(n_activities):
        done.append(F.activity_task_scheduled(
            5 + k, V, t, activity_id=f"act-{k}",
            decision_task_completed_event_id=4,
            start_to_close_timeout_seconds=30))
    batches.append(done)
    return batches


def test_refused_batch_falls_back_per_workflow_and_matches():
    """One history over capacity fails its whole batch at pack time:
    every run of that batch is rebuilt on the host oracle, counted, and
    the results still equal the reference's."""
    fz = JHistoryFuzzer(seed=41)
    hs = [fz.generate(target_events=40, close=False) for _ in range(4)]
    over = [[JHistoryEvent.from_dict(e.to_dict()) for e in b]
            for b in _overflowing_history(40)]
    jhist, jreqs, hist, reqs = store_both(hs + [over])
    metrics = Scope()
    rb = StateRebuilder(hist, device="cpu", metrics=metrics)
    got = rb.rebuild_many(reqs)
    assert_same_rebuilds(got, JStateRebuilder(jhist).rebuild_many(jreqs),
                         whole=False)
    assert len(got[-1][0].pending_activities) == 40
    reg = metrics.registry
    # every history sits in one depth bucket, so one batch was refused
    assert len(D.depth_buckets([(0, 0, h) for h in hs + [over]])) == 1
    assert reg.counter_value("host_fallbacks") == len(reqs)
    assert reg.timer_stats("host_fallback").count == 1
    assert reg.timer_stats("rehydrate").count == 0


def test_kernel_fault_raises_instead_of_host_route(mixed, monkeypatch):
    """A batch that fails for a reason other than the packer's refusal
    (here a fault of the replay itself) raises: it never takes the host
    oracle."""
    _, _, hist, reqs = mixed

    def broken(*a, **k):
        raise RuntimeError("kernel fault")

    monkeypatch.setattr(D, "replay_scan_packed", broken)
    rb = StateRebuilder(hist, device="cpu")
    monkeypatch.setattr(rb, "rebuild", lambda r: pytest.fail("host route"))
    with pytest.raises(D.DispatchError, match="kernel fault"):
        rb.rebuild_many(reqs)


def test_rebuild_many_on_cuda_without_card_raises(mixed, monkeypatch):
    """The default device is the card: without one rebuild_many raises
    before it reads a history, and nothing runs on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, hist, reqs = mixed
    rb = StateRebuilder(hist)
    assert rb.device == "cuda"
    monkeypatch.setattr(rb, "rebuild", lambda r: pytest.fail("host route"))
    monkeypatch.setattr(rb, "_read_batches",
                        lambda *a, **k: pytest.fail("history read"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rb.rebuild_many(reqs)


@pytest.mark.parametrize("chunk,device,want", [
    (0, "cuda", 32768), (0, "cpu", 4096), (7, "cpu", 7),
    (lambda: 9, "cuda", 9),
])
def test_chunk_rule_reads_the_port_device(chunk, device, want):
    rb = StateRebuilder(MemoryHistoryManager(), chunk_size=chunk)
    assert rb._resolve_chunk(torch.device(device)) == want


def test_small_chunks_keep_request_order(mixed):
    jhist, jreqs, hist, reqs = mixed
    got = StateRebuilder(hist, lane_len=256, chunk_size=2,
                         device="cpu").rebuild_many(reqs)
    assert_same_rebuilds(got, JStateRebuilder(
        jhist, lane_len=256).rebuild_many(jreqs))


def test_history_store_matches_reference():
    """The memory history store against the reference's on the same
    batches: paged reads, a read from a middle event, a fork read
    through its ancestor, a conflicting append, and deleting the fork."""
    batches = JHistoryFuzzer(seed=13).generate(target_events=60)
    jhist, hist = JMemoryHistoryManager(), MemoryHistoryManager()
    jbr, br = jhist.new_history_branch("t"), hist.new_history_branch("t")
    for txn, b in enumerate(batches, 1):
        jhist.append_history_nodes(jbr, b, transaction_id=txn)
        hist.append_history_nodes(br, port_batches([b])[0],
                                  transaction_id=txn)

    def read(store, branch, lo=1, hi=1 << 60):
        out, token = [], 0
        while True:
            page, token = store.read_history_branch(
                branch, lo, hi, page_size=7, next_token=token)
            out += [[e.to_dict() for e in b] for b in page]
            if not token:
                return out

    assert read(hist, br) == read(jhist, jbr) == [
        [e.to_dict() for e in b] for b in batches]
    assert read(hist, br, lo=20, hi=40) == read(jhist, jbr, lo=20, hi=40)
    fork_at = batches[len(batches) // 2][0].event_id
    jfk, fk = (jhist.fork_history_branch(jbr, fork_at),
               hist.fork_history_branch(br, fork_at))
    # branch ids are uuids: compare the ancestors' ranges
    assert [(a.begin_node_id, a.end_node_id) for a in fk.ancestors] == [
        (a.begin_node_id, a.end_node_id) for a in jfk.ancestors]
    # the fork's own batch at the fork point, and a losing retry of it
    tail = batches[len(batches) // 2]
    for txn in (100, 50):
        jhist.append_history_nodes(jfk, tail, transaction_id=txn)
        hist.append_history_nodes(fk, port_batches([tail])[0],
                                  transaction_id=txn)
    assert read(hist, fk) == read(jhist, jfk)
    assert len(hist.get_history_tree("t")) == 2
    hist.delete_history_branch(fk)
    jhist.delete_history_branch(jfk)
    assert read(hist, br) == read(jhist, jbr)
    assert [t.branch_id for t in hist.get_history_tree("t")] == [
        br.branch_id]
    with pytest.raises(ValueError, match="empty event batch"):
        hist.append_history_nodes(br, [], transaction_id=1)


def test_rebuilder_wires_its_scope_into_the_dispatcher(mixed):
    """The rebuilder's scope reaches the dispatcher: the same device
    batches as the reference rebuilder's on the same requests, a step
    time for each, and the same rebuilt runs as without a scope."""
    from cadence_tpu.utils.metrics import Scope as JScope

    jhist, jreqs, hist, reqs = mixed
    metrics, jmetrics = Scope(), JScope()
    got = StateRebuilder(hist, lane_len=256, device="cpu",
                         metrics=metrics).rebuild_many(reqs)
    JStateRebuilder(jhist, lane_len=256, metrics=jmetrics).rebuild_many(jreqs)
    reg = metrics.registry
    batches = reg.counter_value("device_batches")
    assert batches == jmetrics.registry.counter_value("device_batches") > 1
    assert batches == reg.timer_stats("rehydrate").count
    assert reg.timer_stats("device_step_seconds").count == batches
    assert reg.counter_value("device_batches", {
        "layer": "device", "kernel": "plain", "mode": "lanes"}) == batches
    bare = StateRebuilder(hist, lane_len=256, device="cpu").rebuild_many(reqs)
    assert_same_rebuilds(got, bare)
