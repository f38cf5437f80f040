"""The port's checkpoint plane against the reference package's: the
store, validation (fingerprint, capacities, LCA), the record's JSON, the
contract fingerprint over the CUDA sources, and checkpointed
``rebuild_many`` (cold then warm, mid-history resume, a broken store, the
write policy, and the ``rebuild_warm`` shape with its measured suffix).

A warm pass that silently replays cold still returns correct states, so
each warm test also counts its checkpoint hits."""

import shutil

import numpy as np

from cadence_tpu.checkpoint import (
    CheckpointManager as JCheckpointManager,
    CheckpointPolicy as JCheckpointPolicy,
    MemoryCheckpointStore as JMemoryCheckpointStore,
    checkpoint_from_replay as j_checkpoint_from_replay,
)
from cadence_tpu.ops import pack as JP
from cadence_tpu.ops import replay as JR
from cadence_tpu.ops import schema as JS
from cadence_tpu.runtime.replication.rebuilder import (
    StateRebuilder as JStateRebuilder,
)
from cadence_tpu.testing import workloads as JW
from cadence_tpu.testing.event_generator import (
    HistoryFuzzer as JHistoryFuzzer,
)
from cadence_tpu.utils.metrics import Scope as JScope

from cadence_tpu_torch.checkpoint import (
    CheckpointManager,
    CheckpointPolicy,
    MemoryCheckpointStore,
    ReplayCheckpoint,
    checkpoint_from_replay,
    transition_fingerprint,
)
from cadence_tpu_torch.checkpoint import fingerprint as FP
from cadence_tpu_torch.ops import pack as P
from cadence_tpu_torch.ops import schema as S
from cadence_tpu_torch.ops.replay import replay_packed
from cadence_tpu_torch.ops.unpack import mutable_state_to_snapshot
from cadence_tpu_torch.runtime.persistence.records import BranchToken
from cadence_tpu_torch.runtime.replication.rebuilder import StateRebuilder
from cadence_tpu_torch.utils.metrics import Scope

from test_torch_rebuild import (
    assert_same_rebuilds,
    port_batches,
    store_both,
    task_dicts,
)

CAPS = S.Capacities(max_events=256)


def _fuzz(n, seed=11, target=40, close=False):
    """Reference-package fuzzed histories (port copies via to_dict)."""
    out = []
    for i in range(n):
        fz = JHistoryFuzzer(seed=seed + i, caps=JS.Capacities(max_events=256))
        out.append(fz.generate(target_events=target + (i * 13) % 60,
                               close=close))
    return out


def _branch_token(i):
    return BranchToken(
        tree_id=f"run-{i}", branch_id=f"branch-{i}").to_json().encode()


def _prefix_checkpoint(i, prefix, caps=CAPS):
    """Replay a prefix on the port (plain kernel) and snapshot it. One
    lane as long as the prefix: the plain replay walks every step."""
    wf, run = f"wf-{i}", f"run-{i}"
    pk = P.pack_lanes([(wf, run, port_batches(prefix))], caps=caps)
    pre = replay_packed(pk, device="cpu")
    return checkpoint_from_replay(
        _branch_token(i), pre, 0, pk.side[0], pk.epoch_s, caps,
        domain_id="dom", workflow_id=wf, run_id=run,
    )


# -- store -------------------------------------------------------------


def test_store_roundtrip_order_and_prune():
    store = MemoryCheckpointStore()
    batches = _fuzz(1)[0]
    bt = _branch_token(0)
    cks = []
    for cut in (1, max(2, len(batches) // 2), len(batches)):
        ck = _prefix_checkpoint(0, batches[:cut])
        store.put_checkpoint(ck)
        cks.append(ck)
    got = store.list_checkpoints(bt.decode())
    assert [c.event_id for c in got] == sorted(
        {c.event_id for c in cks}, reverse=True), "list must be newest-first"
    g, ref = got[0], max(cks, key=lambda c: c.event_id)
    assert g.vh_items == ref.vh_items
    assert g.fingerprint == transition_fingerprint()
    assert g.resume.next_event_id == ref.resume.next_event_id
    assert g.side.activity_ids == ref.side.activity_ids
    for k in S.STATE_ROW_FIELDS:
        np.testing.assert_array_equal(g.state_row[k], ref.state_row[k])
    assert store.newest_event_id(bt.decode()) == ref.event_id
    assert store.list_tree_checkpoints("run-0")
    assert store.prune_tree("run-0", 1) == len(got) - 1
    assert store.count_checkpoints() == 1
    assert store.list_checkpoints(bt.decode())[0].event_id == g.event_id


def test_corrupted_record_is_skipped_not_raised():
    store = MemoryCheckpointStore()
    ck = _prefix_checkpoint(0, _fuzz(1)[0])
    store.put_checkpoint(ck)
    store._corrupt(ck.branch_key, ck.event_id)
    assert store.list_checkpoints(ck.branch_key) == []
    got, status = CheckpointManager(store).lookup(_branch_token(0), caps=CAPS)
    assert got is None and status == "miss"


def test_record_json_matches_reference():
    """The same prefix snapshotted by both packages serializes to the
    same JSON, byte for byte, and each package reads the other's."""
    batches = _fuzz(1, target=50)[0]
    prefix = batches[: len(batches) // 2]
    jpk = JP.pack_lanes([("wf-0", "run-0", prefix)],
                        caps=JS.Capacities(max_events=256))
    jck = j_checkpoint_from_replay(
        _branch_token(0), JR.replay_packed_lanes(jpk), 0, jpk.side[0],
        jpk.epoch_s, JS.Capacities(max_events=256), domain_id="dom",
        workflow_id="wf-0", run_id="run-0", fingerprint="same")
    ck = _prefix_checkpoint(0, prefix)
    ck.fingerprint, ck.created_at = "same", jck.created_at
    assert ck.to_json() == jck.to_json()
    back = ReplayCheckpoint.from_json(jck.to_json())
    assert back.to_json() == jck.to_json()


# -- validation --------------------------------------------------------


def test_fingerprint_and_caps_invalidation():
    store = MemoryCheckpointStore()
    bt = _branch_token(0)
    store.put_checkpoint(_prefix_checkpoint(0, _fuzz(1)[0]))

    hit, status = CheckpointManager(store).lookup(bt, caps=CAPS)
    assert status == "hit" and hit is not None

    stale = CheckpointManager(store, fingerprint="stale-kernel")
    got, status = stale.lookup(bt, caps=CAPS)
    assert got is None and status == "invalidated"

    other_caps = S.Capacities(max_events=256, max_activities=4)
    got, status = CheckpointManager(store).lookup(bt, caps=other_caps)
    assert got is None and status == "invalidated"

    # never resume past the rebuild target
    got, status = CheckpointManager(store).lookup(
        bt, caps=CAPS, max_event_id=1)
    assert got is None and status == "invalidated"


def test_lca_divergence_invalidation_and_fork_point_resume():
    store = MemoryCheckpointStore()
    bt = _branch_token(0)
    ck = _prefix_checkpoint(0, _fuzz(1, target=60)[0])
    store.put_checkpoint(ck)
    mgr = CheckpointManager(store)
    tip, last_ver = ck.event_id, ck.vh_items[-1][1]

    extended = ck.vh_items[:-1] + [(tip + 50, last_ver)]
    got, status = mgr.lookup(bt, caps=CAPS, version_history_items=extended)
    assert status == "hit" and got is not None

    diverged = [(e, v) for e, v in ck.vh_items if e < tip - 5] + [
        (tip - 5, last_ver), (tip + 50, last_ver + 7)]
    got, status = mgr.lookup(bt, caps=CAPS, version_history_items=diverged)
    assert got is None and status == "invalidated"

    sibling = BranchToken(
        tree_id="run-0", branch_id="branch-forked").to_json().encode()
    forked_after = ck.vh_items[:-1] + [
        (tip + 2, last_ver), (tip + 20, last_ver + 9)]
    got, status = mgr.lookup(sibling, caps=CAPS,
                             version_history_items=forked_after)
    assert status == "hit" and got.branch_key == bt.decode()

    got, status = mgr.lookup(sibling, caps=CAPS)
    assert got is None and status == "miss"


def test_fingerprint_covers_the_cuda_sources(tmp_path):
    """The fingerprint hashes both kernels' CUDA sources with the Python
    contract: a copy of the list whose bytes differ in any one source
    (the tree itself is never edited) gives another fingerprint."""
    paths = FP.contract_paths()
    cu = [p for p in paths if p.suffix == ".cu"]
    assert {p.name for p in cu} == {"replay_fsm.cu", "affine_segscan.cu"}
    assert all(p.is_file() for p in paths)
    copies = []
    for k, p in enumerate(paths):
        dst = tmp_path / f"{k}-{p.name}"
        shutil.copyfile(p, dst)
        copies.append(dst)
    assert FP.fingerprint_of(copies) == transition_fingerprint()
    seen = {transition_fingerprint()}
    for k, p in enumerate(paths):
        edited = list(copies)
        edited[k] = tmp_path / f"edited-{p.name}"
        edited[k].write_bytes(p.read_bytes() + b"\n")
        fp = FP.fingerprint_of(edited)
        assert fp not in seen, f"{p.name} is not covered"
        seen.add(fp)


# -- rebuild_many with checkpoints ---------------------------------------


def test_rebuild_many_cold_then_warm_parity_and_metrics():
    hs = _fuzz(8, seed=51, target=50)
    jhist, jreqs, hist, reqs = store_both(hs)
    host = [StateRebuilder(hist).rebuild(r) for r in reqs]

    metrics, store = Scope(), MemoryCheckpointStore()
    rb = StateRebuilder(
        hist, lane_len=256, device="cpu", metrics=metrics,
        checkpoints=CheckpointManager(
            store, CheckpointPolicy(every_events=1, keep_last=2)))
    cold = rb.rebuild_many(reqs)
    reg = metrics.registry
    assert reg.counter_value("checkpoint_miss") == len(reqs)
    assert store.count_checkpoints() == len(reqs)

    warm = rb.rebuild_many(reqs)   # tip hits: no replay at all
    assert reg.counter_value("checkpoint_hit") == len(reqs)
    assert reg.counter_value("events_replayed_saved") == sum(
        sum(len(b) for b in h) for h in hs)

    # the reference package, cold then warm the same way
    jmetrics, jstore = JScope(), JMemoryCheckpointStore()
    jrb = JStateRebuilder(
        jhist, lane_len=256, metrics=jmetrics,
        checkpoints=JCheckpointManager(
            jstore, JCheckpointPolicy(every_events=1, keep_last=2)))
    assert_same_rebuilds(cold, jrb.rebuild_many(jreqs))
    assert_same_rebuilds(warm, jrb.rebuild_many(jreqs))
    for name in ("checkpoint_hit", "checkpoint_miss",
                 "events_replayed_saved"):
        assert reg.counter_value(name) == \
            jmetrics.registry.counter_value(name), name
    for (h, ht, hti), (c, _, _), (w, wt, wti) in zip(host, cold, warm):
        assert mutable_state_to_snapshot(h) == mutable_state_to_snapshot(c)
        assert mutable_state_to_snapshot(h) == mutable_state_to_snapshot(w)
        assert task_dicts(ht) == task_dicts(wt)
        assert task_dicts(hti) == task_dicts(wti)


def test_rebuild_many_mid_history_resume_parity():
    """Snapshots strictly inside the histories: the warm rebuild reads
    and replays only the suffix, equal to the host rebuild."""
    hs = _fuzz(8, seed=61, target=60)
    _, _, hist, reqs = store_both(hs)
    host = [StateRebuilder(hist).rebuild(r) for r in reqs]
    store = MemoryCheckpointStore()
    for i, batches in enumerate(hs):
        store.put_checkpoint(_prefix_checkpoint(
            i, batches[: max(1, len(batches) // 2)], caps=S.Capacities()))
    metrics = Scope()
    rb = StateRebuilder(
        hist, lane_len=256, device="cpu", metrics=metrics,
        checkpoints=CheckpointManager(
            store, CheckpointPolicy(every_events=1 << 30)))
    warm = rb.rebuild_many(reqs)
    assert metrics.registry.counter_value("checkpoint_hit") == len(reqs)
    for (h, ht, hti), (w, wt, wti) in zip(host, warm):
        assert mutable_state_to_snapshot(h) == mutable_state_to_snapshot(w)
        assert task_dicts(ht) == task_dicts(wt)
        assert task_dicts(hti) == task_dicts(wti)


def test_write_policy_and_retention():
    _, _, hist, reqs = store_both(_fuzz(2, seed=71, target=40))
    store = MemoryCheckpointStore()
    rb = StateRebuilder(
        hist, device="cpu", metrics=Scope(),
        checkpoints=CheckpointManager(
            store, CheckpointPolicy(every_events=1 << 30, keep_last=1)))

    def stored():
        return {c.event_id for r in reqs
                for c in store.list_checkpoints(r.branch_token.decode())}

    rb.rebuild_many(reqs)
    # the first snapshot of a run always writes (nothing stored yet)
    assert store.count_checkpoints() == len(reqs)
    created = stored()
    # tips unchanged: the every_events gate skips the writes
    rb.rebuild_many(reqs)
    assert stored() == created
    assert store.count_checkpoints() == len(reqs)


def test_broken_store_degrades_to_full_replay():
    class _BrokenStore(MemoryCheckpointStore):
        def list_checkpoints(self, branch_key):
            raise RuntimeError("store down")

        def list_tree_checkpoints(self, tree_id):
            raise RuntimeError("store down")

        def put_checkpoint(self, ckpt):
            raise RuntimeError("store down")

    _, _, hist, reqs = store_both(_fuzz(4, seed=81))
    host = [StateRebuilder(hist).rebuild(r) for r in reqs]
    metrics = Scope()
    out = StateRebuilder(
        hist, device="cpu", metrics=metrics,
        checkpoints=CheckpointManager(_BrokenStore())).rebuild_many(reqs)
    for (h, _, _), (o, _, _) in zip(host, out):
        assert mutable_state_to_snapshot(h) == mutable_state_to_snapshot(o)
    reg = metrics.registry
    assert reg.counter_value("checkpoint_hit") == 0
    assert reg.counter_value("checkpoint_miss") == len(reqs)


def test_rebuild_warm_shape_resumes_every_run():
    """The bench's rebuild_warm cell, small: an untimed prefix pass
    writes a checkpoint per run, the tails are appended, and the warm
    pass resumes every run (hit count) and replays exactly the tails
    (measured suffix fraction equals the configured one)."""
    import random

    rng = random.Random(45)
    n, tail_frac = 6, 0.25
    hs, cuts = [], []
    total = suffix = 0
    for _ in range(n):
        batches = JW.retry_deep_history(rng, depth=80)
        n_events = sum(len(b) for b in batches)
        cut, seen = len(batches), 0
        for k, b in enumerate(batches):
            if seen + len(b) > int(n_events * (1.0 - tail_frac)):
                cut = max(k, 1)
                break
            seen += len(b)
        hs.append(batches)
        cuts.append(cut)
        total += n_events
        suffix += sum(len(b) for b in batches[cut:])
    _, _, hist, reqs = store_both([b[:c] for b, c in zip(hs, cuts)])
    store = MemoryCheckpointStore()
    StateRebuilder(hist, device="cpu", checkpoints=CheckpointManager(
        store, CheckpointPolicy(every_events=1, keep_last=1))
    ).rebuild_many(reqs)
    assert store.count_checkpoints() == n
    for i, (batches, cut) in enumerate(zip(hs, cuts)):
        br = BranchToken.from_json(reqs[i].branch_token.decode())
        for txn, b in enumerate(port_batches(batches[cut:]), cut + 1):
            hist.append_history_nodes(br, b, transaction_id=txn)

    metrics = Scope()
    warm = StateRebuilder(hist, device="cpu", metrics=metrics,
                          checkpoints=CheckpointManager(
                              store, CheckpointPolicy(every_events=1 << 30,
                                                      keep_last=1))
                          ).rebuild_many(reqs)
    reg = metrics.registry
    assert reg.counter_value("checkpoint_hit") == n
    # measured: the events the warm pass did not replay
    assert total - reg.counter_value("events_replayed_saved") == suffix
    assert 0 < suffix < total
    host = [StateRebuilder(hist).rebuild(r) for r in reqs]
    for (h, ht, hti), (w, wt, wti) in zip(host, warm):
        assert mutable_state_to_snapshot(h) == mutable_state_to_snapshot(w)
        assert task_dicts(ht) == task_dicts(wt)
        assert task_dicts(hti) == task_dicts(wti)
