"""The port's sqlite store against the reference package's.

The schema (DDL text, versions) is the reference's; one seeded script of
store operations through both packages' sqlite bundles leaves every table
byte-equal (wall-clock columns left out); the queue-task codecs write the
same JSON and read each other's; a database file written by the reference
package opens in the port behind its boot gate, and the port's
``rebuild_many`` over its histories equals the reference rebuilder's; a
checkpoint the reference wrote carries the reference's transition
fingerprint, so the port reads it as stale and replays in full.
"""

from __future__ import annotations

import dataclasses
import importlib
import random
import sqlite3
import types
import uuid

import pytest

from cadence_tpu.checkpoint import (
    CheckpointManager as JCheckpointManager,
    CheckpointPolicy as JCheckpointPolicy,
)
from cadence_tpu.runtime.persistence import schema as JSchema
from cadence_tpu.runtime.persistence.sqlite import (
    create_sqlite_bundle as j_create_sqlite_bundle,
)
from cadence_tpu.runtime.replication.rebuilder import (
    RebuildRequest as JRebuildRequest,
    StateRebuilder as JStateRebuilder,
)
from cadence_tpu.testing.event_generator import (
    HistoryFuzzer as JHistoryFuzzer,
)
from cadence_tpu.utils.metrics import Scope as JScope

from cadence_tpu_torch.checkpoint import (
    CheckpointManager,
    CheckpointPolicy,
    ReplayCheckpoint,
    checkpoint_from_replay,
)
from cadence_tpu_torch.ops import pack as P
from cadence_tpu_torch.ops import schema as S
from cadence_tpu_torch.ops.replay import replay_packed
from cadence_tpu_torch.runtime.persistence import schema as Schema
from cadence_tpu_torch.runtime.persistence.records import BranchToken
from cadence_tpu_torch.runtime.persistence.sqlite import (
    create_sqlite_bundle,
)
from cadence_tpu_torch.runtime.replication.rebuilder import (
    RebuildRequest,
    StateRebuilder,
)
from cadence_tpu_torch.utils.metrics import Scope

from test_torch_rebuild import assert_same_rebuilds, port_batches

# columns a store fills from the wall clock
WALL_CLOCK = {("schema_version", "applied_at"),
              ("task_lists", "last_updated")}


def _mods(pkg):
    def imp(m):
        return importlib.import_module(f"{pkg}.{m}")

    return types.SimpleNamespace(
        sqlite=imp("runtime.persistence.sqlite"),
        rec=imp("runtime.persistence.records"),
        serde=imp("runtime.persistence.serde"),
        tasks=imp("core.tasks"), enums=imp("core.enums"),
        events=imp("core.events"), ck=imp("checkpoint.record"))


class _SeededUuid:
    """``uuid`` as the store module sees it, its ``uuid4`` drawn from a
    seeded generator (branch ids), so two runs mint the same ids."""

    def __init__(self, seed):
        self._rng = random.Random(seed)

    def uuid4(self):
        return uuid.UUID(int=self._rng.getrandbits(128), version=4)


def dump(path):
    """Every table's rows in key order, wall-clock columns left out, and
    the schema's DDL text."""
    conn = sqlite3.connect(path)
    out = {"__ddl__": conn.execute(
        "SELECT type, name, tbl_name, sql FROM sqlite_master "
        "ORDER BY type, name").fetchall()}
    for (table,) in conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' "
            "ORDER BY name").fetchall():
        cols = [r[1] for r in conn.execute(f"PRAGMA table_info({table})")]
        keep = [c for c in cols if (table, c) not in WALL_CLOCK]
        sel = ", ".join(keep)
        out[table] = conn.execute(
            f"SELECT {sel} FROM {table} ORDER BY {sel}").fetchall()
    conn.close()
    return out


def _tasks(M, wf, run, base):
    E, T = M.enums, M.tasks
    return dict(
        transfer_tasks=[
            T.TransferTask(task_type=E.TransferTaskType.DecisionTask,
                           domain_id="dom", workflow_id=wf, run_id=run,
                           task_id=base, task_list="tl", schedule_id=2),
            T.TransferTask(task_type=E.TransferTaskType.ActivityTask,
                           domain_id="dom", workflow_id=wf, run_id=run,
                           task_id=base + 1, task_list="tl",
                           schedule_id=5, version=3)],
        timer_tasks=[
            T.TimerTask(task_type=E.TimerTaskType.WorkflowTimeout,
                        visibility_timestamp=5_000 + base, domain_id="dom",
                        workflow_id=wf, run_id=run, task_id=base + 2),
            T.TimerTask(task_type=E.TimerTaskType.ActivityTimeout,
                        visibility_timestamp=9_000 + base, domain_id="dom",
                        workflow_id=wf, run_id=run, task_id=base + 3,
                        timeout_type=1, event_id=5)],
        replication_tasks=[
            T.ReplicationTask(domain_id="dom", workflow_id=wf, run_id=run,
                              task_id=base + 4, first_event_id=1,
                              next_event_id=6, version=3,
                              branch_token=b'{"tree_id": "%s"}' % run.encode(),
                              new_run_branch_token=b"\xff\x00raw")])


def _snapshot(M, wf, run, next_event_id, state=1, close_status=0,
              base=100, tasks=True):
    snap = {
        "execution_info": {
            "state": state, "close_status": close_status,
            "create_request_id": f"req-{wf}", "branch_token":
            b'{"tree_id": "%s", "branch_id": "b"}' % run.encode()},
        "pending_activities": {"5": {"attempt": 1, "details": b"\x01\x02"}},
        # a user map carrying a codec marker key: escaped on the way in
        "memo": {"__b": "not bytes", "k": b"v"},
        "signals": {3, 1, 2},
    }
    return M.rec.WorkflowSnapshot(
        domain_id="dom", workflow_id=wf, run_id=run, snapshot=snap,
        next_event_id=next_event_id, last_write_version=next_event_id // 4,
        **(_tasks(M, wf, run, base) if tasks else {}))


def _checkpoint_blob():
    """One checkpoint record's JSON, made by the port's plain replay with
    its fingerprint and stamp fixed."""
    batches = JHistoryFuzzer(seed=3, caps=S.Capacities(max_events=256)) \
        .generate(target_events=30)
    pk = P.pack_lanes([("wf-ck", "run-ck", port_batches(batches))],
                      caps=S.Capacities(max_events=256))
    ck = checkpoint_from_replay(
        BranchToken(tree_id="run-ck", branch_id="b-ck").to_json().encode(),
        replay_packed(pk, device="cpu"), 0, pk.side[0], pk.epoch_s,
        S.Capacities(max_events=256), domain_id="dom",
        workflow_id="wf-ck", run_id="run-ck", fingerprint="fp")
    ck.created_at = 1_700_000_000
    return ck.to_json(), batches


def run_script(pkg, path, ck_blob, jbatches, monkeypatch):
    """The seeded script of store operations, through ``pkg``'s sqlite
    bundle at ``path``."""
    M = _mods(pkg)
    monkeypatch.setattr(M.sqlite, "uuid", _SeededUuid(17))
    R, E = M.rec, M.enums
    rng = random.Random(23)
    b = M.sqlite.create_sqlite_bundle(path)
    try:
        # shards
        for sid in (1, 2, 3):
            b.shard.create_shard(R.ShardInfo(shard_id=sid, range_id=1,
                                             owner=f"host-{sid}"))
        info = b.shard.get_shard(2)
        info.range_id, info.transfer_ack_level = 2, 7
        info.cluster_timer_ack_level = {"standby": 11}
        b.shard.update_shard(info, previous_range_id=1)
        b.shard.set_reshard_state(1, '{"epoch": 1}', previous_epoch=0)
        b.shard.set_replication_progress(1, "standby", '{"c": 3}', 0)
        b.shard.set_replication_progress(1, "standby", '{"c": 4}', 1)
        # executions with tasks; updates, a continue-as-new, a delete
        ex = b.execution
        runs = []
        for i in range(12):
            wf, run = f"wf-{i:02d}", f"run-{i:02d}"
            ex.create_workflow_execution(
                1, 1, R.CreateWorkflowMode.BRAND_NEW,
                _snapshot(M, wf, run, 3, base=100 + 10 * i))
            runs.append((wf, run))
        for i in rng.sample(range(12), 6):
            wf, run = runs[i]
            ex.update_workflow_execution(
                1, 1, 3, _snapshot(M, wf, run, 8, base=300 + 10 * i))
        wf, run = runs[0]
        ex.update_workflow_execution(
            1, 1, ex.get_workflow_execution(1, "dom", wf, run).next_event_id,
            _snapshot(M, wf, run, 9, state=2, close_status=5, tasks=False),
            new_snapshot=_snapshot(M, wf, "run-00b", 3, base=500))
        ex.delete_workflow_execution(1, "dom", *runs[5])
        ex.delete_current_workflow_execution(1, "dom", *runs[5])
        ex.complete_transfer_task(1, 101)
        ex.range_complete_transfer_tasks(1, 110, 135)
        ex.complete_timer_task(1, 5_102, 102)
        ex.range_complete_timer_tasks(1, 0, 5_150)
        ex.complete_replication_task(1, 104)
        # the reshard move: extract from shard 1, install on shard 3
        moved = ex.reshard_extract(1, [runs[7][0], runs[9][0]], 0, (0, 0),
                                   delete=True)
        ids = iter(range(9_000, 9_100))
        ex.reshard_install(3, 1, moved, lambda: next(ids))
        # history: appends, a stale rewrite, a fork, a deleted branch
        h = b.history
        events = [[M.events.HistoryEvent.from_dict(e.to_dict()) for e in bt]
                  for bt in jbatches]
        br = h.new_history_branch(tree_id="run-h")
        for txn, batch in enumerate(events, 1):
            h.append_history_nodes(br, batch, transaction_id=txn)
        h.append_history_nodes(br, events[1], transaction_id=0)
        fork = h.fork_history_branch(br, events[len(events) // 2][0].event_id)
        h.append_history_nodes(fork, [M.events.HistoryEvent.from_dict(
            events[-1][0].to_dict())], transaction_id=99)
        other = h.new_history_branch(tree_id="run-gone")
        h.append_history_nodes(other, events[0], transaction_id=1)
        h.delete_history_branch(other)
        # task lists
        tm = b.task
        stale = tm.lease_task_list("dom", "tl", 0)
        lease = tm.lease_task_list("dom", "tl", 0)
        tm.lease_task_list("dom", "act-tl", 1)
        tm.create_tasks(lease, [R.TaskInfo("dom", f"wf-{k}", f"run-{k}",
                                           k, 2, created_time=k * 7)
                                for k in range(1, 6)])
        with pytest.raises(M.sqlite.TaskListLeaseLostError):
            tm.create_tasks(stale, [R.TaskInfo("dom", "x", "y", 9, 2)])
        tm.complete_task("dom", "tl", 0, 2)
        tm.complete_tasks_less_than("dom", "tl", 0, 2)
        lease.ack_level = 3
        tm.update_task_list(lease)
        # domains
        md = b.metadata
        for name, did in (("dom", "dom-id"), ("other", "other-id")):
            md.create_domain(R.DomainRecord(
                info=R.DomainInfo(id=did, name=name, description=name),
                config=R.DomainConfig(retention_days=3),
                replication_config=R.DomainReplicationConfig()))
        rec = md.get_domain(name="other")
        rec.config.retention_days = 9
        md.update_domain(rec)
        # visibility
        vis = b.visibility
        for i, (wf, run) in enumerate(runs[:6]):
            vis.record_workflow_execution_started(R.VisibilityRecord(
                domain_id="dom", workflow_id=wf, run_id=run,
                workflow_type="t", start_time=1_000 + i,
                memo={"m": i}, search_attributes={"CustomIntField": i}))
        vis.record_workflow_execution_closed(R.VisibilityRecord(
            domain_id="dom", workflow_id=runs[1][0], run_id=runs[1][1],
            workflow_type="t", start_time=1_001, close_time=2_000,
            close_status=1, history_length=9))
        vis.upsert_workflow_execution(R.VisibilityRecord(
            domain_id="dom", workflow_id=runs[2][0], run_id=runs[2][1],
            workflow_type="t", start_time=1_002,
            search_attributes={"CustomKeywordField": "x"}))
        vis.delete_workflow_execution("dom", *runs[3])
        # checkpoints
        store = b.checkpoint
        for eid in (5, 9, 14):
            ck = M.ck.ReplayCheckpoint.from_json(ck_blob)
            ck.event_id = eid
            store.put_checkpoint(ck)
        store.prune_tree("run-ck", 2)
    finally:
        b.close()


def test_schema_is_the_reference_schema():
    assert Schema.MIGRATIONS == JSchema.MIGRATIONS
    assert Schema.CURRENT_SCHEMA_VERSION == JSchema.CURRENT_SCHEMA_VERSION


def test_script_leaves_byte_equal_tables(tmp_path, monkeypatch):
    ck_blob, batches = _checkpoint_blob()
    for pkg in ("cadence_tpu", "cadence_tpu_torch"):
        run_script(pkg, str(tmp_path / f"{pkg}.db"), ck_blob, batches,
                   monkeypatch)
    want = dump(str(tmp_path / "cadence_tpu.db"))
    got = dump(str(tmp_path / "cadence_tpu_torch.db"))
    assert set(got) == set(want)
    for table in sorted(want):
        assert got[table] == want[table], table
    # the script reached every table
    assert all(want[t] for t in want if t != "__ddl__"), \
        [t for t in want if not want[t]]


def _task_dicts(tasks):
    return [{k: int(v) if k == "task_type" else v
             for k, v in dataclasses.asdict(t).items()} for t in tasks]


def test_queue_task_codecs_match_both_ways():
    J, T = _mods("cadence_tpu"), _mods("cadence_tpu_torch")
    jt, pt = _tasks(J, "wf", "run", 40), _tasks(T, "wf", "run", 40)
    for kind, codec in (("transfer_tasks", "transfer"),
                        ("timer_tasks", "timer"),
                        ("replication_tasks", "replication")):
        enc = getattr(T.serde, f"{codec}_to_json")
        dec = getattr(T.serde, f"{codec}_from_json")
        jenc = getattr(J.serde, f"{codec}_to_json")
        jdec = getattr(J.serde, f"{codec}_from_json")
        for j, p in zip(jt[kind], pt[kind]):
            assert enc(p) == jenc(j)
            assert _task_dicts([dec(jenc(j))]) == _task_dicts([j])
            assert _task_dicts([jdec(enc(p))]) == _task_dicts([p])
            assert type(dec(jenc(j))) is type(p)
    snap = _snapshot(T, "wf", "run", 3).snapshot
    assert T.serde.snapshot_to_json(snap) == J.serde.snapshot_to_json(snap)
    back = T.serde.snapshot_from_json(J.serde.snapshot_to_json(snap))
    assert back == J.serde.snapshot_from_json(J.serde.snapshot_to_json(snap))


def _seed_reference_file(path, n):
    """A sqlite file the reference package writes: ``n`` fuzzed histories
    and, from a checkpointed reference rebuild, one checkpoint a run."""
    jb = j_create_sqlite_bundle(path)
    hs = [JHistoryFuzzer(seed=90 + i).generate(target_events=20 + 9 * i)
          for i in range(n)]
    jreqs = []
    for i, batches in enumerate(hs):
        br = jb.history.new_history_branch(tree_id=f"run-{i}")
        for txn, batch in enumerate(batches, 1):
            jb.history.append_history_nodes(br, batch, transaction_id=txn)
        jreqs.append(JRebuildRequest(
            domain_id="dom", workflow_id=f"wf-{i}", run_id=f"run-{i}",
            branch_token=br.to_json().encode()))
    jscope = JScope()
    want = JStateRebuilder(
        jb.history, lane_len=256, metrics=jscope,
        checkpoints=JCheckpointManager(
            jb.checkpoint, JCheckpointPolicy(every_events=1, keep_last=1)),
    ).rebuild_many(jreqs)
    assert jb.checkpoint.count_checkpoints() == n
    jb.close()
    return jreqs, want


def test_reference_file_opens_and_rebuilds_on_port(tmp_path):
    path = str(tmp_path / "ref.db")
    n = 6
    jreqs, want = _seed_reference_file(path, n)
    # the boot gate: no migration needed, nothing refused
    conn = sqlite3.connect(path)
    Schema.check_compat(conn)
    conn.close()
    bundle = create_sqlite_bundle(path, auto_setup=False)
    try:
        reqs = [RebuildRequest(domain_id=r.domain_id,
                               workflow_id=r.workflow_id, run_id=r.run_id,
                               branch_token=r.branch_token) for r in jreqs]
        cold = StateRebuilder(bundle.history, lane_len=256,
                              device="cpu").rebuild_many(reqs)
        assert_same_rebuilds(cold, want)

        # the reference's checkpoints carry its fingerprint: stale here,
        # a full replay, never an error or a resume on their rows
        scope = Scope()
        mgr = CheckpointManager(bundle.checkpoint,
                                CheckpointPolicy(every_events=1 << 30))
        for r in reqs:
            assert mgr.lookup(r.branch_token, caps=S.Capacities()) == (
                None, "invalidated")
        warm = StateRebuilder(bundle.history, lane_len=256, device="cpu",
                              checkpoints=mgr, metrics=scope
                              ).rebuild_many(reqs)
        assert_same_rebuilds(warm, want)
        reg = scope.registry
        assert reg.counter_value("checkpoint_hit") == 0
        assert reg.counter_value("checkpoint_invalidated") == n
        assert reg.counter_value("events_replayed_saved") == 0
        stale = bundle.checkpoint.list_checkpoints(
            reqs[0].branch_token.decode())
        assert stale and isinstance(stale[0], ReplayCheckpoint)
    finally:
        bundle.close()
