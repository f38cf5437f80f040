"""The port's history host against the reference package's.

One script drives two single-process service planes, built as the
reference's ``tests/test_service_plane.py`` builds its ``Box`` (memory
persistence, ``register_domain``, ``DomainCache``,
``single_host_monitor``, ``HistoryService`` with live transfer and
timer queues, ``HistoryClient``, ``MatchingEngine``, ``MatchingClient``)
plus a resident serving engine: once over ``cadence_tpu`` and once over
``cadence_tpu_torch`` (every port object on ``device="cpu"``). Both
boxes share the clock's start (a ``FakeTimeSource`` handed to history
and matching), the domain id and every start request id. The script
runs 16 workflows over 4 shards, each on its own task list: starts,
decision polls answered through matching with no decision,
``ScheduleActivityTask`` or ``StartTimer``, an activity round trip,
signals, a timer fired by ``advance()``, completions and one
``ContinueAsNew``.

Run ids, branch ids and the matching poll nonce are drawn with
``uuid.uuid4`` on each side, so every uuid is compared through a
first-seen renaming: each side's uuids are replaced by ``U0``, ``U1``,
... in the order a fixed walk of the results meets them. Everything
else is compared exactly: every stored history event by event, the
describe responses, the persisted mutable-state snapshots, the transfer
and timer tasks each side's queues processed, the serving reads (the
two engines' rows, and the port's against its host ``StateBuilder``
replay of the stored history) and the drain at ``stop()``.
"""

import dataclasses
import enum
import importlib
import re
import types

import numpy as np
import pytest

DOMAIN = "svc-domain"
DOMAIN_ID = "00000000-0000-4000-8000-00000000d0d0"
START_NS = 1_700_000_000 * 1_000_000_000
N_WORKFLOWS = 16
N_SHARDS = 4
LANES = 8
MAX_EVENTS = 64
POLL_S = 10.0
# the kinds of the script's workflows, by index mod 4
NOOP, ACTIVITY, TIMER, CAN = range(4)
SIGNALED_KINDS = (NOOP, TIMER)
SIGNAL_ROUNDS = 2
TIMER_S = 5

_UUID = re.compile(
    r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")


def _mods(pkg):
    """The names the script needs, from ``cadence_tpu`` or the port."""
    m = lambda name: importlib.import_module(f"{pkg}.{name}")
    client, matching = m("client"), m("matching")
    api, domains = m("runtime.api"), m("runtime.domains")
    queues = m("runtime.queues")
    return types.SimpleNamespace(
        pkg=pkg,
        HistoryClient=client.HistoryClient,
        MatchingClient=client.MatchingClient,
        MatchingEngine=matching.MatchingEngine,
        PollRequest=matching.PollRequest,
        Decision=api.Decision,
        StartWorkflowRequest=api.StartWorkflowRequest,
        SignalRequest=api.SignalRequest,
        DecisionType=m("core.enums").DecisionType,
        EventType=m("core.enums").EventType,
        DomainCache=domains.DomainCache,
        register_domain=domains.register_domain,
        single_host_monitor=m("runtime.membership").single_host_monitor,
        create_memory_bundle=m(
            "runtime.persistence.memory").create_memory_bundle,
        BranchToken=m("runtime.persistence.records").BranchToken,
        HistoryService=m("runtime.service").HistoryService,
        FakeTimeSource=m("utils.clock").FakeTimeSource,
        TransferQueueProcessor=queues.TransferQueueProcessor,
        TimerQueueProcessor=queues.TimerQueueProcessor,
    )


def _jax_serving(persistence):
    from cadence_tpu.checkpoint import (
        CheckpointManager, MemoryCheckpointStore)
    from cadence_tpu.ops import schema as JS
    from cadence_tpu.serving import ResidentEngine

    return ResidentEngine(
        lanes=LANES, caps=JS.Capacities(max_events=MAX_EVENTS),
        history=persistence.history,
        checkpoints=CheckpointManager(MemoryCheckpointStore()))


def _port_serving(persistence):
    from cadence_tpu_torch.checkpoint import (
        CheckpointManager, MemoryCheckpointStore)
    from cadence_tpu_torch.ops import schema as S
    from cadence_tpu_torch.serving import ResidentEngine

    return ResidentEngine(
        lanes=LANES, caps=S.Capacities(max_events=MAX_EVENTS),
        history=persistence.history,
        checkpoints=CheckpointManager(MemoryCheckpointStore()),
        device="cpu")


def _host_replay(history, domain_id, workflow_id, run_id, branch_token):
    """The port's host oracle: ``StateBuilder`` over the stored history,
    in the canonical snapshot form the serving reads carry."""
    from cadence_tpu_torch.runtime.replication.rebuilder import (
        RebuildRequest, StateRebuilder)
    from cadence_tpu_torch.ops.unpack import mutable_state_to_snapshot

    ms, _, _ = StateRebuilder(history, device="cpu").rebuild(
        RebuildRequest(domain_id, workflow_id, run_id, branch_token))
    return mutable_state_to_snapshot(ms)


class _Box:
    """A single-process service plane over one package."""

    def __init__(self, M, serving_factory):
        self.M = M
        self.clock = M.FakeTimeSource(START_NS)
        self.persistence = M.create_memory_bundle()
        self.domain_id = M.register_domain(
            self.persistence.metadata, DOMAIN, domain_id=DOMAIN_ID)
        self.domains = M.DomainCache(self.persistence.metadata)
        self.monitor = M.single_host_monitor("box-0")
        self.serving = serving_factory(self.persistence)
        self.history = M.HistoryService(
            N_SHARDS, self.persistence, self.domains, self.monitor,
            time_source=self.clock, serving=self.serving)
        self.history_client = M.HistoryClient(self.history.controller)
        self.matching = M.MatchingEngine(
            self.persistence.task, self.history_client,
            time_source=self.clock)
        self.history.wire(M.MatchingClient(self.matching),
                          self.history_client)
        self.history.start()

    def stop(self):
        self.history.stop()
        self.matching.shutdown()

    def poll_decision(self, tl):
        task = self.matching.poll_for_decision_task(
            self.M.PollRequest(self.domain_id, tl, "worker", POLL_S))
        assert task is not None, f"no decision task on {tl}"
        return task

    def respond(self, tl, decisions):
        task = self.poll_decision(tl)
        self.history_client.respond_decision_task_completed(
            task.task_token, decisions, identity="worker")
        return task

    def branch_token(self, wf, run):
        shard = self.history.controller.shard_for(wf)
        snap = self.persistence.execution.get_workflow_execution(
            shard, self.domain_id, wf, run).snapshot
        return snap["execution_info"]["branch_token"]


def _record_tasks(M, log):
    """Wrap both queue processors' ``_process`` so every task that ran
    to its end is logged; returns the undo."""
    saved = []
    for cls in (M.TransferQueueProcessor, M.TimerQueueProcessor):
        orig = cls._process

        def wrapped(self, task, _orig=orig, _kind=cls.__name__):
            _orig(self, task)
            log.append((_kind, dataclasses.asdict(task)))

        saved.append((cls, orig))
        cls._process = wrapped

    def undo():
        for cls, orig in saved:
            cls._process = orig
    return undo


def _wf(i):
    return f"wf-{i:02d}", f"tl-{i:02d}"


def _run_script(M, serving_factory, oracle=False):
    """Drive one box through the script; returns what the tests hold."""
    D, DT = M.Decision, M.DecisionType
    tasks = []
    undo = _record_tasks(M, tasks)
    box = _Box(M, serving_factory)
    out = {"reads": [], "oracle": [], "runs": {}}
    try:
        for i in range(N_WORKFLOWS):
            wf, tl = _wf(i)
            out["runs"][wf] = box.history_client.start_workflow_execution(
                M.StartWorkflowRequest(
                    domain=DOMAIN, workflow_id=wf, workflow_type="echo",
                    task_list=tl, input=f"in-{i}".encode(),
                    execution_start_to_close_timeout_seconds=3600,
                    task_start_to_close_timeout_seconds=600,
                    request_id=f"start-{i}"))
        for i in range(N_WORKFLOWS):
            wf, tl = _wf(i)
            kind = i % 4
            if kind == NOOP:
                box.respond(tl, [])
            elif kind == ACTIVITY:
                box.respond(tl, [D(DT.ScheduleActivityTask, {
                    "activity_id": f"a-{i}", "activity_type": "work",
                    "task_list": tl, "input": b"ping",
                    "schedule_to_close_timeout_seconds": 600,
                    "schedule_to_start_timeout_seconds": 600,
                    "start_to_close_timeout_seconds": 600,
                    "heartbeat_timeout_seconds": 0,
                })])
                act = box.matching.poll_for_activity_task(
                    M.PollRequest(box.domain_id, tl, "worker", POLL_S))
                assert act is not None and act.activity_id == f"a-{i}"
                box.history_client.respond_activity_task_completed(
                    act.task_token, result=b"pong", identity="worker")
                box.respond(tl, [])
            elif kind == TIMER:
                box.respond(tl, [D(DT.StartTimer, {
                    "timer_id": f"t-{i}",
                    "start_to_fire_timeout_seconds": TIMER_S,
                })])
            elif i == CAN:
                box.respond(tl, [D(DT.ContinueAsNewWorkflowExecution, {
                    "input": b"again"})])
                box.respond(tl, [])  # the new run's first decision
            else:
                box.respond(tl, [])
        # the timers fire once the clock passes them
        box.clock.advance((TIMER_S + 1) * 1_000_000_000)
        for i in range(N_WORKFLOWS):
            if i % 4 == TIMER:
                task = box.respond(_wf(i)[1], [])
                assert any(e.event_type == M.EventType.TimerFired
                           for e in task.history)
        for r in range(SIGNAL_ROUNDS):
            for i in range(N_WORKFLOWS):
                if i % 4 not in SIGNALED_KINDS:
                    continue
                wf, tl = _wf(i)
                box.history_client.signal_workflow_execution(
                    M.SignalRequest(domain=DOMAIN, workflow_id=wf,
                                    signal_name="go",
                                    input=f"s{r}".encode(),
                                    identity="signaler",
                                    request_id=f"sig-{r}-{i}"))
                read = box.history.serving_read(box.domain_id, wf)
                out["reads"].append((wf, read))
                if oracle:
                    run = out["runs"][wf]
                    out["oracle"].append(_host_replay(
                        box.persistence.history, box.domain_id, wf, run,
                        box.branch_token(wf, run)))
                box.respond(tl, [])
        for i in range(N_WORKFLOWS):
            if i % 4 in (NOOP, ACTIVITY):
                wf, tl = _wf(i)
                box.history_client.signal_workflow_execution(
                    M.SignalRequest(domain=DOMAIN, workflow_id=wf,
                                    signal_name="done", input=b"",
                                    identity="signaler",
                                    request_id=f"done-{i}"))
                box.respond(tl, [D(DT.CompleteWorkflowExecution,
                                   {"result": f"r-{i}".encode()})])
        assert box.history.drain_queues(20.0)
        out.update(_collect(box, out["runs"]))
        serving, drains = box.serving, []
        orig_drain = serving.drain
        serving.drain = lambda: drains.append(orig_drain()) or drains[-1]
        box.stop()
        box = None
        out["drain"] = drains
        out["seated_after"] = serving.describe()["seated"]
        out["occupancy_after"] = serving.occupancy()
    finally:
        undo()
        if box is not None:
            box.stop()
    out["tasks"] = tasks
    return out


def _collect(box, starts):
    """Histories, describes and snapshots of every run, in a fixed
    order: workflows by id, runs in continue-as-new order."""
    M = box.M
    histories, describes, snapshots = {}, {}, {}
    for i in range(N_WORKFLOWS):
        wf, _ = _wf(i)
        runs = []
        shard = box.history.controller.shard_for(wf)
        ex = box.persistence.execution
        # walk the chain from the started run through ContinueAsNew
        chain = [starts[wf]]
        while True:
            token = box.branch_token(wf, chain[-1])
            batches, _ = box.persistence.history.read_history_branch(
                M.BranchToken.from_json(
                    token.decode() if isinstance(token, bytes) else token),
                1, 1 << 60)
            events = [e for b in batches for e in b]
            runs.append([e.to_dict() for e in events])
            snapshots[(wf, len(chain))] = ex.get_workflow_execution(
                shard, box.domain_id, wf, chain[-1]).snapshot
            describes[(wf, len(chain))] = dataclasses.asdict(
                box.history_client.describe_workflow_execution(
                    DOMAIN, wf, chain[-1]))
            last = events[-1]
            if last.event_type != M.EventType.WorkflowExecutionContinuedAsNew:
                break
            chain.append(last.attributes["new_execution_run_id"])
        histories[wf] = runs
    return {"histories": histories, "describes": describes,
            "snapshots": snapshots}


class _Renamer:
    """First-seen renaming of uuid4 strings: ``U0``, ``U1``, ..."""

    def __init__(self):
        self.names = {}

    def _sub(self, m):
        return self.names.setdefault(m.group(0), f"U{len(self.names)}")

    def __call__(self, obj):
        if isinstance(obj, enum.Enum):
            return obj.value
        if isinstance(obj, bytes):
            try:
                return ("bytes", _UUID.sub(self._sub, obj.decode()))
            except UnicodeDecodeError:
                return ("bytes", obj.hex())
        if isinstance(obj, str):
            return _UUID.sub(self._sub, obj)
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            return self(dataclasses.asdict(obj))
        if isinstance(obj, dict):
            return {self(k) if isinstance(k, str) else k: self(v)
                    for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [self(v) for v in obj]
        if isinstance(obj, (set, frozenset)):
            return sorted(self(v) for v in obj)
        if isinstance(obj, np.generic):
            return obj.item()
        return obj


def _renamed(out):
    """One side's results with its uuids renamed, walked in a fixed
    order (histories first, so a run id is named where it starts)."""
    ren = _Renamer()
    hist = ren(out["histories"])
    return {
        "histories": hist,
        "describes": ren({f"{k[0]}#{k[1]}": v
                          for k, v in sorted(out["describes"].items())}),
        "snapshots": ren({f"{k[0]}#{k[1]}": v
                          for k, v in sorted(out["snapshots"].items())}),
        "tasks": sorted(
            repr(ren((kind, {k: v for k, v in task.items()
                             if k != "task_id"})))
            for kind, task in out["tasks"]),
        "reads": [(wf, r.resident, ren(r.snapshot))
                  for wf, r in out["reads"]],
    }


@pytest.fixture(scope="module")
def both():
    jax_out = _run_script(_mods("cadence_tpu"), _jax_serving)
    port_out = _run_script(_mods("cadence_tpu_torch"), _port_serving,
                           oracle=True)
    return jax_out, port_out, _renamed(jax_out), _renamed(port_out)


def test_histories_match_event_by_event(both):
    _, _, j, p = both
    assert set(j["histories"]) == set(p["histories"])
    for wf in sorted(j["histories"]):
        jr, pr = j["histories"][wf], p["histories"][wf]
        assert len(jr) == len(pr), wf
        for run_j, run_p in zip(jr, pr):
            assert len(run_j) == len(run_p), wf
            for ej, ep in zip(run_j, run_p):
                for key in ("event_id", "event_type", "version",
                            "timestamp", "attributes"):
                    assert ej[key] == ep[key], (wf, ej["event_id"], key)
                assert ej == ep
    # the script reached every path it names
    j_types = {e["event_type"] for runs in j["histories"].values()
               for r in runs for e in r}
    from cadence_tpu_torch.core.enums import EventType as E
    for t in (E.ActivityTaskCompleted, E.TimerFired,
              E.WorkflowExecutionSignaled,
              E.WorkflowExecutionContinuedAsNew,
              E.WorkflowExecutionCompleted):
        assert int(t) in j_types, t.name


def test_describe_matches(both):
    _, _, j, p = both
    assert j["describes"] == p["describes"]
    running = [k for k, v in p["describes"].items() if v["is_running"]]
    # the timer workflows, the continued run and the other CAN-kind
    # workflows stay open
    assert len(running) == 2 * N_WORKFLOWS // 4


def test_persisted_snapshots_match(both):
    _, _, j, p = both
    assert j["snapshots"].keys() == p["snapshots"].keys()
    for k in j["snapshots"]:
        assert j["snapshots"][k] == p["snapshots"][k], k


def test_dispatched_tasks_match(both):
    """The same tasks ran on both sides, every field but the task id:
    an id is the shard's next one when its transaction commits, and the
    timer queue's workers commit the fired timers of one shard in either
    order, on either side."""
    _, _, j, p = both
    assert j["tasks"] == p["tasks"]
    kinds = {t.split("'")[1] for t in p["tasks"]}
    assert kinds == {"TransferQueueProcessor", "TimerQueueProcessor"}


def test_serving_reads_match_jax_engine(both):
    jo, po, j, p = both
    from cadence_tpu_torch.ops import schema as S

    assert len(jo["reads"]) == len(po["reads"]) == (
        SIGNAL_ROUNDS * N_WORKFLOWS * len(SIGNALED_KINDS) // 4)
    assert [r[:2] for r in j["reads"]] == [r[:2] for r in p["reads"]]
    for (wf, jr), (_, pr) in zip(jo["reads"], po["reads"]):
        assert jr.epoch_s == pr.epoch_s, wf
        for f in S.STATE_ROW_FIELDS:
            np.testing.assert_array_equal(
                np.asarray(jr.state_row[f]), np.asarray(pr.state_row[f]),
                err_msg=f"{wf} field {f}")
    assert [r[2] for r in j["reads"]] == [r[2] for r in p["reads"]]
    # the first round seats every signaled workflow (a cold miss), the
    # second answers from the resident lanes with the Δ composed
    n = len(po["reads"]) // SIGNAL_ROUNDS
    assert [r.resident for _, r in po["reads"][n:]] == [True] * n


def test_serving_reads_match_host_replay(both):
    _, po, _, _ = both
    assert len(po["oracle"]) == len(po["reads"])
    for (wf, read), want in zip(po["reads"], po["oracle"]):
        assert read.snapshot == want, wf


def test_stop_drains_both_engines(both):
    jo, po, _, _ = both
    assert len(jo["drain"]) == len(po["drain"]) == 1
    assert jo["drain"] == po["drain"]
    # the lanes of the workflows still open (the timer kind) flush;
    # the completed workflows' lanes were freed at their close
    assert po["drain"][0]["flushed"] == N_WORKFLOWS // 4
    assert po["drain"][0]["flush_failed"] == 0
    for o in (jo, po):
        assert o["seated_after"] == 0
        assert o["occupancy_after"] == 0.0


def test_jax_host_with_port_serving_plane(both):
    """The injection check: the reference package's ``HistoryService``
    with the port's ``ResidentEngine(device="cpu")`` and checkpoint plane
    handed in, as ``cadence_tpu/testing/onebox.py`` hands its own in.
    The reference's engine feeds the port's lanes its events, branch
    tokens and persist notices; the reads must equal the port's own box
    and the port's host replay of the reference's stored history."""
    _, po, _, p = both
    mixed = _run_script(_mods("cadence_tpu"), _port_serving, oracle=True)
    m = _renamed(mixed)
    assert m["histories"] == p["histories"]
    assert [r[:2] for r in m["reads"]] == [r[:2] for r in p["reads"]]
    assert [r[2] for r in m["reads"]] == [r[2] for r in p["reads"]]
    for (wf, read), want in zip(mixed["reads"], mixed["oracle"]):
        assert read.snapshot == want, wf
    assert mixed["drain"] == po["drain"]
    assert mixed["seated_after"] == 0


def test_tasks_visible_in_id_order_under_concurrent_commits():
    """A shard's tasks become readable in task-id order. Workflow A's
    transaction takes its task ids, then stalls in the store write;
    workflow B's transaction on the same shard takes the next ids. B's
    write must wait for A's: were B's activity task readable first, the
    transfer pump would read past A's lower id and never dispatch it
    (the reference package's copy releases the shard lock between the id
    allocation and the write, and loses such tasks under concurrent
    responders)."""
    import threading
    import time

    M = _mods("cadence_tpu_torch")
    box = _Box(M, lambda p: None)
    try:
        ex = box.persistence.execution
        write = ex.update_workflow_execution
        stall = threading.Event()

        def slow(shard_id, range_id, condition, mutation, **kw):
            if mutation.workflow_id == "wf-a" and mutation.transfer_tasks:
                stall.set()
                time.sleep(0.5)
            return write(shard_id, range_id, condition, mutation, **kw)

        ex.update_workflow_execution = slow
        shard = box.history.controller.shard_for("wf-a")
        wfs = ["wf-a"] + [f"wf-b{i}" for i in range(64)
                          if box.history.controller.shard_for(
                              f"wf-b{i}") == shard][:1]
        tasks = {}
        for wf in wfs:
            box.history_client.start_workflow_execution(
                M.StartWorkflowRequest(
                    domain=DOMAIN, workflow_id=wf, workflow_type="echo",
                    task_list=f"tl-{wf}",
                    execution_start_to_close_timeout_seconds=3600,
                    task_start_to_close_timeout_seconds=600,
                    request_id=f"start-{wf}"))
            tasks[wf] = box.poll_decision(f"tl-{wf}")

        def schedule(wf):
            box.history_client.respond_decision_task_completed(
                tasks[wf].task_token, [M.Decision(
                    M.DecisionType.ScheduleActivityTask, {
                        "activity_id": "a", "activity_type": "work",
                        "task_list": f"tl-{wf}", "input": b"",
                        "schedule_to_close_timeout_seconds": 600,
                        "schedule_to_start_timeout_seconds": 600,
                        "start_to_close_timeout_seconds": 600,
                        "heartbeat_timeout_seconds": 0})],
                identity="worker")

        a = threading.Thread(target=schedule, args=("wf-a",))
        a.start()
        assert stall.wait(5.0)
        schedule(wfs[1])  # takes higher ids while A's write stalls
        a.join(10.0)
        assert not a.is_alive()
        for wf in wfs:
            act = box.matching.poll_for_activity_task(
                M.PollRequest(box.domain_id, f"tl-{wf}", "worker", 5.0))
            assert act is not None, f"the activity task of {wf} was lost"
    finally:
        box.stop()


@pytest.mark.parametrize("num_shards", [1, 4, 7])
def test_shard_routing_matches_reference(num_shards):
    """The port's epoch-0 ShardMap routes every workflow id to the
    reference's shard, and a stored map reads back through the shard
    store as the reference's does."""
    from cadence_tpu.runtime import resharding as JR
    from cadence_tpu.runtime.persistence.memory import (
        MemoryShardManager as JShardManager)
    from cadence_tpu_torch.runtime import resharding as R

    ids = [f"wf-{i}" for i in range(500)] + ["", "ü-ñ", "x" * 300]
    jm, pm = JR.ShardMap.initial(num_shards), R.ShardMap.initial(num_shards)
    assert [pm.shard_for(w) for w in ids] == [jm.shard_for(w) for w in ids]
    assert pm.to_dict() == jm.to_dict()
    split, _ = jm.split(0)
    store = JShardManager()
    store.set_reshard_state(
        split.epoch, JR._state_blob(split, None, max(split.shard_ids())),
        previous_epoch=0)
    got, plan = R.load_reshard_state(store)
    assert got.to_dict() == split.to_dict() and plan is None
    assert [got.shard_for(w) for w in ids] == [split.shard_for(w)
                                              for w in ids]
