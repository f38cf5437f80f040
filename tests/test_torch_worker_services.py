"""The port's worker services against the reference package's.

One seeded script runs through both packages' Oneboxes, each with its
worker services on (the default) over a sqlite file: workflows run to
completion and are archived (history and visibility, ``file://``), two
open workflows are terminated through the parent-close-policy system
workflow, three by a batch workflow through a visibility query, orphan
history trees go in two scavenger passes, and every closed run is
deleted by retention, its history then read from the archive. The
archives' files are equal file for file (uuids renamed first-seen and
wall-clock values zeroed: each box runs on the wall clock), as are the
batcher's, the parent-close policy's and the scavenger's results, the
visibility listings and the histories read back.

Then the repairs of faults the port copied from the reference (ROADMAP
§C): the memory store's ``list_history_trees`` (C.2), without which the
history scavenger skips the memory store; the close processor's
parent-close policy (C.3), which read a ``domain_id`` that a mutable
state does not have, so the close of a parent with started children
failed and no policy applied; and ``SignalWithStart`` against a start
that lands between its probe and its own start (C.4), which lost the
signal (an archival request, when two closes trigger the archival
workflow at once).
"""

from __future__ import annotations

import importlib
import json
import os
import re
import time
import types

from test_torch_service import _Renamer

DOMAIN = "wsv-domain"
TASK_LIST = "wsv-tl"
N_ECHO, N_BATCH, N_PCP, N_ORPHANS = 6, 3, 2, 2
WAIT_S = 60.0
_BIG_NS = 10 ** 15  # a wall-clock value in ns (the year 2001 on)
_STICKY = re.compile(r":[0-9a-f]{8}:sticky$")


def _mods(pkg):
    def imp(m):
        return importlib.import_module(f"{pkg}.{m}")

    return types.SimpleNamespace(
        pkg=pkg, onebox=imp("testing.onebox"),
        sqlite=imp("runtime.persistence.sqlite"), sdk=imp("worker.sdk"),
        api=imp("runtime.api"), enums=imp("core.enums"),
        F=imp("core.history_factory"), archival=imp("archival"),
        domain_handler=imp("frontend.domain_handler"),
        batcher=imp("worker.batcher"),
        pcp=imp("worker.parent_close_policy"),
        service=imp("worker.service"),
        retention=imp("runtime.queues.retention"))


def _wait(what, done):
    t0 = time.monotonic()
    while not done():
        assert time.monotonic() - t0 < WAIT_S, f"{what} not done"
        time.sleep(0.05)


def _echo(ctx, input):
    out = yield ctx.schedule_activity("work", input)
    return out


def _sink(ctx, input):
    while True:
        yield ctx.wait_signal("ping")


def _zero_clock(obj):
    """Wall-clock values (ns under a key naming a time) zeroed, and a
    sticky task list's random part."""
    if isinstance(obj, str):
        return _STICKY.sub(":sticky", obj)
    if isinstance(obj, dict):
        return {k: 0 if ("time" in k and isinstance(v, int)
                         and v >= _BIG_NS) else _zero_clock(v)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_zero_clock(v) for v in obj]
    return obj


def _archive_files(root, ren):
    """Every archived file under ``root``: its path and its JSON, uuids
    renamed, wall-clock values zeroed. Walked in sorted order of the
    renamed paths, so each side names its uuids in the same order."""
    found = []
    for d, _, files in os.walk(root):
        for f in files:
            found.append(os.path.join(d, f))
    # history files first, each named where its workflow id sorts
    found.sort(key=lambda p: re.sub(r"[0-9a-f-]{36}", "", p))
    out = {}
    for path in found:
        rel = ren(os.path.relpath(path, root))
        with open(path) as f:
            out[rel] = ren(_zero_clock(json.load(f)))
    return out


def run_script(M, tmp, device_kw):
    """The script through one package's Onebox; returns what it saw."""
    api = M.api
    bundle = M.sqlite.create_sqlite_bundle(str(tmp / "store.db"))
    box = M.onebox.Onebox(num_shards=2, persistence=bundle,
                          **device_kw).start()
    worker = M.sdk.Worker(box.frontend, DOMAIN, TASK_LIST, identity="w")
    worker.register_workflow("echo", _echo)
    worker.register_workflow("sink", _sink)
    worker.register_workflow("target", _sink)
    worker.register_activity("work", lambda b: b"done:" + b)
    out = {}
    try:
        status = M.domain_handler.ArchivalStatus.ENABLED
        box.frontend.register_domain(
            DOMAIN, retention_days=1, history_archival_status=status,
            history_archival_uri=f"file://{tmp}/h",
            visibility_archival_status=status,
            visibility_archival_uri=f"file://{tmp}/v")
        domain_id = box.domains.get_by_name(DOMAIN).info.id
        worker.start()

        def start(wf, wtype):
            return box.frontend.start_workflow_execution(
                api.StartWorkflowRequest(
                    domain=DOMAIN, workflow_id=wf, workflow_type=wtype,
                    task_list=TASK_LIST, input=wf.encode(),
                    execution_start_to_close_timeout_seconds=3600,
                    task_start_to_close_timeout_seconds=60))

        def decided(runs):
            # every run's first decision completed: where a terminate
            # lands then does not hang on the worker's timing
            return all(len(box.frontend.get_workflow_execution_history(
                DOMAIN, wf, run)[0]) == 4 for wf, run in runs.items())

        def closed(wf, run):
            return not box.frontend.describe_workflow_execution(
                DOMAIN, wf, run).is_running

        harch = M.archival.ArchiverProvider.default() \
            .get_history_archiver("file")
        huri = M.archival.URI.parse(f"file://{tmp}/h")

        def archived(runs):
            return all(os.path.exists(harch._path(huri, domain_id, wf, run))
                       for wf, run in runs.items())

        # the first close starts the archival workflow alone; the rest
        # signal it
        runs = {"echo-0": start("echo-0", "echo")}
        _wait("the first archive", lambda: archived(runs))
        for i in range(1, N_ECHO):
            runs[f"echo-{i}"] = start(f"echo-{i}", "echo")
        _wait("the echo workflows", lambda: all(
            closed(wf, run) for wf, run in runs.items()))

        # the parent-close-policy system workflow terminates two
        pcp = {f"pcp-{i}": start(f"pcp-{i}", "sink") for i in range(N_PCP)}
        _wait("the first decisions", lambda: decided(pcp))
        M.pcp.ParentClosePolicyClient(box.frontend).send(
            [{"domain": DOMAIN, "workflow_id": wf, "run_id": run,
              "policy": "terminate"} for wf, run in pcp.items()])
        _wait("the parent-close policy", lambda: all(
            closed(wf, run) for wf, run in pcp.items()))
        out["pcp"] = [int(box.frontend.describe_workflow_execution(
            DOMAIN, wf, run).close_status) for wf, run in pcp.items()]

        # a batch workflow terminates three through a visibility query
        targets = {f"target-{i}": start(f"target-{i}", "target")
                   for i in range(N_BATCH)}
        _wait("the first decisions", lambda: decided(targets))
        assert box.history.drain_queues()
        sysdom = M.service.SYSTEM_DOMAIN
        batch_run = box.frontend.start_workflow_execution(
            api.StartWorkflowRequest(
                domain=sysdom, workflow_id="batch-1",
                workflow_type=M.batcher.BATCHER_WORKFLOW_TYPE,
                task_list=M.batcher.BATCHER_TASK_LIST,
                input=json.dumps({
                    "operation": "terminate", "domain": DOMAIN,
                    "query": "WorkflowType = 'target' AND CloseTime = 0",
                    "params": {"reason": "sweep"}}).encode(),
                execution_start_to_close_timeout_seconds=300))
        _wait("the batch", lambda: not box.frontend.describe_workflow_execution(
            sysdom, "batch-1", batch_run).is_running)
        events, _ = box.frontend.get_workflow_execution_history(
            sysdom, "batch-1", batch_run)
        out["batch"] = json.loads(events[-1].attributes["result"])
        out["targets"] = sorted(
            int(box.frontend.describe_workflow_execution(
                DOMAIN, wf, run).close_status)
            for wf, run in targets.items())

        # every closed run archived; visibility and histories before
        # retention
        every = {**runs, **pcp, **targets}
        _wait("the archives", lambda: archived(every))
        assert box.history.drain_queues()
        ren = _Renamer()
        before = {wf: box.frontend.get_workflow_execution_history(
            DOMAIN, wf, run)[0] for wf, run in sorted(every.items())}
        out["histories"] = ren(_zero_clock(
            {wf: [e.to_dict() for e in evs]
             for wf, evs in sorted(before.items())}))
        listed, _ = box.frontend.list_closed_workflow_executions(
            DOMAIN, page_size=100)
        out["visibility"] = sorted(
            (ren(r.workflow_id), r.workflow_type, r.close_status,
             r.history_length, ren(r.run_id)) for r in listed)
        vis_files = []
        _wait("the visibility archive", lambda: vis_files.append(
            len(os.listdir(tmp / "v" / domain_id / "visibility")))
            or vis_files[-1] == len(every))
        out["archive"] = {
            name: _archive_files(str(tmp / name), ren)
            for name in ("h", "v")}

        # the scavenger: settled, then two passes over planted orphans
        scanner = box.worker.workers[1].activities._activities
        for _ in range(2):
            scanner["scavenge_history"](b"")
        h = box.persistence.history
        for i in range(N_ORPHANS):
            br = h.new_history_branch(tree_id=f"orphan-{i}")
            h.append_history_nodes(br, [M.F.workflow_execution_started(
                1, 0, 0, task_list="x", workflow_type="t")],
                transaction_id=1)
        out["scavenger"] = [json.loads(scanner["scavenge_history"](b""))
                            for _ in range(2)]
        trees = {t for t, _ in h.list_history_trees()}
        out["orphans_left"] = sorted(t for t in trees
                                     if t.startswith("orphan-"))

        # retention, then every history from the archive
        for wf, run in every.items():
            sid = box.history.controller.shard_for(wf)
            engine = box.history.controller.get_engine_for_shard(sid)
            M.retention.delete_workflow_retention(
                engine.shard, engine, types.SimpleNamespace(
                    domain_id=domain_id, workflow_id=wf, run_id=run))
        out["after_retention"] = {
            wf: [e.to_dict() for e in box.frontend
                 .get_workflow_execution_history(DOMAIN, wf, run)[0]]
            == [e.to_dict() for e in before[wf]]
            for wf, run in sorted(every.items())}
    finally:
        worker.stop()
        box.stop()
        bundle.close()
    return out


def test_worker_services_match_reference(tmp_path):
    got = {}
    for pkg, kw in (("cadence_tpu", {}),
                    ("cadence_tpu_torch", {"device": "cpu"})):
        (tmp_path / pkg).mkdir()
        got[pkg] = run_script(_mods(pkg), tmp_path / pkg, kw)
    want, port = got["cadence_tpu"], got["cadence_tpu_torch"]
    assert port.keys() == want.keys()
    for key in want:
        assert port[key] == want[key], key
    # and the script did what it says
    terminated = 4  # CloseStatus.Terminated
    assert want["pcp"] == [terminated] * N_PCP
    assert want["targets"] == [terminated] * N_BATCH
    assert want["batch"] == {"done": N_BATCH, "failed": 0, "errors": []}
    assert want["scavenger"][0]["deleted"] == 0
    assert want["scavenger"][1]["deleted"] == N_ORPHANS
    assert want["orphans_left"] == []
    assert all(want["after_retention"].values())
    n = N_ECHO + N_PCP + N_BATCH
    assert len(want["archive"]["h"]) == n
    assert len(want["archive"]["v"]) == n


# -- the repairs (ROADMAP §C) ---------------------------------------------


def _port_box():
    from cadence_tpu_torch.frontend.domain_handler import (
        DomainAlreadyExistsError)
    from cadence_tpu_torch.testing.onebox import Onebox

    box = Onebox(num_shards=2, start_worker=False, device="cpu").start()
    try:
        box.frontend.register_domain(DOMAIN)
    except DomainAlreadyExistsError:
        pass
    return box


def _start(box, wf, task_list=TASK_LIST, wtype="t"):
    from cadence_tpu_torch.runtime.api import StartWorkflowRequest

    return box.frontend.start_workflow_execution(StartWorkflowRequest(
        domain=DOMAIN, workflow_id=wf, workflow_type=wtype,
        task_list=task_list, execution_start_to_close_timeout_seconds=60,
        task_start_to_close_timeout_seconds=10))


def _decide(box, decisions, task_list=TASK_LIST):
    task = box.frontend.poll_for_decision_task(DOMAIN, task_list,
                                               timeout_s=5.0)
    assert task is not None
    box.frontend.respond_decision_task_completed(task.task_token,
                                                 decisions)
    return task


def test_history_scavenger_on_memory_store():
    """C.2: the port's memory store lists its history trees, so the
    history scavenger deletes an orphan tree on its second pass and keeps
    a reset run's tree (the reset run's branch lives in the tree of the
    run it reset, whose execution retention deleted). Without
    ``list_history_trees`` every pass returns ``skipped``."""
    from cadence_tpu_torch.core import history_factory as F
    from cadence_tpu_torch.core.enums import DecisionType, EventType
    from cadence_tpu_torch.runtime.api import Decision
    from cadence_tpu_torch.runtime.queues.retention import (
        delete_workflow_retention)
    from cadence_tpu_torch.worker.scanner import ScannerActivities

    box = _port_box()
    try:
        run1 = _start(box, "reset-wf")
        _decide(box, [Decision(DecisionType.CompleteWorkflowExecution,
                               {"result": b"done"})])
        events, _ = box.frontend.get_workflow_execution_history(
            DOMAIN, "reset-wf", run1)
        completed = next(e for e in events if e.event_type
                         == EventType.DecisionTaskCompleted)
        run2 = box.frontend.reset_workflow_execution(
            DOMAIN, "reset-wf", run1, reason="t",
            decision_finish_event_id=completed.event_id)
        domain_id = box.domains.get_by_name(DOMAIN).info.id
        sid = box.history.controller.shard_for("reset-wf")
        engine = box.history.controller.get_engine_for_shard(sid)
        delete_workflow_retention(engine.shard, engine, types.SimpleNamespace(
            domain_id=domain_id, workflow_id="reset-wf", run_id=run1))
        h = box.persistence.history
        br = h.new_history_branch(tree_id="orphan-run")
        h.append_history_nodes(br, [F.workflow_execution_started(
            1, 0, 0, task_list="x", workflow_type="t")], transaction_id=1)
        acts = ScannerActivities(box.persistence.task, h,
                                 box.persistence.execution, num_shards=2)
        first = json.loads(acts.scavenge_history())
        second = json.loads(acts.scavenge_history())
        assert first == {"scanned": 2, "deleted": 0}
        assert second == {"scanned": 2, "deleted": 1}
        assert [t for t, _ in h.list_history_trees()] == [run1]
        events2, _ = box.frontend.get_workflow_execution_history(
            DOMAIN, "reset-wf", run2)
        assert events2[0].event_type == EventType.WorkflowExecutionStarted
    finally:
        box.stop()


def test_parent_close_policy_applies_inline():
    """C.3: a parent that closes with started children applies their
    parent-close policies in its close task (TERMINATE terminates, ABANDON
    leaves the child running) and the close task completes (its
    visibility record is written)."""
    from cadence_tpu_torch.core.enums import (
        CloseStatus, DecisionType, EventType, ParentClosePolicy)
    from cadence_tpu_torch.runtime.api import Decision

    box = _port_box()
    try:
        run = _start(box, "parent", task_list="parent-tl")
        _decide(box, [Decision(DecisionType.StartChildWorkflowExecution, {
            "workflow_id": f"child-{policy.name}", "workflow_type": "t",
            "task_list": TASK_LIST, "input": b"",
            "execution_start_to_close_timeout_seconds": 60,
            "task_start_to_close_timeout_seconds": 10,
            "parent_close_policy": int(policy)})
            for policy in (ParentClosePolicy.Terminate,
                           ParentClosePolicy.Abandon)],
            task_list="parent-tl")
        while True:
            task = box.frontend.poll_for_decision_task(
                DOMAIN, "parent-tl", timeout_s=5.0)
            assert task is not None
            started = [e.event_type for e in task.history].count(
                EventType.ChildWorkflowExecutionStarted)
            box.frontend.respond_decision_task_completed(
                task.task_token, [Decision(
                    DecisionType.CompleteWorkflowExecution,
                    {"result": b"bye"})] if started == 2 else [])
            if started == 2:
                break
        assert box.history.drain_queues()
        desc = box.frontend.describe_workflow_execution
        assert desc(DOMAIN, "child-Terminate").close_status == \
            CloseStatus.Terminated
        assert desc(DOMAIN, "child-Abandon").is_running
        closed, _ = box.frontend.list_closed_workflow_executions(DOMAIN)
        assert sorted((r.workflow_id, r.close_status) for r in closed) == [
            ("child-Terminate", CloseStatus.Terminated),
            ("parent", CloseStatus.Completed)]
        assert [r.run_id for r in closed if r.workflow_id == "parent"] \
            == [run]
    finally:
        box.stop()


def test_signal_with_start_signals_a_run_started_meanwhile(monkeypatch):
    """C.4: a start that lands between ``SignalWithStart``'s probe of the
    current run and its own start makes that start collide with a
    running workflow; the signal then goes to the running workflow
    instead of raising ``WorkflowExecutionAlreadyStartedServiceError``."""
    from cadence_tpu_torch.core.enums import EventType
    from cadence_tpu_torch.runtime.api import (
        SignalWithStartRequest, StartWorkflowRequest)
    from cadence_tpu_torch.runtime.persistence.errors import (
        EntityNotExistsError)

    box = _port_box()
    try:
        run = _start(box, "sws-wf")
        engine = box.history.controller.get_engine("sws-wf")
        execution = engine.shard.persistence.execution
        probe = execution.get_current_execution
        stale = [True]

        def first_probe_misses(*a, **kw):
            # the probe ran before the concurrent start committed
            if stale:
                stale.pop()
                raise EntityNotExistsError("no current execution")
            return probe(*a, **kw)

        monkeypatch.setattr(execution, "get_current_execution",
                            first_probe_misses)
        got = box.frontend.signal_with_start_workflow_execution(
            SignalWithStartRequest(
                start=StartWorkflowRequest(
                    domain=DOMAIN, workflow_id="sws-wf", workflow_type="t",
                    task_list=TASK_LIST,
                    execution_start_to_close_timeout_seconds=60),
                signal_name="archival-request", signal_input=b"one"))
        assert got == run and not stale
        events, _ = box.frontend.get_workflow_execution_history(
            DOMAIN, "sws-wf", run)
        signals = [e for e in events
                   if e.event_type == EventType.WorkflowExecutionSignaled]
        assert [e.attributes["input"] for e in signals] == [b"one"]
    finally:
        box.stop()
