"""The port's frontend gateway against the reference package's.

One script drives two ``Onebox``es on a ``FakeTimeSource``: the reference
package's (``start_worker=False``, its ``ResidentEngine`` handed in) and
the port's twin (its ``ResidentEngine`` on ``device="cpu"``). Workflow
decisions and activities are answered synchronously on each side by
that package's SDK (``DecisionWorker`` / ``ActivityWorker``
``poll_and_process_one``), one task outstanding at a time, so the order
is fixed. The script covers the domain verbs (register, describe,
update, list, with archival URIs), starts (a duplicate request id, a
second start, a bad cron), signals and signal-with-start, a query the
SDK answers, describe, paged history, terminate, request-cancel and
reset, visibility (open, closed, advanced queries, count, the search
attributes, the archived list), health and cluster info, the rate
limiter's ``ServiceBusyError``, the version gate, DC redirection's
policy decisions and the admin describes.

Every result and error (type and message) is compared exactly after the
first-seen uuid renaming of ``tests/test_torch_service.py``: the stored
histories event by event, the responses and the visibility records.
Serving reads are compared against the reference engine's rows and the
port's host ``StateBuilder`` replay.
"""

import importlib
import threading
import types

import numpy as np
import pytest

from tests.test_torch_service import _host_replay, _Renamer

DOMAIN = "fe-domain"
DOMAIN_ID = "00000000-0000-4000-8000-0000000fe0fe"
GLOBAL = "fe-global"
GLOBAL_ID = "00000000-0000-4000-8000-0000000fe0ff"
TL = "fe-tl"
START_NS = 1_700_000_000 * 1_000_000_000
LANES = 8
MAX_EVENTS = 64
WAIT_S = 10.0


def _mods(pkg):
    m = lambda name: importlib.import_module(f"{pkg}.{name}")
    api, sdk = m("runtime.api"), m("worker.sdk")
    cluster, frontend = m("cluster"), m("frontend")
    return types.SimpleNamespace(
        pkg=pkg, api=api, sdk=sdk, cluster=cluster, frontend=frontend,
        Onebox=m("testing.onebox").Onebox,
        FakeTimeSource=m("utils.clock").FakeTimeSource,
        create_memory_bundle=m(
            "runtime.persistence.memory").create_memory_bundle,
        MultiStageRateLimiter=m("utils.quotas").MultiStageRateLimiter,
        dc=m("frontend.dc_redirection"),
    )


def _cluster_metadata(M):
    C = M.cluster
    return C.ClusterMetadata(
        failover_version_increment=10, master_cluster_name="active",
        current_cluster_name="active",
        cluster_info={"active": C.ClusterInformation(
                          initial_failover_version=1),
                      "standby": C.ClusterInformation(
                          initial_failover_version=2)})


def _jax_serving(persistence):
    from cadence_tpu.checkpoint import (
        CheckpointManager, MemoryCheckpointStore)
    from cadence_tpu.ops import schema as JS
    from cadence_tpu.serving import ResidentEngine
    from cadence_tpu.utils.metrics import Scope

    scope = Scope()
    return scope, ResidentEngine(
        lanes=LANES, caps=JS.Capacities(max_events=MAX_EVENTS),
        history=persistence.history, metrics=scope,
        checkpoints=CheckpointManager(MemoryCheckpointStore()))


def _port_serving(persistence):
    from cadence_tpu_torch.checkpoint import (
        CheckpointManager, MemoryCheckpointStore)
    from cadence_tpu_torch.ops import schema as S
    from cadence_tpu_torch.serving import ResidentEngine
    from cadence_tpu_torch.utils.metrics import Scope

    scope = Scope()
    return scope, ResidentEngine(
        lanes=LANES, caps=S.Capacities(max_events=MAX_EVENTS),
        history=persistence.history, metrics=scope,
        checkpoints=CheckpointManager(MemoryCheckpointStore()),
        device="cpu")


def _workflows(sdk):
    def greeter(ctx, input):
        act = yield ctx.schedule_activity("greet", input)
        sig = yield ctx.wait_signal("go")
        return act + b"|" + sig

    def sink(ctx, input):
        while True:
            yield ctx.wait_signal("ping")

    def cancellable(ctx, input):
        cause = yield ctx.wait_cancel()
        raise sdk.WorkflowCancelled(cause)

    return dict(greeter=greeter, sink=sink, cancellable=cancellable)


class _Remote:
    """A peer cluster's frontend: records what DC redirection forwards."""

    def __init__(self, log):
        self.log = log

    def __getattr__(self, api):
        return lambda *a, **k: self.log.append(("forwarded", api)) or api


class _Side:
    """One package's box, its SDK workers and the script's record."""

    def __init__(self, M, serving_factory, archive_dir, oracle=False):
        self.M = M
        self.oracle, self.want = oracle, []
        self.clock = M.FakeTimeSource(START_NS)
        persistence = M.create_memory_bundle()
        # the engine counts into a scope of its own (its default is the
        # process-wide one)
        self.engine_scope, engine = serving_factory(persistence)
        self.box = M.Onebox(
            num_shards=4, persistence=persistence,
            cluster_metadata=_cluster_metadata(M), time_source=self.clock,
            serving=engine, start_worker=False,
            **({} if M.pkg == "cadence_tpu" else {"device": "cpu"})).start()
        self.fe = self.box.frontend
        reg = M.sdk.WorkflowRegistry()
        for name, fn in _workflows(M.sdk).items():
            reg.register_workflow(name, fn)
            reg.register_query_handler(
                name, lambda qt, args: qt.encode() + b":" + args)
        self.decider = M.sdk.DecisionWorker(
            self.fe, DOMAIN, TL, reg, identity="fe-decider")
        # a fixed sticky list name (the SDK draws a random suffix)
        self.decider.sticky_task_list = "fe-decider:sticky"
        self.actor = M.sdk.ActivityWorker(self.fe, DOMAIN, TL,
                                          identity="fe-actor")
        self.actor.register_activity("greet", lambda b: b"hello " + b)
        self.archive = f"file://{archive_dir}"
        self.ops, self.runs, self.reads = [], {}, []

    def rec(self, name, fn):
        # a millisecond a call: start and close times order the
        # visibility lists, whose ties would fall to the queues' thread
        # order; the script's whole run stays short of any timer. The
        # queues drain first: a close task reads the shard clock when its
        # queue gets to it, which must be before the clock moves on
        assert self.box.history.drain_queues(20.0)
        self.clock.advance(1_000_000)
        try:
            out = fn()
        except Exception as e:
            self.ops.append((name, "error", type(e).__name__, str(e)))
            return None
        self.ops.append((name, "ok", out))
        return out

    def decide(self, n=1):
        for _ in range(n):
            assert self.decider.poll_and_process_one(timeout_s=WAIT_S)

    def act(self):
        assert self.actor.poll_and_process_one(timeout_s=WAIT_S)

    def start(self, wf, wf_type, req, **kw):
        run = self.rec(f"start {wf} {req}", lambda: (
            self.fe.start_workflow_execution(self.M.api.StartWorkflowRequest(
                domain=DOMAIN, workflow_id=wf, workflow_type=wf_type,
                task_list=TL, input=wf.encode(), request_id=req,
                execution_start_to_close_timeout_seconds=3600,
                task_start_to_close_timeout_seconds=600, **kw))))
        if run is not None:
            self.runs.setdefault(wf, []).append(run)
        return run

    def signal(self, wf, name, payload, req):
        self.rec(f"signal {wf} {req}", lambda: (
            self.fe.signal_workflow_execution(self.M.api.SignalRequest(
                domain=DOMAIN, workflow_id=wf, signal_name=name,
                input=payload, identity="fe-caller", request_id=req))))

    def query(self, wf):
        """A query the SDK answers: the call blocks until a decision
        worker's poll takes the query task."""
        out = {}
        t = threading.Thread(target=lambda: out.setdefault("r", self.rec(
            f"query {wf}", lambda: self.fe.query_workflow(
                DOMAIN, wf, query_type="count", query_args=b"args",
                timeout_s=WAIT_S))))
        t.start()
        self.decide()
        t.join(WAIT_S)
        assert not t.is_alive()

    def serving_read(self, wf):
        read = self.box.history.serving_read(DOMAIN_ID, wf)
        self.reads.append((wf, read))
        if self.oracle:
            # the port's host replay of the stored history at the read's
            # tip
            run = self.runs[wf][0]
            shard = self.box.history.controller.shard_for(wf)
            token = self.box.persistence.execution.get_workflow_execution(
                shard, DOMAIN_ID, wf, run).snapshot[
                    "execution_info"]["branch_token"]
            self.want.append(_host_replay(self.box.persistence.history,
                                          DOMAIN_ID, wf, run, token))

    def stop(self):
        self.box.stop()


def _domains(s):
    fe, A = s.fe, 2  # ArchivalStatus.ENABLED
    s.rec("register", lambda: fe.register_domain(
        DOMAIN, description="the frontend script", retention_days=3,
        domain_id=DOMAIN_ID, data={"team": "port"},
        history_archival_status=A,
        history_archival_uri=s.archive + "/history",
        visibility_archival_status=A,
        visibility_archival_uri=s.archive + "/visibility"))
    s.rec("register duplicate", lambda: fe.register_domain(DOMAIN))
    s.rec("register bad name", lambda: fe.register_domain("bad name!"))
    s.rec("register bad uri", lambda: fe.register_domain(
        "fe-bad-uri", history_archival_status=A,
        history_archival_uri="nope://x"))
    s.rec("register global", lambda: fe.register_domain(
        GLOBAL, is_global=True, clusters=["active", "standby"],
        active_cluster="standby", domain_id=GLOBAL_ID))
    s.rec("describe", lambda: fe.describe_domain(name=DOMAIN))
    s.rec("describe by id", lambda: fe.describe_domain(id=GLOBAL_ID))
    s.rec("describe missing", lambda: fe.describe_domain(name="nope"))
    s.rec("update", lambda: fe.update_domain(
        DOMAIN, description="updated", retention_days=5,
        add_bad_binary={"checksum": "bin-1", "reason": "bad build"}))
    s.rec("update uri", lambda: fe.update_domain(
        DOMAIN, history_archival_uri=s.archive + "/other"))
    s.rec("failover local", lambda: fe.update_domain(
        DOMAIN, active_cluster="standby"))
    s.rec("list", lambda: sorted(fe.list_domains(),
                                 key=lambda r: r.info.name))


def _workflow_verbs(s):
    M, fe = s.M, s.fe
    s.start("wf-g0", "greeter", "r-g0")
    s.decide()                  # schedules the activity
    s.act()
    s.decide()                  # waits for "go"
    s.start("wf-g0", "greeter", "r-g0")         # same request id
    s.start("wf-g0", "greeter", "r-g0-again")   # already started
    s.start("wf-cron", "greeter", "r-cron", cron_schedule="not a cron")
    s.rec("start long id", lambda: fe.start_workflow_execution(
        M.api.StartWorkflowRequest(
            domain=DOMAIN, workflow_id="x" * 1001, workflow_type="t",
            task_list=TL, execution_start_to_close_timeout_seconds=60)))
    s.signal("wf-g0", "go", b"world", "sig-g0")
    s.decide()                  # completes
    for i in range(2):
        s.start(f"wf-s{i}", "sink", f"r-s{i}")
        s.decide()
    run = s.rec("signal with start", lambda: (
        fe.signal_with_start_workflow_execution(
            M.api.SignalWithStartRequest(
                start=M.api.StartWorkflowRequest(
                    domain=DOMAIN, workflow_id="wf-sws",
                    workflow_type="sink", task_list=TL,
                    request_id="r-sws", input=b"sws",
                    execution_start_to_close_timeout_seconds=3600,
                    task_start_to_close_timeout_seconds=600),
                signal_name="ping", signal_input=b"first"))))
    s.runs["wf-sws"] = [run]
    s.decide()
    for r in range(2):
        s.signal("wf-s0", "ping", b"p%d" % r, f"sig-s0-{r}")
        s.decide()
        s.serving_read("wf-s0")
    s.signal("wf-s1", "ping", b"p", "sig-s1")
    s.decide()
    s.serving_read("wf-s1")
    s.query("wf-s0")
    s.rec("describe", lambda: fe.describe_workflow_execution(
        DOMAIN, "wf-s0"))
    s.rec("describe version gate", lambda: fe.describe_workflow_execution(
        DOMAIN, "wf-s0", client_impl="uber-go", feature_version="1.0.0"))
    s.rec("describe missing", lambda: fe.describe_workflow_execution(
        DOMAIN, "nope"))
    token, pages = 0, 0
    while True:
        out = s.rec(f"history page {pages}", lambda: (
            fe.get_workflow_execution_history(
                DOMAIN, "wf-g0", s.runs["wf-g0"][0], page_size=4,
                next_token=token)))
        pages += 1
        if not out or not out[1] or pages > 10:
            break
        token = out[1]
    s.rec("history of a missing run", lambda: (
        fe.get_workflow_execution_history(
            DOMAIN, "wf-g0", "00000000-0000-4000-8000-000000000bad")))
    s.start("wf-c", "cancellable", "r-c")
    s.decide()
    s.rec("request cancel", lambda: fe.request_cancel_workflow_execution(
        DOMAIN, "wf-c", request_id="cancel-1"))
    s.decide()                  # the SDK cancels the run
    s.rec("request cancel closed", lambda: (
        fe.request_cancel_workflow_execution(
            DOMAIN, "wf-c", request_id="cancel-2")))
    s.start("wf-t", "sink", "r-t")
    s.decide()
    s.rec("terminate", lambda: fe.terminate_workflow_execution(
        DOMAIN, "wf-t", reason="done with it", identity="fe-caller"))
    s.rec("terminate again", lambda: fe.terminate_workflow_execution(
        DOMAIN, "wf-t", reason="again"))
    new_run = s.rec("reset", lambda: fe.reset_workflow_execution(
        DOMAIN, "wf-g0", s.runs["wf-g0"][0], reason="redo",
        reset_type="FirstDecisionCompleted", request_id="reset-1"))
    s.runs["wf-g0"].append(new_run)
    s.rec("reset without a point", lambda: fe.reset_workflow_execution(
        DOMAIN, "wf-g0", s.runs["wf-g0"][0]))
    s.decide()                  # the reset run schedules the activity
    s.act()
    s.decide()                  # and completes on the re-applied signal


def _visibility(s):
    fe = s.fe
    assert s.box.history.drain_queues(20.0)
    s.rec("list open", lambda: fe.list_open_workflow_executions(DOMAIN))
    s.rec("list closed", lambda: fe.list_closed_workflow_executions(DOMAIN))
    s.rec("list closed by status", lambda: (
        fe.list_closed_workflow_executions(DOMAIN, close_status=1)))
    s.rec("list open by type", lambda: fe.list_open_workflow_executions(
        DOMAIN, workflow_type="sink"))
    for q in ("WorkflowType = 'sink'",
              "WorkflowType = 'greeter' AND CloseStatus = 'COMPLETED'",
              "StartTime > 0 ORDER BY StartTime DESC",
              "WorkflowID IN ('wf-s0', 'wf-t') ORDER BY WorkflowID",
              "CloseStatus = 'TERMINATED' OR CloseStatus = 'CANCELED'",
              "NoSuchKey = 1"):
        s.rec(f"list {q}", lambda: fe.list_workflow_executions(DOMAIN, q))
        s.rec(f"count {q}", lambda: fe.count_workflow_executions(DOMAIN, q))
    s.rec("scan", lambda: fe.scan_workflow_executions(
        DOMAIN, "WorkflowType = 'greeter'", page_size=2))
    s.rec("count", lambda: fe.count_workflow_executions(DOMAIN))
    s.rec("search attributes", fe.get_search_attributes)
    s.rec("archived list", lambda: fe.list_archived_workflow_executions(
        DOMAIN, "WorkflowType = 'sink'"))
    s.rec("archived list without archival", lambda: (
        fe.list_archived_workflow_executions(GLOBAL)))
    s.rec("health", fe.health)
    s.rec("cluster info", fe.get_cluster_info)
    s.rec("task list", lambda: fe.describe_task_list(DOMAIN, TL))


def _limits_and_redirection(s):
    M, box = s.M, s.box
    limited = M.frontend.WorkflowHandler(
        box.domain_handler, box.domains, box.history_client,
        box.matching_client, visibility=box.visibility,
        rate_limiter=M.MultiStageRateLimiter(
            global_rps=1.0, domain_rps=lambda d: 1.0))
    for i in range(3):
        s.rec(f"rate limited {i}", lambda: (
            limited.count_workflow_executions(DOMAIN)))
    policy = M.dc.SelectedAPIsForwardingPolicy()
    recs = {d: box.domain_handler.describe_domain(name=d)
            for d in (DOMAIN, GLOBAL)}
    for api in sorted(M.dc.FORWARDED_APIS) + ["describe_workflow_execution",
                                              "list_open_workflow_executions"]:
        for d, rec in recs.items():
            s.rec(f"policy {api} {d}", lambda: policy.pick_cluster(
                rec, api, "active"))
    dc = M.frontend.DCRedirectionHandler(box.frontend, "active")
    start = M.api.StartWorkflowRequest(
        domain=GLOBAL, workflow_id="wf-g", workflow_type="sink",
        task_list=TL, request_id="r-g",
        execution_start_to_close_timeout_seconds=60)
    s.rec("dc start on a passive domain", lambda: dc.call(
        "start_workflow_execution", GLOBAL, start))
    s.rec("dc describe on the local domain", lambda: dc.call(
        "describe_workflow_execution", DOMAIN, DOMAIN, "wf-s1"))
    forwarded = []
    dc.add_remote("standby", _Remote(forwarded))
    s.rec("dc start forwarded", lambda: dc.call(
        "start_workflow_execution", GLOBAL, start))
    s.rec("dc describe not forwarded", lambda: dc.call(
        "describe_workflow_execution", GLOBAL, DOMAIN, "wf-s1"))
    s.rec("dc proxied health", dc.health)
    s.ops.append(("forwarded", "ok", forwarded))


def _admin(s):
    admin = s.box.admin
    s.rec("host", admin.describe_history_host)
    s.rec("admin describe", lambda: admin.describe_workflow_execution(
        DOMAIN, "wf-s0"))
    s.rec("admin describe alias", lambda: (
        admin.admin_describe_workflow_execution(DOMAIN, "wf-s1")))
    s.rec("admin describe missing", lambda: (
        admin.describe_workflow_execution(
            DOMAIN, "wf-s0", "00000000-0000-4000-8000-000000000bad")))
    s.rec("refresh tasks", lambda: admin.refresh_workflow_tasks(
        DOMAIN, "wf-s1"))
    s.rec("remove task of a bad type", lambda: admin.remove_task(
        0, "bogus", 1))
    s.rec("dlq", lambda: admin.read_dlq_messages("domain-replication"))
    s.rec("autopilot", admin.autopilot_status)
    assert s.box.history.drain_queues(20.0)


def _histories(s):
    """Every run's stored history, event by event, workflows by id."""
    out = {}
    for wf in sorted(s.runs):
        for k, run in enumerate(s.runs[wf]):
            events, _ = s.fe.get_workflow_execution_history(DOMAIN, wf, run)
            out[f"{wf}#{k}"] = [e.to_dict() for e in events]
    return out


def _run(pkg, serving_factory, archive_dir, oracle=False):
    M = _mods(pkg)
    s = _Side(M, serving_factory, archive_dir, oracle=oracle)
    try:
        _domains(s)
        _workflow_verbs(s)
        _visibility(s)
        _limits_and_redirection(s)
        _admin(s)
        histories = _histories(s)
        # hits count in the box's scope, misses in the engine's own
        counters = {
            "serving_cold_misses": s.engine_scope.registry.counter_value(
                "serving_cold_misses"),
            "serving_resident_hits": s.box.metrics.registry
            .counter_value("serving_resident_hits")}
    finally:
        s.stop()
    return {"ops": s.ops, "histories": histories, "reads": s.reads,
            "oracle": s.want, "counters": counters}


def _canonical(ops):
    """Two results hold a wall-clock or a uuid tie: a poller's seconds
    since its last poll (dropped), and visibility records of equal start
    time (a reset run keeps its base run's), which the store orders by
    run id (put in close-time order)."""
    out = []
    for op in ops:
        if op[0] == "task list":
            op = op[:2] + ({**op[2], "pollers": [
                {k: v for k, v in p.items() if k != "last_access_time_s_ago"}
                for p in op[2]["pollers"]]},)
        elif (op[1] == "ok" and isinstance(op[2], tuple) and op[2]
              and isinstance(op[2][0], list) and op[2][0]
              and hasattr(op[2][0][0], "start_time")):
            recs = op[2][0]
            first = {}
            for i, r in enumerate(recs):
                first.setdefault(r.start_time, i)
            recs = sorted(recs, key=lambda r: (first[r.start_time],
                                               r.close_time))
            op = op[:2] + ((recs,) + op[2][1:],)
        out.append(op)
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    archive = tmp_path_factory.mktemp("archive")
    j = _run("cadence_tpu", _jax_serving, archive)
    p = _run("cadence_tpu_torch", _port_serving, archive, oracle=True)
    ren_j, ren_p = _Renamer(), _Renamer()
    # histories first, so a run id is named where its run starts
    hj, hp = ren_j(j["histories"]), ren_p(p["histories"])
    return j, p, {"histories": hj, "ops": ren_j(_canonical(j["ops"]))}, {
        "histories": hp, "ops": ren_p(_canonical(p["ops"]))}


def test_histories_match_event_by_event(both):
    _, _, j, p = both
    assert j["histories"].keys() == p["histories"].keys()
    for run in j["histories"]:
        hj, hp = j["histories"][run], p["histories"][run]
        assert len(hj) == len(hp), run
        for ej, ep in zip(hj, hp):
            assert ej == ep, (run, ej["event_id"])
    types = {e["event_type"] for h in p["histories"].values() for e in h}
    from cadence_tpu_torch.core.enums import EventType as E
    for t in (E.ActivityTaskCompleted, E.WorkflowExecutionSignaled,
              E.WorkflowExecutionCompleted, E.WorkflowExecutionCanceled,
              E.WorkflowExecutionTerminated, E.DecisionTaskFailed,
              E.WorkflowExecutionCancelRequested):
        assert int(t) in types, t.name


def test_every_response_and_error_matches(both):
    _, _, j, p = both
    assert [o[0] for o in j["ops"]] == [o[0] for o in p["ops"]]
    for oj, op in zip(j["ops"], p["ops"]):
        assert oj == op, oj[0]
    errors = {o[0]: o[2] for o in p["ops"] if o[1] == "error"}
    assert errors["register duplicate"] == "DomainAlreadyExistsError"
    assert errors["start wf-cron r-cron"] == "BadRequestError"
    assert errors["describe version gate"] == (
        "ClientVersionNotSupportedError")
    assert errors["dc start on a passive domain"] == "DomainNotActiveError"
    limited = [o[1] for o in p["ops"] if o[0].startswith("rate limited")]
    assert limited[0] == "ok" and "error" in limited[1:]
    assert errors["rate limited 2"] == "ServiceBusyError"
    ok = {o[0]: o[2] for o in p["ops"] if o[1] == "ok"}
    assert ok["query wf-s0"] == ("bytes", "count:args")
    assert ok["count"] == 7      # every run started, open or closed
    assert ok["forwarded"] == [["forwarded", "start_workflow_execution"]]


def test_serving_reads_match_reference_engine(both):
    jo, po, _, _ = both
    from cadence_tpu_torch.ops import schema as S

    assert [wf for wf, _ in jo["reads"]] == [wf for wf, _ in po["reads"]]
    assert len(po["reads"]) == 3
    for (wf, jr), (_, pr) in zip(jo["reads"], po["reads"]):
        assert jr.resident == pr.resident, wf
        assert jr.epoch_s == pr.epoch_s, wf
        for f in S.STATE_ROW_FIELDS:
            np.testing.assert_array_equal(
                np.asarray(jr.state_row[f]), np.asarray(pr.state_row[f]),
                err_msg=f"{wf} field {f}")
        assert _Renamer()(jr.snapshot) == _Renamer()(pr.snapshot), wf
    # each workflow's first read seats it; wf-s0's second read answers
    # from its lane with the Δ composed
    assert jo["counters"] == po["counters"] == {
        "serving_cold_misses": 2, "serving_resident_hits": 1}


def test_serving_reads_match_host_replay(both):
    _, po, _, _ = both
    assert len(po["oracle"]) == len(po["reads"])
    for (wf, read), want in zip(po["reads"], po["oracle"]):
        assert read.snapshot == want, wf


def test_port_admin_refuses_unported_planes():
    """The Onebox twin takes the planes it once refused (fault
    injection, the sanitizer) and starts and stops its worker service by
    default, as the reference's does; the reshard
    verbs, the admin queue view and the autopilot verbs answer as the
    reference's do on the same calls, timings left out."""
    from cadence_tpu.testing.onebox import Onebox as JaxOnebox
    from cadence_tpu_torch.runtime.api import BadRequestError
    from cadence_tpu_torch.testing.onebox import Onebox

    def script(box):
        admin, out = box.admin, []
        for name, call in (
                ("status", admin.reshard_status),
                ("split", lambda: admin.reshard_split(0)),
                ("queues 2", lambda: admin.describe_queue_states(2)),
                ("merge", lambda: admin.reshard_merge(2, 0)),
                ("status after", admin.reshard_status),
                ("queues 0", lambda: admin.describe_queue_states(0)),
                ("queues gone", lambda: admin.describe_queue_states(2)),
                ("autopilot", admin.autopilot_status)):
            try:
                got = call()
            except Exception as e:  # the error's type and text compare
                got = (type(e).__name__, str(e))
            if isinstance(got, dict):
                got = {k: v for k, v in got.items()
                       if k not in ("handoff_ms", "pause_ms")}
                if isinstance(got.get("last_plan"), dict):
                    got["last_plan"] = {
                        k: v for k, v in got["last_plan"].items()
                        if k not in ("handoff_ms", "pause_ms")}
            out.append((name, got))
        return out

    got = {}
    for key, box in (("jax", JaxOnebox(num_shards=2, start_worker=False)),
                     ("port", Onebox(num_shards=2, start_worker=False,
                                     device="cpu"))):
        box.start()
        try:
            got[key] = script(box)
        finally:
            box.stop()
    assert got["port"] == got["jax"]
    assert got["port"][1][1]["state"] == "COMMITTED"
    assert got["port"][-1][1][0] == "BadRequestError"

    box = Onebox(num_shards=1, autopilot=True, queue_parallel=2,
                 device="cpu").start()
    try:
        assert box.history.queue_executor is box.queue_executor
        assert box.admin.autopilot_pause("drill")["paused"] is True
        assert box.admin.autopilot_resume()["paused"] is False
        assert box.admin.autopilot_status()["epochs_run"] >= 0
    finally:
        box.stop()
    with pytest.raises(BadRequestError):
        Onebox(num_shards=1, device="cpu").admin.autopilot_status()
    # fault injection and the sanitizer are ported: a box wraps its
    # store in the fault client (innermost) and the sanitizer's probe
    # (outermost), and threads the schedule into its history service
    from cadence_tpu_torch.testing.faults import (
        FaultInjectionClient, FaultSchedule)
    from cadence_tpu_torch.testing.race_witness import SanitizerProbeClient

    sched = FaultSchedule(seed=3)
    box = Onebox(num_shards=1, start_worker=False, faults=sched,
                 sanitize=True, device="cpu")
    assert box.history.faults is sched
    assert isinstance(box.persistence.execution, SanitizerProbeClient)
    assert isinstance(box.persistence.execution._base._base,
                      FaultInjectionClient)
    # the worker service is ported: the default box starts and stops it
    box = Onebox(device="cpu").start()
    try:
        assert box.worker is not None and len(box.worker.workers) == 4
        assert box.frontend.describe_domain(name="cadence-system")
    finally:
        box.stop()
    assert not any(p._thread.is_alive() for w in box.worker.workers
                   for p in (w.decisions, w.activities))


def _demo(module, *flags):
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    r = subprocess.run(
        [sys.executable, "-m", module, "--quiet", "--requests", "12",
         "--qps", "120", *flags],
        capture_output=True, text=True, cwd=repo, timeout=240,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [ln for ln in r.stdout.strip().splitlines() if ln.strip()]
    assert len(lines) == 1, r.stdout
    return json.loads(lines[0])


def test_serve_demo_twin_smoke():
    """The serving demo's twin boots the port's Onebox with serving on
    the CPU, drives its open-loop burst and drains clean; its summary has
    the reference demo's keys."""
    port = _demo("cadence_tpu_torch.testing.serve_demo", "--device", "cpu")
    ref = _demo("cadence_tpu.testing.serve_demo")
    assert port.keys() == ref.keys()
    assert port["resident_hits"] >= port["requests"] - port["workflows"]
    assert port["cold_misses"] <= port["workflows"]
    assert port["drain_flush_failures"] == 0
    assert port["drain_evictions"] >= port["workflows"]
