"""The port's worker SDK against the reference package's.

``replay_decide`` of both packages runs over the same histories: one
seeded simulator per package grows a history with that package's
``core.history_factory``, asking its SDK for each decision and turning
the decisions into events (the initiated events, then a seeded subset of
outcomes: activity completions and failures, timer fires, child starts
and closes, external signal and cancel results, signals and a cancel
request on the run). The decision lists must be equal at every step,
field by field, and so must the final histories. The workflows cover
every command of the SDK: activity, timer, signal wait and poll, child,
continue-as-new, signal-external, cancel-external, upsert search
attributes, local activity, side effect, ``get_version`` and the cancel
wait. Changed workflow code replayed over a recorded history must be
found non-deterministic alike on both sides.

Then the end-to-end cases of ``tests/test_worker_sdk.py`` run again,
unchanged but for the package, on the port's ``Onebox`` twin: one
parametrised case per reference test.
"""

import importlib
import inspect
import random
import re
import traceback
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
TL = "sdk-tl"
PEER_DOMAIN = "peer-domain"
T0 = 1_700_000_000 * 1_000_000_000
MAX_DECISIONS = 24


def _sdk(pkg):
    return importlib.import_module(f"{pkg}.worker.sdk")


def _workflows(sdk):
    """Workflow code, the same text for both packages (only the SDK's
    exception types differ)."""

    def mixed(ctx, input):
        v = yield ctx.get_version("change-a", -1, 2)
        se = yield ctx.side_effect(lambda: b"se-" + input)
        la = yield ctx.local_activity("la", input)
        yield ctx.upsert_search_attributes({"CustomKeywordField": b"k"})
        try:
            act = yield ctx.schedule_activity("act", input)
        except sdk.ActivityError as e:
            act = b"err:" + e.reason.encode()
        yield ctx.start_timer(3)
        sig = yield ctx.wait_signal("go")
        extra = yield ctx.poll_signal("go")
        yield ctx.signal_external(PEER_DOMAIN, "peer", "ping", sig)
        yield ctx.request_cancel_external(PEER_DOMAIN, "peer-2")
        try:
            kid = yield ctx.start_child_workflow(
                "kid", "kid-" + input.decode(), input=act)
        except sdk.ActivityError as e:
            kid = b"kid-err:" + e.reason.encode()
        if input.endswith(b"1"):
            yield ctx.continue_as_new(b"again")
        return b"|".join([str(v).encode(), se, la, act, sig,
                          extra or b"-", kid])

    def fanout(ctx, input):
        # parallel-looking commands: several activities and timers
        # scheduled one after another, children started twice
        outs = []
        for i in range(3):
            try:
                outs.append((yield ctx.schedule_activity(
                    "act", input + b"%d" % i)))
            except sdk.ActivityError as e:
                outs.append(e.reason.encode())
            yield ctx.start_timer(i + 1)
        for i in range(2):
            try:
                outs.append((yield ctx.start_child_workflow(
                    "kid", "fan-kid-%d" % i)))
            except sdk.ActivityError:
                outs.append(b"x")
        for i in range(2):
            yield ctx.signal_external(PEER_DOMAIN, "peer-%d" % i, "ping")
            yield ctx.request_cancel_external(PEER_DOMAIN, "peer-%d" % i)
            la = yield ctx.local_activity("la", b"%d" % i)
            outs.append(la)
        return b",".join(outs)

    def cancellable(ctx, input):
        yield ctx.start_timer(1)
        cause = yield ctx.wait_cancel()
        raise sdk.WorkflowCancelled(cause)

    def looper(ctx, input):
        n = 0
        while n < 3:
            yield ctx.wait_signal("go")
            n += 1
            polled = yield ctx.poll_signal("go")
            while polled is not None:
                n += 1
                polled = yield ctx.poll_signal("go")
        yield ctx.continue_as_new(b"%d" % n)

    def plain(ctx, input):
        return b"plain:" + input

    def bad_result(ctx, input):
        yield ctx.start_timer(1)
        return "not-bytes"

    def raises(ctx, input):
        yield ctx.start_timer(1)
        raise ValueError("workflow bug")

    return dict(mixed=mixed, fanout=fanout, cancellable=cancellable,
                looper=looper, plain=plain, bad_result=bad_result,
                raises=raises)


def _changed(sdk):
    """Workflow code changed against ``mixed`` / ``fanout`` in ways the
    replay must refuse."""

    def child_renamed(ctx, input):
        yield ctx.start_child_workflow("kid", "other-kid")

    def signal_retargeted(ctx, input):
        yield ctx.signal_external(PEER_DOMAIN, "someone-else", "ping")

    def cancel_retargeted(ctx, input):
        yield ctx.signal_external(PEER_DOMAIN, "peer-0", "ping")
        yield ctx.request_cancel_external(PEER_DOMAIN, "nobody")

    def local_renamed(ctx, input):
        yield ctx.get_version("change-a", -1, 2)
        yield ctx.side_effect(lambda: b"")
        yield ctx.local_activity("other-la", input)

    def version_dropped(ctx, input):
        yield ctx.get_version("change-a", 3, 4)

    def new_side_effect(ctx, input):
        yield ctx.side_effect(lambda: b"first")
        yield ctx.side_effect(lambda: b"new")
        yield ctx.get_version("change-a", -1, 2)

    return {"mixed": dict(local_renamed=local_renamed,
                          version_dropped=version_dropped,
                          new_side_effect=new_side_effect),
            "fanout": dict(child_renamed=child_renamed,
                           signal_retargeted=signal_retargeted,
                           cancel_retargeted=cancel_retargeted)}


def _registry(sdk, workflows):
    reg = sdk.WorkflowRegistry()
    for name, fn in workflows.items():
        reg.register_workflow(name, fn)
    reg.register_local_activity("la", lambda b: b"la<" + b + b">")
    return reg


def _decision(d):
    attrs = dict(d.attributes)
    if "details" in attrs and d.decision_type.name == (
            "FailWorkflowExecution"):
        # a traceback names the package's files and lines: keep the
        # exception it ends with
        attrs["details"] = attrs["details"].decode().strip().splitlines()[-1]
    return d.decision_type.name, attrs


class _Sim:
    """Grows one history with ``pkg``'s factory and SDK."""

    def __init__(self, pkg, wf_type, input, seed):
        self.F = importlib.import_module(f"{pkg}.core.history_factory")
        self.DT = importlib.import_module(f"{pkg}.core.enums").DecisionType
        self.sdk = _sdk(pkg)
        self.reg = _registry(self.sdk, _workflows(self.sdk))
        self.rng = random.Random(seed)
        self.history, self.ts = [], T0
        self.pending = []
        self.add(self.F.workflow_execution_started, workflow_type=wf_type,
                 task_list=TL, input=input)

    def add(self, fn, **kw):
        self.ts += self.rng.randint(1, 5) * 1_000_000_000
        ev = fn(len(self.history) + 1, 1, self.ts, **kw)
        self.history.append(ev)
        return ev.event_id

    def run(self, wf_type):
        steps = []
        for _ in range(MAX_DECISIONS):
            sched = self.add(self.F.decision_task_scheduled, task_list=TL)
            started = self.add(self.F.decision_task_started,
                               scheduled_event_id=sched)
            decisions = self.sdk.replay_decide(self.reg, list(self.history))
            steps.append([_decision(d) for d in decisions])
            done = self.add(self.F.decision_task_completed,
                            scheduled_event_id=sched,
                            started_event_id=started)
            if self.apply(decisions, done):
                break
            self.world(wf_type)
        return steps

    def apply(self, decisions, done):
        F, DT, add = self.F, self.DT, self.add
        closed = False
        for d in decisions:
            a, t = d.attributes, d.decision_type
            if t == DT.ScheduleActivityTask:
                sid = add(F.activity_task_scheduled,
                          activity_id=a["activity_id"],
                          activity_type=a["activity_type"],
                          task_list=a["task_list"], input=a["input"],
                          decision_task_completed_event_id=done)
                self.pending.append(("activity", sid, a))
            elif t == DT.StartTimer:
                sid = add(F.timer_started, timer_id=a["timer_id"],
                          start_to_fire_timeout_seconds=a[
                              "start_to_fire_timeout_seconds"],
                          decision_task_completed_event_id=done)
                self.pending.append(("timer", sid, a))
            elif t == DT.RecordMarker:
                add(F.marker_recorded, marker_name=a["marker_name"],
                    details=a["details"],
                    decision_task_completed_event_id=done)
            elif t == DT.UpsertWorkflowSearchAttributes:
                add(F.upsert_workflow_search_attributes,
                    search_attributes=a["search_attributes"],
                    decision_task_completed_event_id=done)
            elif t == DT.SignalExternalWorkflowExecution:
                iid = add(F.signal_external_initiated, domain=a["domain"],
                          workflow_id=a["workflow_id"], run_id=a["run_id"],
                          signal_name=a["signal_name"], input=a["input"],
                          decision_task_completed_event_id=done)
                self.pending.append(("signal_ext", iid, a))
            elif t == DT.RequestCancelExternalWorkflowExecution:
                iid = add(F.request_cancel_external_initiated,
                          domain=a["domain"], workflow_id=a["workflow_id"],
                          run_id=a["run_id"],
                          decision_task_completed_event_id=done)
                self.pending.append(("cancel_ext", iid, a))
            elif t == DT.StartChildWorkflowExecution:
                iid = add(F.start_child_initiated, domain="sdk-domain",
                          workflow_id=a["workflow_id"],
                          workflow_type=a["workflow_type"],
                          task_list=a["task_list"], input=a["input"],
                          decision_task_completed_event_id=done)
                self.pending.append(("child", iid, a))
            elif t == DT.CompleteWorkflowExecution:
                add(F.workflow_execution_completed, result=a["result"],
                    decision_task_completed_event_id=done)
                closed = True
            elif t == DT.FailWorkflowExecution:
                add(F.workflow_execution_failed, reason=a["reason"],
                    details=_decision(d)[1]["details"].encode(),
                    decision_task_completed_event_id=done)
                closed = True
            elif t == DT.CancelWorkflowExecution:
                add(F.workflow_execution_canceled, details=a["details"],
                    decision_task_completed_event_id=done)
                closed = True
            elif t == DT.ContinueAsNewWorkflowExecution:
                add(F.workflow_execution_continued_as_new,
                    new_execution_run_id="next-run",
                    workflow_type=a["workflow_type"],
                    task_list=a["task_list"], input=a["input"],
                    execution_start_to_close_timeout_seconds=a[
                        "execution_start_to_close_timeout_seconds"],
                    task_start_to_close_timeout_seconds=a[
                        "task_start_to_close_timeout_seconds"],
                    decision_task_completed_event_id=done)
                closed = True
            else:
                raise AssertionError(f"unexpected decision {t!r}")
        return closed

    def world(self, wf_type):
        """Resolve a seeded subset of the pending commands; deliver
        signals and, to the cancellable workflow, a cancel request."""
        F, add, rng = self.F, self.add, self.rng
        rng.shuffle(self.pending)
        n = rng.randint(1, len(self.pending)) if self.pending else 0
        for kind, iid, a in self.pending[:n]:
            if kind == "activity":
                st = add(F.activity_task_started, scheduled_event_id=iid)
                if rng.random() < 0.3:
                    add(F.activity_task_failed, scheduled_event_id=iid,
                        started_event_id=st, reason="boom",
                        details=b"d")
                else:
                    add(F.activity_task_completed, scheduled_event_id=iid,
                        started_event_id=st,
                        result=b"r%d" % rng.randint(0, 99))
            elif kind == "timer":
                add(F.timer_fired, timer_id=a["timer_id"],
                    started_event_id=iid)
            elif kind == "signal_ext":
                add(F.external_workflow_execution_signaled,
                    initiated_event_id=iid, domain=a["domain"],
                    workflow_id=a["workflow_id"])
            elif kind == "cancel_ext":
                add(F.external_workflow_execution_cancel_requested,
                    initiated_event_id=iid, domain=a["domain"],
                    workflow_id=a["workflow_id"])
            else:
                if rng.random() < 0.2:
                    add(F.start_child_failed, initiated_event_id=iid,
                        domain="sdk-domain", workflow_id=a["workflow_id"],
                        workflow_type=a["workflow_type"])
                    continue
                st = add(F.child_execution_started, initiated_event_id=iid,
                         domain="sdk-domain", workflow_id=a["workflow_id"],
                         run_id="kid-run", workflow_type=a["workflow_type"])
                if rng.random() < 0.3:
                    add(F.child_execution_failed, initiated_event_id=iid,
                        started_event_id=st, reason="kid-boom")
                else:
                    add(F.child_execution_completed, initiated_event_id=iid,
                        started_event_id=st, result=b"kid-ok")
        del self.pending[:n]
        for _ in range(rng.choice((0, 0, 1, 2))):
            add(F.workflow_execution_signaled, signal_name="go",
                input=b"s%d" % rng.randint(0, 99), identity="sim")
        if wf_type == "cancellable" and rng.random() < 0.5:
            add(F.workflow_execution_cancel_requested, cause="stop",
                identity="sim")


def _history_dicts(history):
    return [e.to_dict() for e in history]


SIM_CASES = [(wf, inp, seed)
             for wf, inp in (("mixed", b"10"), ("mixed", b"11"),
                             ("fanout", b"f"), ("cancellable", b""),
                             ("looper", b""), ("plain", b"p"),
                             ("bad_result", b""), ("raises", b""))
             for seed in (0, 1, 2)]


@pytest.fixture(scope="module")
def simulated():
    out = {}
    for wf, inp, seed in SIM_CASES:
        sides = []
        for pkg in ("cadence_tpu", "cadence_tpu_torch"):
            sim = _Sim(pkg, wf, inp, seed)
            steps = sim.run(wf)
            sides.append((steps, sim.history))
        out[(wf, inp, seed)] = sides
    return out


@pytest.mark.parametrize("case", SIM_CASES,
                         ids=[f"{w}-{i.decode() or 'empty'}-{s}"
                              for w, i, s in SIM_CASES])
def test_replay_decide_matches_reference(simulated, case):
    (j_steps, j_hist), (p_steps, p_hist) = simulated[case]
    assert len(j_steps) == len(p_steps)
    for k, (js, ps) in enumerate(zip(j_steps, p_steps)):
        assert js == ps, (case, k)
    assert _history_dicts(j_hist) == _history_dicts(p_hist)
    # every run closes within the simulator's decisions
    assert p_hist[-1].event_type.name.startswith("WorkflowExecution")
    assert p_hist[-1].event_type.name != "WorkflowExecutionSignaled"


def test_simulated_histories_cover_every_command(simulated):
    kinds, markers = set(), set()
    for _, (_, p_hist) in simulated.values():
        for e in p_hist:
            kinds.add(e.event_type.name)
            if e.event_type.name == "MarkerRecorded":
                markers.add(e.attributes["marker_name"].split(":")[0])
    for want in ("ActivityTaskCompleted", "ActivityTaskFailed",
                 "TimerFired", "WorkflowExecutionSignaled",
                 "StartChildWorkflowExecutionInitiated",
                 "ChildWorkflowExecutionCompleted",
                 "ChildWorkflowExecutionFailed",
                 "StartChildWorkflowExecutionFailed",
                 "SignalExternalWorkflowExecutionInitiated",
                 "RequestCancelExternalWorkflowExecutionInitiated",
                 "UpsertWorkflowSearchAttributes",
                 "WorkflowExecutionCancelRequested",
                 "WorkflowExecutionContinuedAsNew",
                 "WorkflowExecutionCompleted", "WorkflowExecutionFailed",
                 "WorkflowExecutionCanceled"):
        assert want in kinds, want
    assert markers == {"version", "side_effect", "local_activity"}


def _nondeterminism(pkg, base, changed, history):
    """What ``pkg``'s replay of ``history`` (recorded by ``base``) says
    of the ``changed`` code registered under the recorded type."""
    sdk = _sdk(pkg)
    reg = _registry(sdk, {base: _changed(sdk)[base][changed]})
    try:
        sdk.replay_decide(reg, history)
    except sdk._NonDeterminismError as e:
        return type(e).__name__, str(e)
    except Exception:
        return "other", traceback.format_exc().splitlines()[-1]
    return None


NONDET_CASES = [(base, name) for base, names in
                (("mixed", ("local_renamed", "version_dropped",
                            "new_side_effect")),
                 ("fanout", ("child_renamed", "signal_retargeted",
                             "cancel_retargeted")))
                for name in names]


@pytest.mark.parametrize("base,changed", NONDET_CASES)
def test_non_determinism_detected_alike(simulated, base, changed):
    inp = b"10" if base == "mixed" else b"f"
    # the recorded run's full history: every command of the base
    # workflow initiated
    (_, j_hist), (_, p_hist) = simulated[(base, inp, 0)]
    j = _nondeterminism("cadence_tpu", base, changed, j_hist)
    p = _nondeterminism("cadence_tpu_torch", base, changed, p_hist)
    assert j == p
    assert p is not None and p[0] == "_NonDeterminismError", p


# -- the reference's end-to-end SDK cases on the port's Onebox ----------


def _reference_sdk_cases():
    """tests/test_worker_sdk.py with every ``cadence_tpu.`` import taken
    from the port and ``FrontendBox`` replaced by the port's Onebox."""
    src = (REPO / "tests" / "test_worker_sdk.py").read_text()
    src = src.replace("from tests.test_frontend import FrontendBox\n", "")
    src = re.sub(r"\bcadence_tpu\.", "cadence_tpu_torch.", src)
    ns = {"__name__": "tests.port_worker_sdk_cases",
          "FrontendBox": _port_box}
    exec(compile(src, str(REPO / "tests" / "test_worker_sdk.py"), "exec"),
         ns)
    return ns


def _port_box():
    from cadence_tpu_torch.testing.onebox import Onebox

    # the reference's FrontendBox runs no worker service
    return Onebox(num_shards=2, start_worker=False, device="cpu").start()


_CASES = _reference_sdk_cases()
REFERENCE_CASES = sorted(n for n in _CASES if n.startswith("test_"))


def test_reference_cases_found():
    assert len(REFERENCE_CASES) == 15


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_reference_sdk_case_on_port_onebox(name):
    fn = _CASES[name]
    if "box" not in inspect.signature(fn).parameters:
        fn()
        return
    box = _port_box()
    try:
        box.domain_handler.register_domain(_CASES["DOMAIN"])
        fn(box)
    finally:
        box.stop()
