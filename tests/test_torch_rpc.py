"""The port's gRPC plane against the reference package's, both ways.

One conversation (register a domain, start a workflow, the SDK's first
decision, a signal, the SDK's completing decision, describe, history,
then the two structured wire errors) runs through a client of each
package against a server of each: a ``FrontendRPCServer`` over a Onebox
on a frozen ``FakeTimeSource`` (the port's on ``device="cpu"``). A
client's conversation with the other package's server equals, field by
field after uuids are renamed, its conversation with its own package's
server, and the errors it raises are its own package's classes with the
server's attributes. The wire names are shared, so neither side knows
which package it talks to.

Then the port's serving plane over the wire: a config-booted host
(``start_services(..., device="cpu")`` with the serving section on)
answers ``RemoteHistory.serving_read`` for every workflow, a cold miss
first (it seats the workflow) and a resident hit second, each read equal
to the port's host ``StateBuilder`` replay of the history fetched over
the wire at the read's tip; the ``server`` command of the port's CLI boots on the CPU in
a child process and answers a ping; the pprof device trace brackets a
torch op on the CPU profiler; the entry points default to the card; and a
host booted from a YAML config with its chaos section on carries the
fault schedule, which the operator disarms and arms again.
"""

from __future__ import annotations

import http.client
import inspect
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import pytest
import torch

from tests.test_torch_service import _Renamer

REPO = Path(__file__).resolve().parents[1]
T0_NS = 1_750_000_000 * 1_000_000_000
DOMAIN, TASK_LIST, WF = "rpc-x", "rpc-tl", "rpc-wf"


def _mods(pkg: str) -> types.SimpleNamespace:
    """The same module paths from either package."""
    import importlib

    def m(path):
        return importlib.import_module(f"{pkg}.{path}")

    api = m("runtime.api")
    return types.SimpleNamespace(
        pkg=pkg, api=api, Onebox=m("testing.onebox").Onebox,
        FakeTimeSource=m("utils.clock").FakeTimeSource,
        FrontendRPCServer=m("rpc").FrontendRPCServer,
        RemoteFrontend=m("rpc").RemoteFrontend,
        WorkflowRegistry=m("worker").WorkflowRegistry,
        DecisionWorker=m("worker").DecisionWorker,
    )


PACKAGES = {"jax": "cadence_tpu", "port": "cadence_tpu_torch"}


def _echo_signal(ctx, input):
    payload = yield ctx.wait_signal("go")
    return input + b":" + payload


def _error(pkg: str, e: Exception) -> dict:
    """A raised wire error: its class (which must be the client
    package's), message and attributes."""
    mod = type(e).__module__
    assert mod.split(".")[0] == pkg, (mod, pkg)
    return {"class": type(e).__name__, "module": mod[len(pkg):],
            "message": str(e), "attrs": dict(vars(e))}


def _conversation(C, fe) -> dict:
    """One client's calls over the wire; every result kept."""
    out = {"domain_id": fe.register_domain(DOMAIN)}
    req = dict(domain=DOMAIN, workflow_id=WF, workflow_type="echo-signal",
               task_list=TASK_LIST, input=b"in",
               execution_start_to_close_timeout_seconds=60)
    run = fe.start_workflow_execution(
        C.api.StartWorkflowRequest(request_id="req-1", **req))
    out["run_id"] = run
    registry = C.WorkflowRegistry()
    registry.register_workflow("echo-signal", _echo_signal)
    worker = C.DecisionWorker(fe, DOMAIN, TASK_LIST, registry,
                              identity="rpc-worker", sticky=False)
    out["first_decision"] = worker.poll_and_process_one(timeout_s=10.0)
    fe.signal_workflow_execution(C.api.SignalRequest(
        domain=DOMAIN, workflow_id=WF, signal_name="go", input=b"payload",
        identity="rpc-caller", request_id="sig-1"))
    out["second_decision"] = worker.poll_and_process_one(timeout_s=10.0)
    out["describe"] = fe.describe_workflow_execution(DOMAIN, WF, run)
    events, token = fe.get_workflow_execution_history(DOMAIN, WF, run)
    out["history"] = [e.to_dict() for e in events]
    out["last_event"] = events[-1].event_type.name
    out["history_token"] = token
    try:
        fe.describe_workflow_execution("no-such-domain", "w")
        out["not_exists"] = None
    except C.api.EntityNotExistsServiceError as e:
        out["not_exists"] = _error(C.pkg, e)
    try:
        fe.start_workflow_execution(
            C.api.StartWorkflowRequest(request_id="req-2", **req))
        out["already_started"] = None
    except C.api.WorkflowExecutionAlreadyStartedServiceError as e:
        out["already_started"] = _error(C.pkg, e)
    return out


def _over_wire(client_pkg: str, server_pkg: str) -> dict:
    C, S = _mods(client_pkg), _mods(server_pkg)
    kw = {"device": "cpu"} if server_pkg == "cadence_tpu_torch" else {}
    box = S.Onebox(num_shards=2, start_worker=False,
                   time_source=S.FakeTimeSource(T0_NS), **kw).start()
    server = S.FrontendRPCServer(box.frontend, box.admin).start()
    fe = C.RemoteFrontend(server.address)
    try:
        return _Renamer()(_conversation(C, fe))
    finally:
        fe.close()
        server.stop()
        box.stop()


@pytest.mark.parametrize("client", sorted(PACKAGES))
def test_client_talks_to_either_package_server(client):
    """A client of ``client``'s package gets from the other package's
    server exactly what it gets from its own package's."""
    own = PACKAGES[client]
    other = PACKAGES["port" if client == "jax" else "jax"]
    want = _over_wire(own, own)
    got = _over_wire(own, other)
    assert want["first_decision"] and want["second_decision"]
    assert want["describe"]["is_running"] is False
    assert want["last_event"] == "WorkflowExecutionCompleted"
    assert want["already_started"]["attrs"]["run_id"] == want["run_id"]
    assert want["already_started"]["attrs"]["start_request_id"] == "req-1"
    assert want["not_exists"]["class"] == "EntityNotExistsServiceError"
    for key in want:
        assert got[key] == want[key], key


# -- the port's serving plane over the wire --------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _host_snapshot(domain_id, wf, run, batches):
    """The port's host oracle: ``StateBuilder`` over event batches, in
    the canonical snapshot form the serving reads carry."""
    from cadence_tpu_torch.core.mutable_state import MutableState
    from cadence_tpu_torch.core.state_builder import StateBuilder
    from cadence_tpu_torch.core.version_history import VersionHistories
    from cadence_tpu_torch.ops.unpack import mutable_state_to_snapshot

    ms = MutableState(domain_id=domain_id)
    ms.version_histories = VersionHistories.new_empty()
    StateBuilder(ms).apply_batches(domain_id, "", wf, run, batches)
    return mutable_state_to_snapshot(ms)


def _activity_then_signals(ctx, input):
    if int(input) % 2 == 0:
        yield ctx.schedule_activity("work", input)
    for _ in range(2):
        yield ctx.wait_signal("ping")


def test_remote_serving_read_matches_host_replay():
    from cadence_tpu_torch.config import load_config_dict, start_services
    from cadence_tpu_torch.rpc.client import RemoteHistory
    from cadence_tpu_torch.rpc import RemoteFrontend
    from cadence_tpu_torch.runtime.api import (
        SignalRequest, StartWorkflowRequest)
    from cadence_tpu_torch.worker import Worker

    addrs = {s: f"127.0.0.1:{_free_port()}"
             for s in ("frontend", "history", "matching")}
    cfg = load_config_dict({
        "persistence": {"numHistoryShards": 2},
        "services": {s: {"rpcAddress": a} for s, a in addrs.items()},
        "ring": {"probeIntervalSeconds": 0},
        "serving": {"enabled": True, "lanes": 8},
    })
    host = start_services(cfg, ["frontend", "history", "matching"],
                          device="cpu")
    fe, hist = RemoteFrontend(addrs["frontend"]), RemoteHistory(
        addrs["history"])
    worker = Worker(fe, "sr-dom", "sr-tl", identity="sr-worker")
    worker.register_workflow("sr-wf", _activity_then_signals)
    worker.register_activity("work", lambda b: b + b"!")
    try:
        domain_id = fe.register_domain("sr-dom")
        worker.start()
        runs = {f"sr-{i}": fe.start_workflow_execution(StartWorkflowRequest(
            domain="sr-dom", workflow_id=f"sr-{i}", workflow_type="sr-wf",
            task_list="sr-tl", input=b"%d" % i,
            execution_start_to_close_timeout_seconds=600))
            for i in range(4)}
        for wf in runs:
            for k in range(2):
                fe.signal_workflow_execution(SignalRequest(
                    domain="sr-dom", workflow_id=wf, signal_name="ping",
                    input=b"%d" % k, request_id=f"{wf}-sig-{k}"))
        deadline = time.monotonic() + 30.0
        while any(fe.describe_workflow_execution("sr-dom", wf, run)
                  .is_running for wf, run in runs.items()):
            assert time.monotonic() < deadline, "workflows never closed"
            time.sleep(0.05)
        reg = host.metrics.registry

        def counts():
            return (reg.counter_value("serving_cold_misses"),
                    reg.counter_value("serving_resident_hits"))

        for wf, run in runs.items():
            before = counts()
            cold = hist.serving_read(domain_id, wf, run)
            seated = counts()
            warm = hist.serving_read(domain_id, wf, run)
            after = counts()
            # the first read misses and seats the lane, the second hits
            assert seated[0] == before[0] + 1, wf
            assert after == (seated[0], seated[1] + 1), wf
            assert warm.resident, wf
            tip = warm.snapshot["exec"]["next_event_id"]
            batches, _ = fe.get_workflow_execution_raw_history(
                "sr-dom", wf, run, 1, tip)
            events, _ = fe.get_workflow_execution_history("sr-dom", wf, run)
            assert [e.to_dict() for b in batches for e in b] == [
                e.to_dict() for e in events]
            want = _host_snapshot(domain_id, wf, run, batches)
            assert cold.snapshot == want, wf
            assert warm.snapshot == want, wf
            assert warm.state_row["exec_info"].dtype.name == "int32"
    finally:
        worker.stop()
        fe.close()
        hist.close()
        host.stop()


def test_cli_server_boots_on_cpu_and_stops_on_sigterm(tmp_path):
    """``python -m cadence_tpu_torch.tools.cli server --device cpu``
    serves the frontend over sqlite until SIGTERM, and exits 0."""
    from cadence_tpu_torch.rpc.client import grpc_ping

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    child = subprocess.Popen(
        [sys.executable, "-m", "cadence_tpu_torch.tools.cli", "server",
         "--db", str(tmp_path / "c.db"), "--port", str(port),
         "--no-worker", "--device", "cpu"],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60.0
        while not grpc_ping("frontend", f"127.0.0.1:{port}"):
            assert child.poll() is None, child.stderr.read()[-2000:]
            assert time.monotonic() < deadline, "server never answered"
            time.sleep(0.2)
        child.send_signal(signal.SIGTERM)
        out, err = child.communicate(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=10)
    assert child.returncode == 0, err[-2000:]
    assert f"listening on 127.0.0.1:{port}" in out
    assert not grpc_ping("frontend", f"127.0.0.1:{port}")


def _post(address: str, path: str):
    host, port = address.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("POST", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def test_pprof_device_trace_on_cpu_profiler(tmp_path):
    """The device-trace pair brackets a torch.profiler trace of every
    thread: a matmul run on another thread lands in the Chrome trace
    file the stop names. Without a trace running, stop answers 500; on
    ``device="cuda"`` a host without a card refuses the start."""
    from cadence_tpu_torch.utils.pprof import PProfServer

    srv = PProfServer(device="cpu").start()
    try:
        status, body = _post(srv.address,
                             f"/debug/pprof/device/start?dir={tmp_path}")
        assert status == 200, body
        assert _post(srv.address, "/debug/pprof/device/start")[0] == 500

        def work():
            x = torch.ones(32, 32)
            for _ in range(3):
                x = x @ x / 32

        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        status, body = _post(srv.address, "/debug/pprof/device/stop")
        assert status == 200, body
        path = Path(body.split("-> ", 1)[1].strip())
        assert path.parent == tmp_path
        names = {e.get("name") for e in
                 json.loads(path.read_text())["traceEvents"]}
        assert "aten::mm" in names
        assert _post(srv.address, "/debug/pprof/device/stop")[0] == 500
    finally:
        srv.stop()
    if not torch.cuda.is_available():
        srv = PProfServer().start()
        try:
            status, body = _post(srv.address, "/debug/pprof/device/start")
            assert status == 500 and "no CUDA device" in body
        finally:
            srv.stop()


def test_entry_points_default_to_cuda():
    """Without ``device="cpu"`` the config-booted host's serving engine
    takes the card and raises without one (no quiet CPU route); the
    canary and the CLI's server default to the card too."""
    from cadence_tpu_torch.canary import run_canary
    from cadence_tpu_torch.config import load_config_dict, start_services
    from cadence_tpu_torch.tools.cli import build_parser

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = load_config_dict({"serving": {"enabled": True, "lanes": 4},
                            "ring": {"probeIntervalSeconds": 0}})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        start_services(cfg, ["history"])
    assert inspect.signature(run_canary).parameters["device"].default \
        == "cuda"
    for argv in (["server"], ["canary"]):
        assert build_parser().parse_args(argv).device == "cuda"


def test_chaos_section_refused_until_fault_schedules_are_ported():
    """What the port once refused now builds: a chaos section with rules
    parses into the port's ``FaultSchedule``, and ``wrap_bundle`` puts the
    fault client under the metrics client."""
    from cadence_tpu_torch.config import load_config_dict
    from cadence_tpu_torch.config.static import ConfigError
    from cadence_tpu_torch.runtime.persistence.decorators import (
        MetricsClient, wrap_bundle)
    from cadence_tpu_torch.runtime.persistence.memory import (
        create_memory_bundle)
    from cadence_tpu_torch.testing.faults import (
        FaultInjectionClient, FaultSchedule)

    cfg = load_config_dict({"chaos": {"enabled": True, "seed": 3,
                                      "rules": [{"site": "x"}]}})
    sched = cfg.chaos.build_schedule()
    assert isinstance(sched, FaultSchedule) and sched.seed == 3
    assert load_config_dict({"chaos": {"enabled": False, "seed": 3,
                                       "rules": []}}).chaos.seed == 3
    with pytest.raises(ConfigError, match="chaos.rules"):
        load_config_dict({"chaos": {"rules": [{"action": "explode"}]}})
    bundle = wrap_bundle(create_memory_bundle(), faults=sched)
    assert isinstance(bundle.execution, MetricsClient)
    assert isinstance(bundle.execution._base, FaultInjectionClient)


def test_config_booted_host_with_chaos_on(tmp_path):
    """A host booted from a YAML config whose chaos section is enabled
    carries the armed schedule on its store and its history service;
    disarmed, every canary probe passes over the wire; armed again, the
    rule fires at the store and counts in the host's registry."""
    import yaml

    from cadence_tpu_torch.canary import run_canary
    from cadence_tpu_torch.config import load_config, start_services
    from cadence_tpu_torch.runtime.persistence.errors import (
        PersistenceError)
    from cadence_tpu_torch.testing.faults import FaultSchedule

    path = tmp_path / "chaos.yaml"
    path.write_text(yaml.safe_dump({
        "services": {s: {"rpcAddress": f"127.0.0.1:{_free_port()}"}
                     for s in ("frontend", "history", "matching", "worker")},
        "ring": {"probeIntervalSeconds": 0},
        # pinned to a shard the host does not own: nothing of the boot
        # matches it, every call that names the shard does
        "chaos": {"enabled": True, "seed": 11, "rules": [
            {"site": "persistence.execution",
             "method": "get_current_execution", "shard_id": 7,
             "probability": 1.0, "error": "PersistenceError"}]},
    }))
    host = start_services(load_config(str(path)), device="cpu")
    try:
        assert isinstance(host.faults, FaultSchedule) and host.faults.armed
        assert host.history.faults is host.faults
        host.faults.disarm()
        assert not host.faults.armed
        results = run_canary(address=host.addresses["frontend"])
        assert results and all(r["ok"] for r in results), [
            r for r in results if not r["ok"]]
        assert host.faults.injected_total() == 0
        host.faults.arm()
        with pytest.raises(PersistenceError, match="fault-injected"):
            host.history.persistence.execution.get_current_execution(
                7, "d", "wf")
        assert host.faults.injected_total() == 1
        assert host.metrics.registry.counter_value("faults_injected") == 1
    finally:
        host.faults.disarm()
        host.stop()


# -- repairs found driving the entry points (ROADMAP C.5, C.6) -------------


def test_config_booted_host_archives_closed_runs():
    """C.5: a host running the history and worker services puts the
    archival trigger on its close processors, as the Onebox does; the
    canary's archival probe, over the wire, finds the closed run's
    history in the archive."""
    from cadence_tpu_torch.canary import run_canary
    from cadence_tpu_torch.config import load_config_dict, start_services

    cfg = load_config_dict({"services": {
        s: {"rpcAddress": f"127.0.0.1:{_free_port()}"}
        for s in ("frontend", "history", "matching", "worker")},
        "ring": {"probeIntervalSeconds": 0}})
    host = start_services(cfg, device="cpu")
    try:
        results = run_canary(address=host.addresses["frontend"],
                             probes=["archival"])
    finally:
        host.stop()
    assert [r["ok"] for r in results] == [True], results


def test_cancel_request_during_an_inflight_decision_is_delivered():
    """C.6: a cancel request written while a decision is in flight is
    past the decision's Started event, so the worker's poll never
    carried it; completing that decision schedules a new one, whose
    history carries the request, and the workflow closes as canceled."""
    from cadence_tpu_torch.core.enums import DecisionType
    from cadence_tpu_torch.runtime.api import Decision, StartWorkflowRequest
    from cadence_tpu_torch.testing.onebox import Onebox

    box = Onebox(num_shards=1, start_worker=False, device="cpu").start()
    try:
        fe = box.frontend
        fe.register_domain("c6")
        run = fe.start_workflow_execution(StartWorkflowRequest(
            domain="c6", workflow_id="c6-wf", workflow_type="t",
            task_list="c6-tl", execution_start_to_close_timeout_seconds=60))
        first = fe.poll_for_decision_task("c6", "c6-tl", identity="w",
                                          timeout_s=10.0)
        assert first is not None
        fe.request_cancel_workflow_execution("c6", "c6-wf", run,
                                             identity="canceller")
        fe.respond_decision_task_completed(first.task_token, [])
        second = fe.poll_for_decision_task("c6", "c6-tl", identity="w",
                                           timeout_s=5.0)
        assert second is not None, "no decision carries the cancel request"
        assert "WorkflowExecutionCancelRequested" in [
            e.event_type.name for e in second.history]
        fe.respond_decision_task_completed(second.task_token, [Decision(
            DecisionType.CancelWorkflowExecution, {"details": b"ok"})])
        events, _ = fe.get_workflow_execution_history("c6", "c6-wf", run)
        assert events[-1].event_type.name == "WorkflowExecutionCanceled"
    finally:
        box.stop()
