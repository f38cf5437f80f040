"""The operator CLI.

Reference: tools/cli/ (app.go, domainCommands.go, workflowCommands.go,
adminCommands.go) — domain CRUD/failover, workflow
start/show/signal/terminate/cancel/reset/query/list, task-list
describe, admin shard/host introspection, batch operations, plus
``server`` (cmd/server/cadence.go start) which boots a onebox over
sqlite with the gRPC endpoint.

Usage:
    python -m cadence_tpu_torch.tools.cli server --db /tmp/c.db --port 7933
    python -m cadence_tpu_torch.tools.cli --address 127.0.0.1:7933 \\
        domain register --name dev
    python -m cadence_tpu_torch.tools.cli --address 127.0.0.1:7933 \\
        workflow start --domain dev --workflow-id w1 --type t --tasklist tl

A copy of the reference package's ``tools/cli.py`` with every command of
its parser. ``server`` and ``canary`` take ``--device`` (default
``cuda``): where the served host's replays run (the Onebox, its pprof
device trace, or ``start_services`` under ``--config``), and where the
canary's embedded Onebox runs when no ``--address`` is given; pass
``--device cpu`` on a host without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import sys
import time
from typing import Any


def _print(obj: Any) -> None:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = dataclasses.asdict(obj)
    if isinstance(obj, (dict, list)):
        print(json.dumps(obj, indent=2, default=_default))
    else:
        print(obj)


def _default(o: Any) -> Any:
    if isinstance(o, bytes):
        try:
            return o.decode()
        except UnicodeDecodeError:
            return o.hex()
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        return dataclasses.asdict(o)
    return str(o)


def _frontend(args):
    from ..rpc import RemoteFrontend

    if not args.address:
        sys.exit("--address is required (or run `server` first)")
    return RemoteFrontend(args.address)


# -- server ---------------------------------------------------------------


def cmd_server(args) -> None:
    if args.config:
        conflicting = [
            flag for flag, default in (
                ("--db", args.db == ""), ("--port", args.port == 7933),
                ("--shards", args.shards == 4),
                ("--no-worker", not args.no_worker),
                ("--pprof-port", args.pprof_port == 0),
            ) if not default
        ]
        if conflicting:
            sys.exit(
                f"--config conflicts with {', '.join(conflicting)}: "
                "those settings come from the config file"
            )
        _config_server(args)
        return
    from ..rpc import FrontendRPCServer
    from ..runtime.persistence.sqlite import create_sqlite_bundle
    from ..testing.onebox import Onebox

    pprof = None
    if args.pprof_port:
        # bind BEFORE the heavyweight components: a bad port fails fast
        # with nothing to tear down
        from ..utils.pprof import PProfServer

        pprof = PProfServer(port=args.pprof_port,
                            device=args.device).start()
    persistence = (
        create_sqlite_bundle(args.db) if args.db else None
    )
    box = Onebox(
        num_shards=args.shards,
        persistence=persistence,
        start_worker=not args.no_worker,
        device=args.device,
    ).start()
    server = FrontendRPCServer(
        box.frontend, box.admin, address=f"127.0.0.1:{args.port}"
    ).start()
    print(f"cadence-tpu server listening on {server.address} "
          f"(shards={args.shards}, db={args.db or 'memory'}"
          + (f", pprof={pprof.address}" if pprof else "") + ")")
    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    try:
        while not stop:
            time.sleep(0.2)
    finally:
        if pprof is not None:
            pprof.stop()
        server.stop()
        box.stop()


def _config_server(args) -> None:
    """Config-driven start (ref cmd/server/server.go:207-219): only the
    requested services run in this process; peers resolve over the
    ring + gRPC plane."""
    from ..config import load_config, start_services

    cfg = load_config(args.config)
    services = (
        [s.strip() for s in args.services.split(",") if s.strip()]
        if args.services else None
    )
    server = start_services(cfg, services, device=args.device)
    print(
        f"cadence-tpu services {server.services} up; endpoints: "
        f"{server.addresses}"
    )
    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    try:
        while not stop:
            time.sleep(0.2)
    finally:
        server.stop()


# -- schema ---------------------------------------------------------------


def cmd_schema(args) -> None:
    """Versioned schema tooling (ref tools/cassandra/handler.go
    setup-schema / update-schema)."""
    import sqlite3

    from ..runtime.persistence import schema as S

    conn = sqlite3.connect(args.db)
    try:
        if args.schema_cmd == "version":
            _print({
                "db_version": S.get_schema_version(conn),
                "build_version": S.CURRENT_SCHEMA_VERSION,
            })
        elif args.schema_cmd in ("setup", "update"):
            applied = S.update_schema(conn)
            _print({
                "applied": [
                    {"version": v, "name": n} for v, n in applied
                ],
                "db_version": S.get_schema_version(conn),
            })
        elif args.schema_cmd == "check":
            try:
                S.check_compat(conn)
                _print({"compatible": True})
            except S.SchemaVersionError as e:
                _print({"compatible": False, "error": str(e)})
                sys.exit(1)
    finally:
        conn.close()


# -- domain ---------------------------------------------------------------


def cmd_domain(args) -> None:
    fe = _frontend(args)
    if args.domain_cmd == "register":
        out = fe.register_domain(
            args.name, description=args.description or "",
            retention_days=args.retention,
            is_global=args.global_domain,
            clusters=args.clusters.split(",") if args.clusters else None,
            active_cluster=args.active_cluster or "",
        )
        _print({"domain_id": out})
    elif args.domain_cmd == "describe":
        _print(fe.describe_domain(name=args.name))
    elif args.domain_cmd == "list":
        _print(fe.list_domains())
    elif args.domain_cmd == "update":
        kwargs = {}
        if args.description is not None:
            kwargs["description"] = args.description
        if args.retention:
            kwargs["retention_days"] = args.retention
        if args.add_bad_binary:
            kwargs["add_bad_binary"] = {
                "checksum": args.add_bad_binary, "reason": args.reason or ""
            }
        _print(fe.update_domain(args.name, **kwargs))
    elif args.domain_cmd == "failover":
        _print(fe.update_domain(args.name, active_cluster=args.to))
    elif args.domain_cmd == "deprecate":
        fe.deprecate_domain(args.name)
        _print({"deprecated": args.name})


# -- workflow -------------------------------------------------------------


def cmd_workflow(args) -> None:
    from ..runtime.api import SignalRequest, StartWorkflowRequest

    fe = _frontend(args)
    wc = args.workflow_cmd
    if wc == "start":
        run_id = fe.start_workflow_execution(
            StartWorkflowRequest(
                domain=args.domain, workflow_id=args.workflow_id,
                workflow_type=args.type, task_list=args.tasklist,
                input=(args.input or "").encode(),
                execution_start_to_close_timeout_seconds=args.timeout,
                cron_schedule=args.cron or "",
            )
        )
        _print({"run_id": run_id})
    elif wc == "show":
        events, _ = fe.get_workflow_execution_history(
            args.domain, args.workflow_id, args.run_id or ""
        )
        _print([
            {
                "id": e.event_id,
                "type": e.event_type.name,
                "version": e.version,
                "attributes": {
                    k: v for k, v in e.attributes.items() if v not in
                    (None, "", b"")
                },
            }
            for e in events
        ])
    elif wc == "describe":
        _print(fe.describe_workflow_execution(
            args.domain, args.workflow_id, args.run_id or ""
        ))
    elif wc == "signal":
        fe.signal_workflow_execution(
            SignalRequest(
                domain=args.domain, workflow_id=args.workflow_id,
                run_id=args.run_id or "", signal_name=args.name,
                input=(args.input or "").encode(),
            )
        )
        _print({"signaled": args.workflow_id})
    elif wc == "terminate":
        fe.terminate_workflow_execution(
            args.domain, args.workflow_id, args.run_id or "",
            reason=args.reason or "terminated via cli",
        )
        _print({"terminated": args.workflow_id})
    elif wc == "cancel":
        fe.request_cancel_workflow_execution(
            args.domain, args.workflow_id, args.run_id or ""
        )
        _print({"cancel_requested": args.workflow_id})
    elif wc == "reset":
        new_run = fe.reset_workflow_execution(
            args.domain, args.workflow_id, args.run_id or "",
            reason=args.reason or "reset via cli",
            decision_finish_event_id=args.event_id,
            reset_type=args.reset_type,
            bad_binary_checksum=args.bad_binary_checksum,
        )
        _print({"new_run_id": new_run})
    elif wc == "query":
        out = fe.query_workflow(
            args.domain, args.workflow_id, args.run_id or "",
            query_type=args.type, timeout_s=args.timeout,
            reject_not_open=args.reject_not_open,
        )
        _print({"result": out.decode(errors="replace")})
    elif wc == "list":
        recs, _ = fe.list_workflow_executions(
            args.domain, args.query or "", page_size=args.page_size
        )
        _print(recs)
    elif wc == "count":
        _print({"count": fe.count_workflow_executions(
            args.domain, args.query or ""
        )})
    elif wc == "signalwithstart":
        from ..runtime.api import SignalWithStartRequest

        run_id = fe.signal_with_start_workflow_execution(
            SignalWithStartRequest(
                start=StartWorkflowRequest(
                    domain=args.domain, workflow_id=args.workflow_id,
                    workflow_type=args.type, task_list=args.tasklist,
                    input=(args.input or "").encode(),
                    execution_start_to_close_timeout_seconds=args.timeout,
                    cron_schedule=args.cron or "",
                ),
                signal_name=args.name,
                signal_input=(args.signal_input or "").encode(),
            )
        )
        _print({"run_id": run_id})
    elif wc == "observe":
        # reference workflowCommands.go ObserveHistory: long-poll the
        # history from the last seen event (the server blocks until new
        # events land — no full re-fetch, no client-side poll loop)
        from ..core.enums import EventType

        terminal = {
            EventType.WorkflowExecutionCompleted,
            EventType.WorkflowExecutionFailed,
            EventType.WorkflowExecutionTimedOut,
            EventType.WorkflowExecutionCanceled,
            EventType.WorkflowExecutionTerminated,
            EventType.WorkflowExecutionContinuedAsNew,
        }
        printed = 0
        deadline = time.monotonic() + args.timeout
        while True:
            events, _ = fe.get_workflow_execution_history(
                args.domain, args.workflow_id, args.run_id or "",
                first_event_id=printed + 1, wait_for_new_event=True,
            )
            for e in events:
                print(f"{e.event_id:5d}  {e.event_type.name}")
                printed = max(printed, e.event_id)
            if events and events[-1].event_type in terminal:
                _print({"closed": True, "events": printed})
                return
            if time.monotonic() > deadline:
                _print({"closed": False, "events": printed})
                return
    elif wc == "export":
        # full-fidelity history dump (admin history-dump depth): every
        # event with all attributes, replayable JSON
        events, _ = fe.get_workflow_execution_history(
            args.domain, args.workflow_id, args.run_id or ""
        )
        payload = json.dumps(
            [
                {
                    "event_id": e.event_id,
                    "event_type": e.event_type.name,
                    "version": e.version,
                    "timestamp": e.timestamp,
                    "attributes": e.attributes,
                }
                for e in events
            ],
            indent=2, default=_default,
        )
        if args.output:
            with open(args.output, "w") as f:
                f.write(payload)
            _print({"exported": len(events), "to": args.output})
        else:
            print(payload)


# -- tasklist / admin / batch --------------------------------------------


def cmd_tasklist(args) -> None:
    fe = _frontend(args)
    _print(fe.describe_task_list(args.domain, args.name, args.task_type))


def _value_size(value) -> int:
    """Payload size in bytes for any payload shape (dead letters carry
    whatever the producer published: bytes, str, dict, ...)."""
    if isinstance(value, (bytes, bytearray)):
        return len(value)
    if isinstance(value, str):
        return len(value.encode())
    try:
        return len(json.dumps(value, default=str).encode())
    except TypeError:
        return len(repr(value).encode())


def cmd_admin(args) -> None:
    fe = _frontend(args)
    if args.admin_cmd == "describe-host":
        _print(fe.describe_history_host())
    elif args.admin_cmd == "close-shard":
        fe.close_shard(args.shard_id)
        _print({"closed": args.shard_id})
    elif args.admin_cmd == "describe-workflow":
        # distinct RPC name: the public describe_workflow_execution
        # shadows the admin variant in by-name dispatch
        _print(fe.admin_describe_workflow_execution(
            args.domain, args.workflow_id, args.run_id or ""
        ))
    elif args.admin_cmd == "refresh-tasks":
        _print(fe.refresh_workflow_tasks(
            args.domain, args.workflow_id, args.run_id or ""
        ))
    elif args.admin_cmd == "queue-state":
        # reference tools/cli/adminQueueCommands.go DescribeQueue
        _print(fe.describe_queue_states(args.shard_id))
    elif args.admin_cmd == "dlq":
        # reference tools/cli/adminDLQCommands.go read|purge|merge with
        # a --last-message-id watermark
        if args.dlq_cmd == "read":
            msgs = fe.read_dlq_messages(
                args.topic, args.last_message_id, args.count
            )
            _print({"topic": args.topic, "messages": [
                {
                    "offset": m["offset"],
                    "key": m["key"],
                    "redelivery_count": m["redelivery_count"],
                    "value_bytes": _value_size(m["value"]),
                }
                for m in msgs
            ]})
        elif args.dlq_cmd == "purge":
            n = fe.purge_dlq_messages(args.topic, args.last_message_id)
            _print({"topic": args.topic, "purged": n})
        elif args.dlq_cmd == "merge":
            n = fe.merge_dlq_messages(args.topic, args.last_message_id)
            _print({"topic": args.topic, "merged": n})


def cmd_batch(args) -> None:
    from ..runtime.api import StartWorkflowRequest
    from ..worker.batcher import (
        BATCHER_TASK_LIST,
        BATCHER_WORKFLOW_TYPE,
    )
    from ..worker.service import SYSTEM_DOMAIN

    fe = _frontend(args)
    payload = json.dumps({
        "operation": args.operation,
        "domain": args.domain,
        "query": args.query or "",
        "params": {
            "reason": args.reason or "batch via cli",
            "signal_name": args.signal_name or "",
            "signal_input": args.input or "",
        },
    }).encode()
    run_id = fe.start_workflow_execution(
        StartWorkflowRequest(
            domain=SYSTEM_DOMAIN,
            workflow_id=f"cli-batch-{int(time.time())}",
            workflow_type=BATCHER_WORKFLOW_TYPE,
            task_list=BATCHER_TASK_LIST, input=payload,
            execution_start_to_close_timeout_seconds=3600,
        )
    )
    _print({"batch_run_id": run_id})


def cmd_canary(args) -> None:
    from ..canary.runner import run_canary

    results = run_canary(
        address=args.address, probes=args.probes.split(",") if args.probes
        else None, device=args.device,
    )
    _print(results)
    if any(not r["ok"] for r in results):
        sys.exit(1)


# -- parser ---------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cadence-tpu")
    p.add_argument("--address", default="",
                   help="frontend gRPC address (host:port)")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("server", help="run server services")
    s.add_argument("--db", default="", help="sqlite path (default memory)")
    s.add_argument("--port", type=int, default=7933)
    s.add_argument("--shards", type=int, default=4)
    s.add_argument("--no-worker", action="store_true")
    s.add_argument("--pprof-port", type=int, default=0,
                   help="serve /debug/pprof diagnostics on this port")
    s.add_argument("--config", default="",
                   help="static YAML config (enables --services)")
    s.add_argument("--services", default="",
                   help="comma list: frontend,history,matching,worker")
    s.add_argument("--device", default="cuda",
                   help="where the host's replays run (cuda or cpu)")
    s.set_defaults(fn=cmd_server)

    sc = sub.add_parser("schema", help="versioned sqlite schema tooling")
    scsub = sc.add_subparsers(dest="schema_cmd", required=True)
    for name in ("setup", "update", "version", "check"):
        sp = scsub.add_parser(name)
        sp.add_argument("--db", required=True)
    sc.set_defaults(fn=cmd_schema)

    d = sub.add_parser("domain")
    dsub = d.add_subparsers(dest="domain_cmd", required=True)
    for name in ("register", "describe", "update", "deprecate"):
        dp = dsub.add_parser(name)
        dp.add_argument("--name", required=True)
        dp.add_argument("--description")
        dp.add_argument("--retention", type=int, default=7)
        dp.add_argument("--global-domain", action="store_true")
        dp.add_argument("--clusters", default="")
        dp.add_argument("--active-cluster", default="")
        dp.add_argument("--add-bad-binary", default="")
        dp.add_argument("--reason", default="")
    dl = dsub.add_parser("list")
    df = dsub.add_parser("failover")
    df.add_argument("--name", required=True)
    df.add_argument("--to", required=True)
    d.set_defaults(fn=cmd_domain)

    w = sub.add_parser("workflow")
    wsub = w.add_subparsers(dest="workflow_cmd", required=True)
    for name in ("start", "show", "describe", "signal", "terminate",
                 "cancel", "reset", "query", "list", "count",
                 "signalwithstart", "observe", "export"):
        wp = wsub.add_parser(name)
        wp.add_argument("--domain", required=True)
        if name not in ("list", "count"):
            wp.add_argument("--workflow-id", required=True)
        wp.add_argument("--run-id", default="")
        wp.add_argument("--type", default="")
        wp.add_argument("--tasklist", default="")
        wp.add_argument("--input", default="")
        wp.add_argument("--name", default="")
        wp.add_argument("--reason", default="")
        wp.add_argument("--query", default="")
        wp.add_argument("--cron", default="")
        wp.add_argument("--event-id", type=int, default=0)
        wp.add_argument("--timeout", type=int, default=60)
        wp.add_argument("--page-size", type=int, default=100)
        wp.add_argument("--signal-input", default="")
        wp.add_argument("--output", default="",
                        help="export: write history JSON here")
        wp.add_argument("--reject-not-open", action="store_true",
                        help="query: fail instead of answering from a "
                             "closed run")
        wp.add_argument("--reset-type", default="",
                        help="reset: FirstDecisionCompleted | "
                             "LastDecisionCompleted | BadBinary")
        wp.add_argument("--bad-binary-checksum", default="")
    w.set_defaults(fn=cmd_workflow)

    t = sub.add_parser("tasklist")
    t.add_argument("--domain", required=True)
    t.add_argument("--name", required=True)
    t.add_argument("--task-type", type=int, default=0)
    t.set_defaults(fn=cmd_tasklist)

    a = sub.add_parser("admin")
    asub = a.add_subparsers(dest="admin_cmd", required=True)
    asub.add_parser("describe-host")
    acs = asub.add_parser("close-shard")
    acs.add_argument("--shard-id", type=int, required=True)
    for name in ("describe-workflow", "refresh-tasks"):
        adw = asub.add_parser(name)
        adw.add_argument("--domain", required=True)
        adw.add_argument("--workflow-id", required=True)
        adw.add_argument("--run-id", default="")
    aqs = asub.add_parser("queue-state",
                          help="per-queue cursors/depths of one shard")
    aqs.add_argument("--shard-id", type=int, required=True)
    adlq = asub.add_parser("dlq", help="dead-letter queue operator verbs")
    adlq.add_argument("dlq_cmd", choices=("read", "purge", "merge"))
    adlq.add_argument("--topic", required=True)
    adlq.add_argument("--last-message-id", type=int, default=-1)
    adlq.add_argument("--count", type=int, default=100)
    a.set_defaults(fn=cmd_admin)

    b = sub.add_parser("batch")
    b.add_argument("--operation", required=True,
                   choices=("terminate", "cancel", "signal"))
    b.add_argument("--domain", required=True)
    b.add_argument("--query", default="")
    b.add_argument("--reason", default="")
    b.add_argument("--signal-name", default="")
    b.add_argument("--input", default="")
    b.set_defaults(fn=cmd_batch)

    c = sub.add_parser("canary", help="run health-probe workflows")
    c.add_argument("--probes", default="")
    c.add_argument("--device", default="cuda",
                   help="device of the embedded Onebox (no --address)")
    c.set_defaults(fn=cmd_canary)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
