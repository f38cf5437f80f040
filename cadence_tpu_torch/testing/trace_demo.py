"""Trace demo: boot Onebox, run one workflow, dump its trace.

The zero-to-trace walkthrough (a tier-1 smoke test invokes it so the
endpoint can't rot):

1. configure the process tracer (utils/tracing.py), boot an in-process
   Onebox and start a PProfServer on an ephemeral port;
2. register a two-activity worker;
3. drive ONE workflow decision to completion inside an explicitly
   sampled root span — the production shape where the edge (an RPC
   endpoint at ``telemetry.sampleRate``) roots the trace;
4. fetch ``GET /debug/pprof/traces`` over real HTTP and pretty-print
   the Chrome-trace JSON (or a per-span summary with ``--summary``).

Exit status 0 requires the dumped trace to span frontend → history →
matching → queue → persistence with ≥ 6 spans and intact parent/child
links — the same invariant tests/test_telemetry.py asserts in-process.

A copy of the reference package's ``testing/trace_demo.py`` over the
port's Onebox twin and pprof endpoint, with one more flag, ``--device``
(default ``cuda``, which raises without a card): where the Onebox's
history host replays and the endpoint's device trace records.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request


def _doubler(ctx, input):
    a = yield ctx.schedule_activity("double", input)
    b = yield ctx.schedule_activity("double", a)
    return b


def run_demo(summary: bool = False, quiet: bool = False,
             timeout_s: float = 30.0, device: str = "cuda") -> int:
    from ..ops.schema import resolve_device
    from ..runtime.api import StartWorkflowRequest
    from ..utils.pprof import PProfServer
    from ..utils.tracing import TRACER
    from ..worker import Worker
    from .onebox import Onebox

    def say(msg):
        if not quiet:
            print(msg, file=sys.stderr)

    # the port's device rule: "cuda" raises here without a card
    device = resolve_device(device)
    TRACER.configure(sample_rate=1.0)
    TRACER.clear()
    box = Onebox(num_shards=2, device=device).start()
    pprof = PProfServer(port=0, device=device).start()
    TRACER.configure(metrics=box.metrics)
    w = Worker(box.frontend, "trace-demo", "trace-demo-tl",
               identity="trace-demo-worker")
    w.register_workflow("demo-wf", _doubler)
    w.register_activity("double", lambda inp: inp * 2)
    try:
        box.domain_handler.register_domain("trace-demo")
        w.start()
        say(f"onebox up; pprof on http://{pprof.address}")

        with TRACER.trace("workflow_decision", sampled=True,
                          service="demo") as root:
            trace_id = root.trace_id
            run_id = box.frontend.start_workflow_execution(
                StartWorkflowRequest(
                    domain="trace-demo", workflow_id="trace-demo-wf",
                    workflow_type="demo-wf", task_list="trace-demo-tl",
                    input=b"\x02", request_id="trace-demo-req",
                    execution_start_to_close_timeout_seconds=60,
                )
            )
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                d = box.frontend.describe_workflow_execution(
                    "trace-demo", "trace-demo-wf", run_id
                )
                if not d.is_running:
                    break
                time.sleep(0.02)
            else:
                say("workflow did not complete in time")
                return 1
        # let the asynchronous tail (queue/matching spans on pump
        # threads) finish into the flight recorder
        time.sleep(0.3)

        url = (f"http://{pprof.address}/debug/pprof/traces"
               f"?trace_id={trace_id}")
        say(f"GET {url}")
        with urllib.request.urlopen(url, timeout=10.0) as resp:
            doc = json.loads(resp.read().decode())
    finally:
        w.stop()
        box.stop()
        pprof.stop()

    spans = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    services = {
        next(
            m["args"]["name"]
            for m in doc["traceEvents"]
            if m.get("ph") == "M" and m["pid"] == e["pid"]
        )
        for e in spans
    }
    ids = {e["args"]["span_id"] for e in spans}
    orphans = [
        e["name"] for e in spans
        if e["args"]["parent_id"] and e["args"]["parent_id"] not in ids
    ]

    if summary:
        for e in sorted(spans, key=lambda e: e["ts"]):
            print(f"{e['dur'] / 1000.0:9.3f}ms  "
                  f"{e['args']['parent_id'] and '└ ' or ''}{e['name']}")
    else:
        print(json.dumps(doc, indent=1))

    say(f"trace {trace_id}: {len(spans)} spans across "
        f"{sorted(services)}")
    required = {"frontend", "history", "matching", "history_queue",
                "persistence"}
    missing = required - services
    if missing:
        say(f"FAIL: trace is missing service planes: {sorted(missing)}")
        return 1
    if len(spans) < 6:
        say(f"FAIL: expected >= 6 spans, got {len(spans)}")
        return 1
    if orphans:
        say(f"FAIL: spans with dangling parent links: {orphans}")
        return 1
    say("OK: single cross-service trace, parent/child links intact")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cadence_tpu_torch.testing.trace_demo"
    )
    ap.add_argument("--summary", action="store_true",
                    help="print a per-span summary instead of raw JSON")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress progress chatter on stderr")
    ap.add_argument("--timeout", type=float, default=30.0)
    ap.add_argument("--device", default="cuda",
                    help="where the history host replays and the pprof "
                    "device trace records (cuda, the default, or cpu)")
    args = ap.parse_args(argv)
    return run_demo(summary=args.summary, quiet=args.quiet,
                    timeout_s=args.timeout, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
