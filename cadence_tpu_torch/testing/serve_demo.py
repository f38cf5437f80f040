"""Serving demo: boot Onebox with serving enabled, drive an open-loop
burst, prove resident hits and a clean drain.

The zero-to-resident walkthrough (a tier-1 smoke test invokes it so the
serving plane can't rot):

1. boot an in-process Onebox with the continuous-batching resident
   engine attached (the ``serving:`` config section's wiring) and a
   checkpoint plane for eviction flushes;
2. start a few signal-sink workflows through the real frontend;
3. drive a short open-loop burst: signal arrivals paced by the same
   ``ArrivalProcess`` schedule the SLO harness uses, each followed by
   a ``serving_read`` — the first read per workflow cold-misses and
   seats a lane, every later read answers resident with the Δ suffix
   composed (the persist feed marks the lane behind on every durable
   signal write);
4. shut down — ``HistoryService.stop`` drains the engine, flushing
   every resident lane back through the checkpoint plane.

Exit status 0 requires resident hits ≥ requests − workflows (at most
one cold miss per workflow), zero flush failures on the drain, and an
empty engine after shutdown. One JSON summary line lands on stdout.

A copy of the reference package's ``testing/serve_demo.py`` with one
more flag, ``--device`` (default ``cuda``, which raises without a card):
the resident engine's device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _signal_sink(ctx, input):
    while True:
        yield ctx.wait_signal("ping")


def run_demo(workflows: int = 3, requests: int = 18, qps: float = 60.0,
             kind: str = "bursty", quiet: bool = False,
             timeout_s: float = 30.0, device: str = "cuda") -> int:
    from ..runtime.api import SignalRequest, StartWorkflowRequest
    from ..serving import ArrivalProcess
    from .onebox import Onebox
    from ..worker import Worker

    def say(msg):
        if not quiet:
            print(msg, file=sys.stderr)

    box = Onebox(num_shards=2, checkpoints=True, serving=True,
                 start_worker=False, device=device).start()
    w = Worker(box.frontend, "serve-demo", "serve-demo-tl",
               identity="serve-demo-worker")
    w.register_workflow("signal-sink", _signal_sink)
    try:
        box.domain_handler.register_domain("serve-demo")
        w.start()
        say(f"onebox up; serving engine: {box.serving.lanes} lanes")
        wf_ids = [f"serve-demo-wf-{i}" for i in range(workflows)]
        for wid in wf_ids:
            box.frontend.start_workflow_execution(
                StartWorkflowRequest(
                    domain="serve-demo", workflow_id=wid,
                    workflow_type="signal-sink",
                    task_list="serve-demo-tl",
                    input=b"", request_id=f"req-{wid}",
                    execution_start_to_close_timeout_seconds=300,
                )
            )
        dom_id = box.domains.get_by_name("serve-demo").info.id

        # the open-loop burst: arrivals on an absolute schedule (the
        # same process the SLO harness uses) — falling behind shows up
        # as latency, never as a thinner burst
        schedule = ArrivalProcess(
            qps=qps, kind=kind, seed=11
        ).schedule(requests)
        t0 = time.monotonic()
        deadline = t0 + timeout_s
        lat_ms = []
        for i in range(requests):
            if time.monotonic() > deadline:
                say(f"FAIL: burst exceeded --timeout {timeout_s}s "
                    f"at request {i}/{requests}")
                return 1
            now = time.monotonic() - t0
            if schedule[i] > now:
                time.sleep(schedule[i] - now)
            wid = wf_ids[i % workflows]
            box.frontend.signal_workflow_execution(
                SignalRequest(
                    domain="serve-demo", workflow_id=wid,
                    signal_name="ping", input=b"%d" % i,
                )
            )
            # per-read duration (the resident-read claim); the bench's
            # serve_continuous config owns the open-loop scheduled-
            # arrival SLOs, where compile stalls count as queueing
            t_read = time.monotonic()
            got = box.history.serving_read(dom_id, wid)
            assert got is not None, f"serving read lost {wid}"
            lat_ms.append((time.monotonic() - t_read) * 1e3)
        wall = time.monotonic() - t0
        reg = box.metrics.registry
        hits = reg.counter_value("serving_resident_hits")
        misses = reg.counter_value("serving_cold_misses")
        occupancy = box.serving.occupancy()
    finally:
        w.stop()
        box.stop()  # HistoryService.stop drains the resident engine

    evictions = reg.counter_value("serving_evictions")
    flush_failed = reg.counter_value("serving_flush_failures")
    lat_ms.sort()
    summary = {
        "workflows": workflows,
        "requests": requests,
        "qps_target": qps,
        "qps_sustained": round(requests / wall, 1) if wall > 0 else 0.0,
        "arrival": kind,
        "resident_hits": hits,
        "cold_misses": misses,
        "occupancy_before_drain": occupancy,
        "drain_evictions": evictions,
        "drain_flush_failures": flush_failed,
        "read_p50_ms": round(lat_ms[len(lat_ms) // 2], 3),
        "read_max_ms": round(lat_ms[-1], 3),
    }
    print(json.dumps(summary))

    if hits < requests - workflows:
        say(f"FAIL: expected >= {requests - workflows} resident hits, "
            f"got {hits} ({misses} cold misses)")
        return 1
    if occupancy <= 0:
        say("FAIL: no lanes were resident at burst end")
        return 1
    if flush_failed:
        say(f"FAIL: drain left {flush_failed} unflushed lanes")
        return 1
    if evictions < 1:
        say("FAIL: the shutdown drain never flushed a lane")
        return 1
    if box.serving.occupancy() != 0.0:
        say("FAIL: engine not empty after drain")
        return 1
    say(f"OK: {hits} resident hits / {misses} cold misses at "
        f"{summary['qps_sustained']} qps; clean drain "
        f"({evictions} lanes flushed, 0 failures)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cadence_tpu_torch.testing.serve_demo"
    )
    ap.add_argument("--workflows", type=int, default=3)
    ap.add_argument("--requests", type=int, default=18)
    ap.add_argument("--qps", type=float, default=60.0)
    ap.add_argument("--kind", choices=("poisson", "bursty"),
                    default="bursty")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress progress chatter on stderr")
    ap.add_argument("--timeout", type=float, default=30.0)
    ap.add_argument("--device", default="cuda",
                    help="the resident engine's device (cuda or cpu)")
    args = ap.parse_args(argv)
    return run_demo(workflows=args.workflows, requests=args.requests,
                    qps=args.qps, kind=args.kind, quiet=args.quiet,
                    timeout_s=args.timeout, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
