"""Canary runner: register the probe worker, drive every probe, report.

Reference: canary/canary.go + runner.go — the sanity workflow fans out
one child per probe type; here the runner drives probes directly and
reports per-probe latency + pass/fail.

A copy of the reference package's ``canary/runner.py``; the embedded
Onebox runs on ``device``.
"""

from __future__ import annotations

import time
import traceback
from typing import List, Optional

from ..frontend.domain_handler import DomainAlreadyExistsError
from ..worker import Worker

from .probes import (
    LOCAL_ACTIVITIES,
    PROBES,
    TASK_LIST,
    WORKFLOWS,
    make_activities,
)

CANARY_DOMAIN = "cadence-canary"


def run_canary(
    address: str = "", probes: Optional[List[str]] = None,
    frontend=None, keep_box=None, device="cuda",
) -> List[dict]:
    """Run probes against ``address`` (or an embedded onebox on
    ``device``)."""
    box = None
    if frontend is None:
        if address:
            from ..rpc import RemoteFrontend

            frontend = RemoteFrontend(address)
        else:
            from ..testing.onebox import Onebox

            box = Onebox(num_shards=4, device=device).start()
            frontend = box.frontend
            if keep_box is not None:
                # hand the embedded box to the caller (tests read its
                # metrics registry after the run)
                keep_box.box = box
    try:
        try:
            frontend.register_domain(CANARY_DOMAIN, retention_days=1)
        except DomainAlreadyExistsError:
            pass

        worker = Worker(frontend, CANARY_DOMAIN, TASK_LIST,
                        identity="canary")
        for wf_type, fn in WORKFLOWS.items():
            worker.register_workflow(wf_type, fn)
        for name, fn in make_activities().items():
            worker.register_activity(name, fn)
        for name, fn in LOCAL_ACTIVITIES.items():
            worker.register_local_activity(name, fn)
        worker.register_query_handler(
            "canary-query", lambda qt, args: b"canary-query-alive"
        )
        worker.start()
        try:
            selected = probes or list(PROBES)
            results = []
            for name in selected:
                probe = PROBES.get(name)
                if probe is None:
                    results.append(
                        {"probe": name, "ok": False,
                         "error": "unknown probe"}
                    )
                    continue
                t0 = time.monotonic()
                try:
                    probe(frontend, CANARY_DOMAIN)
                    results.append({
                        "probe": name, "ok": True,
                        "latency_ms": round(
                            (time.monotonic() - t0) * 1000, 1
                        ),
                    })
                except Exception as e:
                    results.append({
                        "probe": name, "ok": False,
                        "latency_ms": round(
                            (time.monotonic() - t0) * 1000, 1
                        ),
                        "error": f"{type(e).__name__}: {e}",
                        "trace": traceback.format_exc()[-1000:],
                    })
            return results
        finally:
            worker.stop()
    finally:
        if box is not None:
            box.stop()
