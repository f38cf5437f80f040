"""The reference's chaos and sanitizer suites, run on the port.

``tests/test_chaos_recovery.py`` and ``tests/test_race_witness.py`` are
exec'd whole with every ``cadence_tpu.`` import taken from
``cadence_tpu_torch``, the lock and module paths they name
(``cadence_tpu/...``) read as the port's, and every constructor that takes
a device (``HistoryService``, ``StateRebuilder``,
``ReplicatorQueueProcessor``, ``ReshardCoordinator``, ``ResidentEngine``,
``Onebox``, and ``replay_packed_lanes``) bound to ``device="cpu"``; each of
their non-slow test methods is one parametrised case here. The witness and
lock-graph artifacts go to ``build/torch_lock_*.json``, never to the
reference's ``build/lock_*.json``.

The chaos module is registered once as ``tests.port_test_chaos_recovery``
(``chaos_module``), the module the topology cases import ``ChaosBox``
from, whichever file loads it first.

One case reads Pass 5 (``analysis/queue_effects``): the rewrite makes it
the port's own copy, whose ``handler_footprints`` runs over the port's
handler sources, so the recorded effects of the port's handlers are held
against the footprints extracted from the port's own code.

Besides: the same ``FaultSchedule.from_dicts`` rules and call sequence
plan the same faults in both packages, the port's Pass 3 is clean against
the port's baseline, and the chaos section of a config builds the port's
schedule.
"""

from __future__ import annotations

import functools
import importlib
import inspect
import re
import sys
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

SOURCES = ("test_chaos_recovery", "test_race_witness")
_DEVICE_BOUND = ("HistoryService", "StateRebuilder",
                 "ReplicatorQueueProcessor", "ReshardCoordinator",
                 "ResidentEngine", "Onebox")
# constructors a case imports inside its body: bound for the case
_BOUND_IN_MODULES = (
    ("cadence_tpu_torch.serving", "ResidentEngine"),
    ("cadence_tpu_torch.runtime.resharding", "ReshardCoordinator"),
    ("cadence_tpu_torch.runtime.replication.rebuilder", "StateRebuilder"),
    ("cadence_tpu_torch.testing.onebox", "Onebox"),
    ("cadence_tpu_torch.ops.replay", "replay_packed_lanes"),
)
CHAOS_MODULE = "tests.port_test_chaos_recovery"


def port_source(src: str) -> str:
    """A reference test module's source, on the port."""
    src = src.replace("from tests.test_chaos_recovery import",
                      f"from {CHAOS_MODULE} import")
    src = src.replace('"lock_witness.json"', '"torch_lock_witness.json"')
    src = src.replace('"lock_graph.json"', '"torch_lock_graph.json"')
    src = src.replace("cadence_tpu/", "cadence_tpu_torch/")
    return re.sub(r"\bcadence_tpu\.", "cadence_tpu_torch.", src)


def _exec(name: str, module: str) -> dict:
    path = REPO / "tests" / f"{name}.py"
    ns = {"__name__": module, "__file__": str(path)}
    exec(compile(port_source(path.read_text()), str(path), "exec"), ns)
    for cls in _DEVICE_BOUND:
        if cls in ns:
            ns[cls] = functools.partial(ns[cls], device="cpu")
    return ns


def chaos_module() -> types.ModuleType:
    """``tests/test_chaos_recovery.py`` exec'd on the port, registered
    once as ``tests.port_test_chaos_recovery``."""
    mod = sys.modules.get(CHAOS_MODULE)
    if mod is None:
        mod = types.ModuleType(CHAOS_MODULE)
        mod.__dict__.update(_exec("test_chaos_recovery", CHAOS_MODULE))
        sys.modules[CHAOS_MODULE] = mod
    return mod


class DeviceBinder:
    """Binds the device-taking callables that a case imports inside its
    body to the CPU for the duration of the case."""

    def __enter__(self):
        self._saved = []
        for mod_name, attr in _BOUND_IN_MODULES:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, functools.partial(orig, device="cpu"))
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)


def _load(name: str) -> dict:
    if name == "test_chaos_recovery":
        return chaos_module().__dict__
    return _exec(name, f"tests.port_{name}")


def _slow(obj) -> bool:
    return any(m.name == "slow" for m in getattr(obj, "pytestmark", []))


def _cases(with_slow: bool = False):
    out = {}
    for name in SOURCES:
        ns = _load(name)
        for attr, obj in list(ns.items()):
            if getattr(obj, "__module__", None) != ns["__name__"]:
                continue
            if not with_slow and _slow(obj):
                continue
            if attr.startswith("test_") and callable(obj):
                out[f"{name}::{attr}"] = (ns, None, attr)
            elif attr.startswith("Test") and inspect.isclass(obj):
                for meth in dir(obj):
                    if meth.startswith("test_") and (
                            with_slow or not _slow(getattr(obj, meth))):
                        out[f"{name}::{attr}::{meth}"] = (ns, attr, meth)
    return out


_ALL = _cases()
CASES = sorted(_ALL)


def test_reference_cases_found():
    every = _cases(with_slow=True)
    per_file = {n: sum(k.startswith(n + "::") for k in every)
                for n in SOURCES}
    assert per_file == {"test_chaos_recovery": 41, "test_race_witness": 25}
    # six slow-marked chaos cases are not collected (tier-1 runs
    # -m 'not slow'); every other case is
    slow = set(every) - set(_ALL)
    assert {k.split("::")[0] for k in slow} == {"test_chaos_recovery"}
    assert len(slow) == 6
    assert len(CASES) == 41 + 25 - 6
    chaos = chaos_module()
    assert chaos.ChaosBox.__module__ == CHAOS_MODULE
    assert chaos.FaultSchedule.__module__ == "cadence_tpu_torch.testing.faults"
    assert chaos.HistoryService.func.__module__ == \
        "cadence_tpu_torch.runtime.service"


def _call_hook(hook, method) -> None:
    if inspect.signature(hook).parameters:
        hook(method)
    else:
        hook()


@pytest.mark.parametrize("case", CASES)
def test_reference_chaos_case_on_port(case, tmp_path):
    ns, cls, name = _ALL[case]
    with DeviceBinder():
        obj = None
        if cls is not None:
            obj = ns[cls]()
            fn = getattr(obj, name)
            if hasattr(obj, "setup_method"):
                _call_hook(obj.setup_method, fn)
        else:
            fn = ns[name]
        params = list(inspect.signature(fn).parameters)
        assert params in ([], ["tmp_path"]), params
        try:
            fn(*[tmp_path] * len(params))
        finally:
            if obj is not None and hasattr(obj, "teardown_method"):
                _call_hook(obj.teardown_method, fn)


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

_RULES = [
    {"site": "persistence.execution", "method": "update_*",
     "probability": 0.3, "error": "PersistenceError"},
    {"site": "persistence.history", "method": "append_*",
     "probability": 0.25, "action": "torn_write",
     "error": "TimeoutError"},
    {"site": "queue.*", "shard_id": 1, "probability": 0.5,
     "after_calls": 3, "max_faults": 4, "error": "ShardOwnershipLostError"},
    {"site": "persistence.checkpoint", "probability": 0.4,
     "action": "latency", "latency_s": 0.0},
    {"site": "replication.ndc", "probability": 0.2,
     "error": "PersistenceBusyError"},
]


def _call_sequence(seed: int, n: int = 600):
    import random

    rng = random.Random(seed)
    sites = [("persistence.execution", "update_workflow_execution"),
             ("persistence.execution", "get_workflow_execution"),
             ("persistence.history", "append_history_nodes"),
             ("persistence.checkpoint", "put_checkpoint"),
             ("queue.transfer-1", "0"), ("queue.timer-0", "2"),
             ("replication.ndc", "apply_events")]
    return [(*rng.choice(sites), rng.choice([None, 0, 1, 2]))
            for _ in range(n)]


def _plans(pkg: str, seed: int, calls, arm_at=None):
    faults = importlib.import_module(f"{pkg}.testing.faults")
    sched = faults.FaultSchedule.from_dicts(_RULES, seed=seed)
    out = []
    for i, (site, method, sid) in enumerate(calls):
        if arm_at is not None and i == arm_at[0]:
            sched.disarm()
        if arm_at is not None and i == arm_at[1]:
            sched.arm()
        plan = sched.plan(site, method, sid)
        out.append(None if plan is None else (
            plan.action, type(plan.exc).__name__ if plan.exc else None,
            str(plan.exc) if plan.exc else None, plan.latency_s))
    return out, sched.snapshot(), sched.injected_total()


@pytest.mark.parametrize("seed", [0, 1234, 99991])
def test_fault_schedule_plans_match_reference(seed):
    calls = _call_sequence(seed)
    for arm_at in (None, (100, 250)):
        ref = _plans("cadence_tpu", seed, calls, arm_at)
        port = _plans("cadence_tpu_torch", seed, calls, arm_at)
        assert port == ref
        assert ref[2] > 0


def test_fault_client_and_hooks_match_reference():
    """The fault client's shard resolution and ``hook``'s bound site
    give the same plans, the same raised classes and the same landed
    torn writes in both packages."""
    def drive(pkg):
        faults = importlib.import_module(f"{pkg}.testing.faults")
        sched = faults.FaultSchedule.from_dicts([
            {"site": "persistence.shard", "shard_id": 2,
             "probability": 0.5, "action": "torn_write"},
            {"site": "queue.timer-3", "probability": 0.5,
             "error": "ShardOwnershipLostError"},
        ], seed=7)

        class Store:
            landed = 0

            def update_shard(self, info):
                Store.landed += 1
                return "ok"

        client = faults.FaultInjectionClient(Store(), sched, manager="shard")
        fire = faults.hook(sched, "queue.timer-3", shard_id=3)
        seen = []
        for i in range(40):
            rec = types.SimpleNamespace(shard_id=i % 4)
            for call in (lambda: client.update_shard(rec),
                         lambda: fire("4")):
                try:
                    seen.append(call())
                except Exception as e:
                    seen.append((type(e).__name__,
                                 getattr(e, "shard_id", None)))
        return seen, Store.landed, sched.snapshot()

    assert drive("cadence_tpu_torch") == drive("cadence_tpu")


def test_chaos_config_builds_port_schedule():
    from cadence_tpu_torch.config.static import ChaosConfig
    from cadence_tpu_torch.testing.faults import FaultSchedule

    sched = ChaosConfig(enabled=True, seed=5, rules=_RULES).build_schedule()
    assert isinstance(sched, FaultSchedule)
    assert sched.armed and len(sched.rules) == len(_RULES)
    assert ChaosConfig(enabled=False, rules=_RULES).build_schedule() is None


def test_lock_order_clean_against_port_baseline():
    """Pass 3 over the port's tree: every finding is accepted by the
    port's baseline, every baseline entry matches a finding and carries
    a justification, and every anchor names a port module."""
    from cadence_tpu_torch.analysis import lock_order
    from cadence_tpu_torch.analysis.findings import Baseline
    from cadence_tpu_torch.testing.race_witness import (
        DEFAULT_BASELINE,
        DEFAULT_WAIVERS,
    )

    findings = lock_order.run(str(REPO))
    assert findings
    baseline = Baseline.load(str(REPO / DEFAULT_BASELINE))
    new, accepted, stale = baseline.split(findings)
    assert new == [], "\n".join(f.format() for f in new)
    assert stale == []
    waivers = Baseline.load(str(REPO / DEFAULT_WAIVERS))
    for e in baseline.entries + waivers.entries:
        assert e.justification
        assert "cadence_tpu_torch/" in e.anchor
        assert "cadence_tpu/" not in e.anchor
    # the scan covers the port's tree only
    graph = lock_order.build_graph(str(REPO))
    assert graph.locks and all(
        k.startswith("cadence_tpu_torch/") for k in graph.locks)

