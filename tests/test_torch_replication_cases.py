"""The reference's replication tests, run on the port.

Each of ``tests/test_xdc_replication.py``, ``test_ndc_conflict.py``,
``test_standby_queues.py``, ``test_replication_storm.py`` (its non-slow
cases), ``test_replication_transport.py`` and ``test_failover_drills.py``
is exec'd with every ``cadence_tpu.`` import taken from
``cadence_tpu_torch`` and every constructor that takes a device
(``HistoryService``, ``StateRebuilder``, ``ReplicatorQueueProcessor``)
bound to ``device="cpu"``; each of its test functions and test methods is
one parametrised case here, its fixture set up and torn down around it.
The case that builds a fault schedule (``FAULT_CASES``) runs on the port's
``testing.faults``.
"""

from __future__ import annotations

import functools
import inspect
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

SOURCES = (
    "test_xdc_replication",
    "test_ndc_conflict",
    "test_standby_queues",
    "test_replication_storm",
    "test_replication_transport",
    "test_failover_drills",
)
# the case that constructs a FaultSchedule
FAULT_CASES = {
    "test_failover_drills::TestFailoverRegionLossStorm::"
    "test_forced_failover_and_failback_byte_identical",
}
_DEVICE_BOUND = ("HistoryService", "StateRebuilder",
                 "ReplicatorQueueProcessor")


def _load(name: str, port: bool = True) -> dict:
    """The reference test module ``name`` exec'd into a fresh namespace:
    on the port (``port``) or, unchanged, on the reference package (a
    namespace of its own, so a caller may rebind its globals)."""
    path = REPO / "tests" / f"{name}.py"
    src = path.read_text()
    if not port:
        ns = {"__name__": f"tests.ref_{name}"}
        exec(compile(src, str(path), "exec"), ns)
        return ns
    src = re.sub(r"\bcadence_tpu\.", "cadence_tpu_torch.", src)
    # a device-taking constructor imported inside a function body
    src = src.replace("StateRebuilder(bundle.history, checkpoints=mgr)",
                      'StateRebuilder(bundle.history, checkpoints=mgr, '
                      'device="cpu")')
    ns = {"__name__": f"tests.port_{name}"}
    exec(compile(src, str(path), "exec"), ns)
    for cls in _DEVICE_BOUND:
        if cls in ns:
            ns[cls] = functools.partial(ns[cls], device="cpu")
    return ns


def _cases():
    out = {}
    for name in SOURCES:
        ns = _load(name)
        for attr, obj in ns.items():
            if getattr(obj, "__module__", None) != ns["__name__"]:
                continue
            marks = getattr(obj, "pytestmark", [])
            if any(m.name == "slow" for m in marks):
                continue
            if attr.startswith("test_") and callable(obj):
                out[f"{name}::{attr}"] = (ns, None, attr)
            elif attr.startswith("Test") and inspect.isclass(obj):
                for meth in dir(obj):
                    fn = getattr(obj, meth)
                    if meth.startswith("test_") and not any(
                            m.name == "slow"
                            for m in getattr(fn, "pytestmark", [])):
                        out[f"{name}::{attr}::{meth}"] = (ns, attr, meth)
    return out


_ALL = _cases()
CASES = sorted(_ALL)


def test_reference_cases_found():
    per_file = {n: sum(k.startswith(n + "::") for k in _ALL)
                for n in SOURCES}
    assert per_file == {
        "test_xdc_replication": 8,
        "test_ndc_conflict": 6,
        "test_standby_queues": 7,
        "test_replication_storm": 2,
        "test_replication_transport": per_file["test_replication_transport"],
        "test_failover_drills": per_file["test_failover_drills"],
    }
    assert FAULT_CASES <= set(_ALL)


@pytest.mark.parametrize("case", CASES)
def test_reference_replication_case_on_port(case):
    ns, cls, name = _ALL[case]
    if cls is not None:
        obj = ns[cls]()
        getattr(obj, name)()
        return
    fn = ns[name]
    params = list(inspect.signature(fn).parameters)
    fixtures = []
    args = []
    for p in params:
        gen = ns[p]._get_wrapped_function()()
        fixtures.append(gen)
        args.append(next(gen))
    try:
        fn(*args)
    finally:
        for gen in reversed(fixtures):
            for _ in gen:
                pass
