"""The reference's topology tests, run on the port.

Each of ``tests/test_parallel_queue.py``, ``test_resharding.py`` and
``test_autopilot.py`` is exec'd with every ``cadence_tpu.`` import taken
from ``cadence_tpu_torch`` and every constructor that takes a device
(``HistoryService``, ``StateRebuilder``, ``ReplicatorQueueProcessor``,
``ReshardCoordinator``, ``ResidentEngine``) bound to ``device="cpu"``;
each of its test functions and test methods is one parametrised case
here, its fixtures set up and torn down around it.

``test_autopilot.py``'s topology cases build the reference's ``ChaosBox``
(``tests/test_chaos_recovery.py``). That module is exec'd on the port as
well, once, by ``tests/test_torch_chaos_cases.py``'s ``chaos_module``, and
the cases import ``ChaosBox`` from that port copy, never from the
reference. The cases that build fault schedules run on the port's.
"""

from __future__ import annotations

import functools
import inspect
import re
from pathlib import Path

import pytest

from tests.test_torch_chaos_cases import CHAOS_MODULE, chaos_module

REPO = Path(__file__).resolve().parents[1]

SOURCES = ("test_parallel_queue", "test_resharding", "test_autopilot")
# the cases that construct a FaultSchedule: collected since the port
# has fault schedules (the slow one stays out with the slow cases)
FAULT_CASES = {
    "test_resharding::TestCoordinator::"
    "test_failed_install_rolls_back_to_old_epoch",
    "test_resharding::TestCoordinator::"
    "test_failure_after_fence_rebuilds_unfenced_handles",
    "test_resharding::TestCoordinator::"
    "test_aborted_split_target_id_never_reused",
    "test_autopilot::TestAutopilotChaos::"
    "test_write_fault_storm_during_actuation_byte_identical",
    "test_autopilot::TestAutopilotChaos::"
    "test_failed_reshard_plan_backs_off_never_hot_retries",
}
_DEVICE_BOUND = ("HistoryService", "StateRebuilder",
                 "ReplicatorQueueProcessor", "ReshardCoordinator",
                 "ResidentEngine")
def _bind_devices(ns: dict) -> None:
    for cls in _DEVICE_BOUND:
        if cls in ns:
            ns[cls] = functools.partial(ns[cls], device="cpu")


def _port_source(src: str) -> str:
    src = src.replace("from tests.test_chaos_recovery import",
                      f"from {CHAOS_MODULE} import")
    return re.sub(r"\bcadence_tpu\.", "cadence_tpu_torch.", src)


def _exec(name: str, src: str, module: str) -> dict:
    path = REPO / "tests" / f"{name}.py"
    ns = {"__name__": module}
    exec(compile(src, str(path), "exec"), ns)
    _bind_devices(ns)
    return ns


class _DeviceBinder:
    """Binds the device-taking constructors that a case imports inside
    its body (``from cadence_tpu_torch.serving import ResidentEngine``)
    to the CPU for the duration of the case."""

    def __enter__(self):
        import importlib

        self._saved = []
        for mod_name, cls in (
                ("cadence_tpu_torch.serving", "ResidentEngine"),
                ("cadence_tpu_torch.runtime.resharding",
                 "ReshardCoordinator"),
                ("cadence_tpu_torch.runtime.replication.rebuilder",
                 "StateRebuilder")):
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, cls)
            self._saved.append((mod, cls, orig))
            setattr(mod, cls, functools.partial(orig, device="cpu"))
        return self

    def __exit__(self, *exc):
        for mod, cls, orig in self._saved:
            setattr(mod, cls, orig)


def _load(name: str) -> dict:
    """The reference test module ``name`` exec'd on the port into a fresh
    namespace."""
    if "test_chaos_recovery" in (REPO / "tests" / f"{name}.py").read_text():
        chaos_module()
    src = _port_source((REPO / "tests" / f"{name}.py").read_text())
    return _exec(name, src, f"tests.port_{name}")


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


def _all_cases(name: str) -> set:
    """Every test of a reference file, slow-marked ones included."""
    ns = _load(name)
    found = set()
    for attr, obj in ns.items():
        if getattr(obj, "__module__", None) != ns["__name__"]:
            continue
        if attr.startswith("test_") and callable(obj):
            found.add(f"{name}::{attr}")
        elif attr.startswith("Test") and inspect.isclass(obj):
            found |= {f"{name}::{attr}::{m}" for m in dir(obj)
                      if m.startswith("test_")}
    return found


_ALL = _cases()
CASES = sorted(_ALL)


def test_reference_cases_found():
    every = {n: _all_cases(n) for n in SOURCES}
    assert {n: len(v) for n, v in every.items()} == {
        "test_parallel_queue": 19,
        "test_resharding": 22,
        "test_autopilot": 38,
    }
    # test_autopilot's two slow-marked chaos cases are not collected
    # (tier-1 runs -m 'not slow'); every other case is, the fault cases
    # included
    slow = set().union(*every.values()) - set(_ALL)
    assert slow == {
        "test_autopilot::TestAutopilotChaos::"
        "test_diurnal_sweep_rates_track_traffic",
        "test_autopilot::TestAutopilotChaos::"
        "test_write_fault_storm_during_actuation_byte_identical",
    }
    assert FAULT_CASES - slow <= set(CASES)
    assert len(CASES) == 19 + 22 + 38 - len(slow)
    # the autopilot cases build the port's ChaosBox, not the reference's
    chaos = chaos_module()
    assert chaos.ChaosBox.__module__ == CHAOS_MODULE
    assert chaos.HistoryService.func.__module__ == \
        "cadence_tpu_torch.runtime.service"


def _call_hook(hook, method) -> None:
    """pytest's xunit hook: ``setup_method(self[, method])``."""
    if inspect.signature(hook).parameters:
        hook(method)
    else:
        hook()


@pytest.mark.parametrize("case", CASES)
def test_reference_topology_case_on_port(case, tmp_path):
    ns, cls, name = _ALL[case]
    with _DeviceBinder():
        obj = None
        if cls is not None:
            obj = ns[cls]()
            fn = getattr(obj, name)
            if hasattr(obj, "setup_method"):
                _call_hook(obj.setup_method, fn)
        else:
            fn = ns[name]
        params = list(inspect.signature(fn).parameters)
        fixtures = []
        args = []
        for p in params:
            if p == "tmp_path":
                args.append(tmp_path)
                continue
            gen = ns[p]._get_wrapped_function()()
            fixtures.append(gen)
            args.append(next(gen))
        try:
            fn(*args)
        finally:
            for gen in reversed(fixtures):
                for _ in gen:
                    pass
            if obj is not None and hasattr(obj, "teardown_method"):
                _call_hook(obj.teardown_method, fn)
