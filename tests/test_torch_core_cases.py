"""The reference's host-core tests, run on the port.

Each source below is exec'd with every ``cadence_tpu.`` import taken from
``cadence_tpu_torch`` and every entry point that takes a device
(``HistoryService``, ``StateRebuilder``, ``ResidentEngine``, ``Onebox``,
``start_services``, the ``replay_packed`` facade) bound to
``device="cpu"``, at module level and, where a test imports one in its
body, by a rewrite of that import's call (``_IN_BODY``). Each of its test
functions and test methods is one parametrised case here, once per value
of its parametrised fixture or ``parametrize`` mark, its fixtures set up
and torn down around it. The two cases the reference marks slow (for its
JAX compiles) take seconds on the port and run unmarked.

The fixture modules the sources import are exec'd on the port the same
way and registered under ``tests.port_<name>``: ``test_service_plane``
(``Box``), ``test_frontend`` (``FrontendBox``, the same registration as
``test_torch_worker_cases``) and ``test_replay_differential``
(``oracle_replay``). ``test_serving``'s demo subprocess runs the port's
``testing.serve_demo`` with ``--device cpu``.

Left out, with its reason (``LEFT_OUT``): the two ``presence_masks``
cases of ``test_native_sidecar``. Not exec'd at all: ``test_dispatch``
(it imports jax) and ``test_fuzz_differential`` (it imports the
reference's JAX-only names).
"""

from __future__ import annotations

import ast
import functools
import inspect
import re
import sys
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

# module -> the test names taken from it (None: every test)
SOURCES = {
    "test_history_engine": None,
    "test_active_transaction": None,
    "test_query_reset": None,
    "test_queue_ack": None,
    "test_concurrency_stress": None,
    "test_core_fsm": None,
    "test_cron": None,
    "test_events_cache": None,
    "test_task_writer_gc": None,
    "test_cluster_messaging": None,
    "test_task_processor": None,
    "test_queue_metrics": None,
    "test_serving": None,
    "test_rebuilder": None,
    "test_workloads": None,
    "test_native_sidecar": None,
}
# what is not run on the port, and why
_NO_PRESENCE = ("presence_masks feeds only the reference's Pallas kernel; "
                "the port dropped it with PackedHistories.presence "
                "(tests/test_torch_native.py)")
LEFT_OUT = {
    "test_native_sidecar::TestScatter::test_presence_matches_python":
        _NO_PRESENCE,
    "test_native_sidecar::TestScatter::test_presence_rejects_wrong_width":
        _NO_PRESENCE,
}
# fixture modules the sources import, exec'd on the port
_FIXTURE_MODULES = {
    "tests.test_service_plane": "tests.port_test_service_plane",
    "tests.test_frontend": "tests.port_test_frontend",
    "test_replay_differential": "tests.port_test_replay_differential",
}
# entry points imported inside a test body, and how each reaches the CPU:
# (old, new) rewrites of the source, each of which must apply
_IN_BODY = {
    "test_serving": (
        ("rb = StateRebuilder(\n                bundle.history, serving=engine,"
         " metrics=scope\n            )",
         "rb = StateRebuilder(\n                bundle.history, serving=engine,"
         ' metrics=scope, device="cpu"\n            )'),
        ("= StateRebuilder(\n                bundle.history\n            )",
         '= StateRebuilder(\n                bundle.history, device="cpu"\n'
         "            )"),
        ("eng = cfg.serving.build_engine()",
         'eng = cfg.serving.build_engine(device="cpu")'),
        ('cfg, services=["history", "matching", "frontend"]\n',
         'cfg, services=["history", "matching", "frontend"], device="cpu"\n'),
        ("num_shards=2, checkpoints=True, serving=True\n",
         'num_shards=2, checkpoints=True, serving=True, device="cpu"\n'),
        ("Onebox(num_shards=1, start_worker=False)",
         'Onebox(num_shards=1, start_worker=False, device="cpu")'),
        # the demo's child process: the port's demo on the CPU
        ('"--quiet", "--requests", "12", "--qps", "120"]',
         '"--quiet", "--requests", "12", "--qps", "120", '
         '"--device", "cpu"]'),
    ),
    "test_events_cache": (
        ('_monitor("ec-host"))', '_monitor("ec-host"), device="cpu")'),
        ('_monitor("m-host"))', '_monitor("m-host"), device="cpu")'),
    ),
}
_DEVICE_BOUND = ("HistoryService", "StateRebuilder", "ResidentEngine",
                 "Onebox", "start_services", "replay_packed")


def _port_source(src: str) -> str:
    for ref, port in _FIXTURE_MODULES.items():
        src = re.sub(rf"\bfrom {re.escape(ref)} import",
                     f"from {port} import", src)
    return re.sub(r"\bcadence_tpu\.", "cadence_tpu_torch.", src)


def _bind_devices(ns: dict) -> None:
    for name in _DEVICE_BOUND:
        if name in ns:
            ns[name] = functools.partial(ns[name], device="cpu")


def _exec(name: str, src: str, module: str) -> dict:
    ns = {"__name__": module, "__file__": str(REPO / "tests" / f"{name}.py")}
    exec(compile(src, ns["__file__"], "exec"), ns)
    _bind_devices(ns)
    return ns


def _fixture_module(module: str) -> types.ModuleType:
    """A fixture module exec'd on the port and registered under its port
    name, once per process."""
    mod = sys.modules.get(module)
    if mod is None:
        name = module.rsplit(".port_", 1)[1]
        src = _port_source((REPO / "tests" / f"{name}.py").read_text())
        mod = types.ModuleType(module)
        mod.__dict__.update(_exec(name, src, module))
        sys.modules[module] = mod
    return mod


def _load(name: str) -> dict:
    src = (REPO / "tests" / f"{name}.py").read_text()
    for ref, port in _FIXTURE_MODULES.items():
        if re.search(rf"\bfrom {re.escape(ref)} import", src):
            _fixture_module(port)
    for old, new in _IN_BODY.get(name, ()):
        assert old in src, (name, old)
        src = src.replace(old, new)
    return _exec(name, _port_source(src), f"tests.port_{name}")


def _params(ns: dict, fn) -> list:
    """The parameter sets of a test: one per value of its parametrised
    fixture or of its ``parametrize`` mark ({} for a plain test)."""
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "parametrize":
            arg, values = mark.args
            return [{"mark": (arg, v), "id": str(v)} for v in values]
    for p in inspect.signature(fn).parameters:
        fixture = ns.get(p)
        marker = getattr(fixture, "_fixture_function_marker", None)
        if marker is not None and marker.params:
            return [{"fixture_param": v, "id": str(v)}
                    for v in marker.params]
    return [{}]


def _tests(ns: dict):
    """(case name stem, class name or None, test name, test function)."""
    for attr, obj in ns.items():
        if getattr(obj, "__module__", None) != ns["__name__"]:
            continue
        if attr.startswith("test_") and callable(obj):
            yield attr, None, attr, obj
        elif attr.startswith("Test") and inspect.isclass(obj):
            for meth in dir(obj):
                if meth.startswith("test_"):
                    yield f"{attr}::{meth}", attr, meth, getattr(obj, meth)


def _cases() -> dict:
    out = {}
    for name in SOURCES:
        ns = _load(name)
        for stem, cls, meth, fn in _tests(ns):
            if (f"{name}::{stem}" in LEFT_OUT
                    or f"{name}::{cls}" in LEFT_OUT):
                continue
            for p in _params(ns, fn):
                key = f"{name}::{stem}" + (f"[{p['id']}]" if p else "")
                out[key] = (ns, cls, meth, p)
    return out


_ALL = _cases()
CASES = sorted(_ALL)


def test_reference_cases_found():
    """Every test of the sources is a case here, save those named in
    ``LEFT_OUT``; the fixture modules are the port's."""
    per_file = {}
    for key in CASES:
        per_file[key.split("::")[0]] = per_file.get(key.split("::")[0],
                                                    0) + 1
    assert per_file == {
        "test_history_engine": 15,
        "test_active_transaction": 13,
        "test_query_reset": 10,
        "test_queue_ack": 7,
        "test_concurrency_stress": 3,
        "test_core_fsm": 16,
        "test_cron": 8,
        "test_events_cache": 5,
        "test_task_writer_gc": 4,
        "test_cluster_messaging": 11,
        "test_task_processor": 4,
        "test_queue_metrics": 1,
        "test_serving": 40,
        "test_rebuilder": 4,
        "test_workloads": 2,
        "test_native_sidecar": 12,
    }
    for module in _FIXTURE_MODULES.values():
        assert _fixture_module(module).__name__ == module
    box = _fixture_module("tests.port_test_service_plane")
    assert box.HistoryService.func.__module__ == \
        "cadence_tpu_torch.runtime.service"


class _Request:
    """pytest's ``request`` as a parametrised fixture reads it."""

    def __init__(self, param):
        self.param = param


def _monkeypatch(stack: list):
    mp = pytest.MonkeyPatch()
    stack.append(mp)
    return mp


def _arg(ns: dict, p: str, params: dict, tmp_path, stack: list):
    """The value of parameter ``p``: pytest's own fixtures, else the
    module's fixture ``p`` (its own parameters first; its generator goes
    on ``stack`` for the teardown)."""
    if p == "tmp_path":
        return tmp_path
    if p == "request":
        return _Request(params.get("fixture_param"))
    if p == "monkeypatch":
        return _monkeypatch(stack)
    fn = ns[p]._get_wrapped_function()
    out = fn(*[_arg(ns, q, params, tmp_path, stack)
               for q in inspect.signature(fn).parameters])
    if inspect.isgenerator(out):
        stack.append(out)
        return next(out)
    return out


def _teardown(stack: list) -> None:
    for item in reversed(stack):
        if isinstance(item, pytest.MonkeyPatch):
            item.undo()
        else:
            for _ in item:
                pass


def _autouse(ns: dict):
    return [attr for attr, obj in ns.items()
            if getattr(getattr(obj, "_fixture_function_marker", None),
                       "autouse", False)]


@pytest.mark.parametrize("case", CASES)
def test_reference_core_case_on_port(case, tmp_path):
    ns, cls, name, params = _ALL[case]
    fn = getattr(ns[cls](), name) if cls is not None else ns[name]
    stack, args = [], []
    try:
        for attr in _autouse(ns):
            _arg(ns, attr, params, tmp_path, stack)
        for p in inspect.signature(fn).parameters:
            if "mark" in params and p == params["mark"][0]:
                args.append(params["mark"][1])
            else:
                args.append(_arg(ns, p, params, tmp_path, stack))
        fn(*args)
    finally:
        _teardown(stack)
