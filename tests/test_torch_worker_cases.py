"""The reference's persistence, worker-daemon and archived-read tests, run
on the port.

Each of ``tests/test_persistence.py`` (both backends),
``test_worker_daemons.py``, ``test_archived_reads.py`` and
``test_checkpoint.py``'s store case is exec'd with every ``cadence_tpu.``
import taken from ``cadence_tpu_torch`` and every constructor that takes a
device (``HistoryService``, ``StateRebuilder``, ``Onebox``, and the
``replay_packed`` facade) bound to ``device="cpu"``; each of its test
functions and test methods is one parametrised case here, once per value
of its parametrised fixture or ``parametrize`` mark, its fixtures set up
and torn down around it. ``test_worker_daemons.py`` builds the
reference's ``FrontendBox`` (``tests/test_frontend.py``): that module is
exec'd on the port too and registered as ``tests.port_test_frontend``,
and the cases import it from there, never from the reference.

``test_config_bootstrap.py`` runs whole in ``test_torch_entry_cases.py``.
The torn-write case of ``test_persistence.py`` builds its fault schedule
from the port's ``testing.faults``.
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
    "test_persistence": None,
    "test_worker_daemons": None,
    "test_archived_reads": None,
    "test_checkpoint": ("test_store_roundtrip_order_and_prune",),
}
_DEVICE_BOUND = ("HistoryService", "StateRebuilder", "Onebox",
                 "replay_packed")
_FRONTEND_MODULE = "tests.port_test_frontend"


def _port_source(src: str) -> str:
    src = src.replace("from tests.test_frontend import",
                      f"from {_FRONTEND_MODULE} import")
    return re.sub(r"\bcadence_tpu\.", "cadence_tpu_torch.", src)


def _only(src: str, names) -> str:
    """The module without its tests but the named ones."""
    tree = ast.parse(src)
    keep = []
    for node in tree.body:
        name = getattr(node, "name", "")
        if name.startswith(("test_", "Test")) and name not in names:
            continue
        keep.append(node)
    lines = src.splitlines()

    def segment(node):
        # a definition's decorators belong to it
        first = min([node.lineno] + [d.lineno
                                     for d in getattr(node, "decorator_list",
                                                      [])])
        return "\n".join(lines[first - 1:node.end_lineno])

    return "\n\n".join(segment(n) for n in keep) + "\n"


def _bind_devices(ns: dict) -> None:
    for name in _DEVICE_BOUND:
        if name in ns:
            ns[name] = functools.partial(ns[name], device="cpu")


def _exec(name: str, src: str, module: str) -> dict:
    ns = {"__name__": module}
    exec(compile(src, str(REPO / "tests" / f"{name}.py"), "exec"), ns)
    _bind_devices(ns)
    return ns


def _frontend_module() -> types.ModuleType:
    """``tests/test_frontend.py`` exec'd on the port, registered as a
    module so ``test_worker_daemons.py``'s import finds its
    ``FrontendBox``."""
    mod = sys.modules.get(_FRONTEND_MODULE)
    if mod is None:
        src = _port_source((REPO / "tests" / "test_frontend.py").read_text())
        mod = types.ModuleType(_FRONTEND_MODULE)
        mod.__dict__.update(_exec("test_frontend", src, _FRONTEND_MODULE))
        sys.modules[_FRONTEND_MODULE] = mod
    return mod


def _load(name: str) -> dict:
    src = (REPO / "tests" / f"{name}.py").read_text()
    if "tests.test_frontend" in src:
        _frontend_module()
    only = SOURCES[name]
    if only is not None:
        src = _only(src, only)
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
            for p in _params(ns, fn):
                key = f"{name}::{stem}" + (f"[{p['id']}]" if p else "")
                out[key] = (ns, cls, meth, p)
    return out


_ALL = _cases()
CASES = sorted(_ALL)


def test_reference_cases_found():
    """Every test of the four sources is a case here, once per
    backend."""
    per_file = {}
    for key in CASES:
        per_file[key.split("::")[0]] = per_file.get(key.split("::")[0],
                                                    0) + 1
    assert per_file == {
        "test_persistence": 2 * 28,
        "test_worker_daemons": 8,
        "test_archived_reads": 5,
        "test_checkpoint": 2,
    }
    assert ("test_persistence::TestHistoryTrees::"
            "test_list_history_trees_both_backends[memory]") in _ALL
    assert ("test_persistence::TestReplicationProgress::"
            "test_torn_write_retry_reads_landed_blob_as_success[sqlite]"
            ) in _ALL
    # the daemons build the port's FrontendBox, not the reference's
    frontend = _frontend_module()
    assert frontend.FrontendBox.__module__ == _FRONTEND_MODULE
    assert frontend.HistoryService.func.__module__ == \
        "cadence_tpu_torch.runtime.service"


class _Request:
    """pytest's ``request`` as a parametrised fixture reads it."""

    def __init__(self, param):
        self.param = param


def _fixture(ns: dict, name: str, params: dict, tmp_path, stack: list):
    """Set up fixture ``name`` (its own fixtures first); its generator
    goes on ``stack`` for the teardown."""
    fn = ns[name]._get_wrapped_function()
    args = []
    for p in inspect.signature(fn).parameters:
        if p == "tmp_path":
            args.append(tmp_path)
        elif p == "request":
            args.append(_Request(params.get("fixture_param")))
        elif p == "monkeypatch":
            args.append(_monkeypatch(stack))
        else:
            args.append(_fixture(ns, p, params, tmp_path, stack))
    out = fn(*args)
    if inspect.isgenerator(out):
        stack.append(out)
        return next(out)
    return out


def _monkeypatch(stack: list):
    mp = pytest.MonkeyPatch()
    stack.append(mp)
    return mp


def _teardown(stack: list) -> None:
    for item in reversed(stack):
        if isinstance(item, pytest.MonkeyPatch):
            item.undo()
        else:
            for _ in item:
                pass


@pytest.mark.parametrize("case", CASES)
def test_reference_worker_case_on_port(case, tmp_path):
    ns, cls, name, params = _ALL[case]
    obj = None
    if cls is not None:
        obj = ns[cls]()
        fn = getattr(obj, name)
    else:
        fn = ns[name]
    stack, args = [], []
    try:
        for p in inspect.signature(fn).parameters:
            if "mark" in params and p == params["mark"][0]:
                args.append(params["mark"][1])
            elif p == "tmp_path":
                args.append(tmp_path)
            elif p == "monkeypatch":
                args.append(_monkeypatch(stack))
            else:
                args.append(_fixture(ns, p, params, tmp_path, stack))
        fn(*args)
    finally:
        _teardown(stack)
