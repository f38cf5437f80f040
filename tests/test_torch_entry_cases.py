"""The reference's tests of the server's entry points, run on the port.

Each source below is exec'd with every ``cadence_tpu.`` import taken from
``cadence_tpu_torch`` (the gRPC service names ``cadence_tpu.Frontend``,
``cadence_tpu.History`` and ``cadence_tpu.Matching`` stay as they are:
they are the wire names of both packages) and every entry point that
takes a device (``HistoryService``, ``StateRebuilder``,
``ReplicatorQueueProcessor``, ``ResidentEngine``, ``Onebox``,
``start_services``, ``run_canary``) bound to ``device="cpu"``; each of its
test functions and test methods is one parametrised case here, its
fixtures (and the module's autouse fixtures) set up and torn down around
it, pytest's own fixtures (``tmp_path``, ``monkeypatch``, ``capsys``)
taken from this test's ``request``.

``test_two_process_plane.py``'s child process runs the port too: its
script is rewritten the same way and its ``HistoryService`` runs on
``device="cpu"``. ``test_xdc_grpc_transport.py`` imports the harness of
``test_xdc_replication.py``, which is exec'd on the port as well and
registered as ``tests.port_test_xdc_replication``.

The port's ``heap_top`` and the reference's share the process's one
``tracemalloc``: a case that started it stops it afterwards, so a later
reference case in the same worker still gets the "tracemalloc started"
reply to its first heap request.

``test_pprof.py``'s trace demo runs the port's
``testing/trace_demo`` in its child process with ``--device cpu``.

Left out, with its reason (``LEFT_OUT``): the ``setup_env`` half of
``test_environment_module_defaults``.
"""

from __future__ import annotations

import functools
import inspect
import re
import sys
import tracemalloc
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

# module -> the test names taken from it (None: every test); a name is a
# function, a class, or "Class::method"
SOURCES = {
    "test_rpc_onebox": None,
    "test_two_process_plane": None,
    "test_xdc_grpc_transport": None,
    "test_config_bootstrap": None,
    "test_cli_workflow": None,
    "test_cli_dlq": None,
    "test_canary": None,
    "test_pprof": None,
    "test_service_plane": ("test_routed_retry_predicate_branches",
                           "test_failure_detector_evicts_then_readmits"),
    "test_overload": (
        "TestTickPump::test_history_service_starts_and_drains_pump",
        "TestReviewRegressions::test_config_validate_does_not_import_serving",
    ),
    "test_frontend": (
        "TestPersistenceDecorators::test_metrics_and_rate_limit_wrappers",),
    "test_telemetry": (
        "TestTracer::test_wire_roundtrip_and_malformed_tolerance",
        "TestTracer::test_metadata_inject_extract",
        "TestOneboxTrace::test_rpc_hop_joins_the_same_trace",
        "TestOneboxTrace::test_rpc_without_context_roots_nothing_at_rate_zero",
        "test_telemetry_metrics_tuple_covers_everything_emitted",
        "TestDeviceTelemetry",
        "test_device_metrics_tuple_covers_everything_emitted",
    ),
    "test_utils": None,
}
# what is not run on the port, and why
LEFT_OUT = {
    "test_config_bootstrap::test_environment_module_defaults, setup_env":
        "setup_env pins JAX's platform and virtual mesh; the port's "
        "environment module carries no JAX knobs",
}
# the setup_env half of test_environment_module_defaults, cut out
_SETUP_ENV_HALF = '''
    env = {"XLA_FLAGS": ""}
    E.setup_env(env)
    assert env["JAX_PLATFORMS"] == "cpu"
    assert "device_count=8" in env["XLA_FLAGS"]
'''
# entry points imported inside a test body, and how each reaches the CPU:
# (old, new) rewrites of the source, each of which must apply
_IN_BODY = {
    "test_two_process_plane": (
        ("history = HistoryService(%(num_shards)d, bundle, domains, monitor)",
         'history = HistoryService(%(num_shards)d, bundle, domains, monitor, '
         'device="cpu")'),),
    "test_overload": (
        ('cfg, services=["history", "matching", "frontend"]',
         'cfg, services=["history", "matching", "frontend"], device="cpu"'),),
    "test_telemetry": (
        ('["cadence_tpu/utils/tracing.py"]',
         '["cadence_tpu_torch/utils/tracing.py"]'),
        ('["cadence_tpu/ops/dispatch.py"]',
         '["cadence_tpu_torch/ops/dispatch.py"]'),
        # the device-step telemetry: the port's replay_stream takes a
        # device where the reference's takes its kernel route
        ('kernel="xla"', 'device="cpu"'),
        ("d = DeviceDispatcher()", 'd = DeviceDispatcher(device="cpu")'),
        ("DeviceDispatcher(metrics=NOOP)",
         'DeviceDispatcher(metrics=NOOP, device="cpu")'),
    ),
    # the trace demo's child process: the port's demo on the CPU
    "test_pprof": (('"--quiet"],', '"--quiet", "--device", "cpu"],'),),
}
_DEVICE_BOUND = ("HistoryService", "StateRebuilder",
                 "ReplicatorQueueProcessor", "ResidentEngine", "Onebox",
                 "start_services", "run_canary")
_XDC_MODULE = "tests.port_test_xdc_replication"
_WIRE_NAMES = r"(?!(?:Frontend|History|Matching)\b)"


def _port_source(src: str) -> str:
    src = src.replace("from tests.test_xdc_replication import",
                      f"from {_XDC_MODULE} import")
    return re.sub(rf"\bcadence_tpu\.{_WIRE_NAMES}", "cadence_tpu_torch.",
                  src)


def _exec(name: str, src: str, module: str) -> dict:
    path = str(REPO / "tests" / f"{name}.py")
    ns = {"__name__": module, "__file__": path}
    exec(compile(src, path, "exec"), ns)
    for entry in _DEVICE_BOUND:
        if entry in ns:
            ns[entry] = functools.partial(ns[entry], device="cpu")
    return ns


def _xdc_module() -> types.ModuleType:
    """``tests/test_xdc_replication.py`` exec'd on the port, registered as
    a module so ``test_xdc_grpc_transport.py``'s import finds its
    ``Cluster``."""
    mod = sys.modules.get(_XDC_MODULE)
    if mod is None:
        name = "test_xdc_replication"
        src = _port_source((REPO / "tests" / f"{name}.py").read_text())
        mod = types.ModuleType(_XDC_MODULE)
        mod.__dict__.update(_exec(name, src, _XDC_MODULE))
        sys.modules[_XDC_MODULE] = mod
    return mod


def _load(name: str) -> dict:
    src = (REPO / "tests" / f"{name}.py").read_text()
    if "tests.test_xdc_replication" in src:
        _xdc_module()
    if name == "test_config_bootstrap":
        assert _SETUP_ENV_HALF in src
        src = src.replace(_SETUP_ENV_HALF, "\n")
    for old, new in _IN_BODY.get(name, ()):
        assert old in src, (name, old)
        src = src.replace(old, new)
    return _exec(name, _port_source(src), f"tests.port_{name}")


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
    for name, only in SOURCES.items():
        ns = _load(name)
        for stem, cls, meth, _ in _tests(ns):
            if f"{name}::{stem}" in LEFT_OUT:
                continue
            if only is not None and stem not in only and cls not in only:
                continue
            out[f"{name}::{stem}"] = (ns, cls, meth)
    return out


_ALL = _cases()
CASES = sorted(_ALL)


def test_reference_cases_found():
    """Every listed test of the sources is a case here, save those named
    in ``LEFT_OUT``; every case of ``test_config_bootstrap`` runs here and
    no longer in ``test_torch_worker_cases``."""
    per_file = {}
    for key in CASES:
        per_file[key.split("::")[0]] = per_file.get(key.split("::")[0],
                                                    0) + 1
    assert per_file == {
        "test_rpc_onebox": 5,
        "test_two_process_plane": 4,
        "test_xdc_grpc_transport": 6,
        "test_config_bootstrap": 11,
        "test_cli_workflow": 1,
        "test_cli_dlq": 5,
        "test_canary": 1,
        "test_pprof": 5,
        "test_service_plane": 2,
        "test_overload": 2,
        "test_frontend": 1,
        "test_telemetry": 9,
        "test_utils": 16,
    }
    # the transport cases build the port's Cluster, not the reference's
    xdc = _xdc_module()
    assert xdc.HistoryService.func.__module__ == \
        "cadence_tpu_torch.runtime.service"
    # the wire names survive the rewrite; the imports do not
    rpc = _ALL["test_telemetry::TestOneboxTrace::"
               "test_rpc_hop_joins_the_same_trace"][0]
    assert rpc["TRACER"].__module__ == "cadence_tpu_torch.utils.tracing"
    assert '"cadence_tpu.Frontend"' in _port_source(
        (REPO / "tests" / "test_telemetry.py").read_text())


def _is_fixture(obj) -> bool:
    return getattr(obj, "_fixture_function_marker", None) is not None


def _fixture(ns: dict, name: str, request, stack: list):
    """The value of fixture ``name``: the module's own (its fixtures set
    up first, its generator on ``stack`` for the teardown), else
    pytest's."""
    obj = ns.get(name)
    if not _is_fixture(obj):
        return request.getfixturevalue(name)
    fn = obj._get_wrapped_function()
    out = fn(*[_fixture(ns, p, request, stack)
               for p in inspect.signature(fn).parameters])
    if inspect.isgenerator(out):
        stack.append(out)
        return next(out)
    return out


def _teardown(stack: list) -> None:
    for gen in reversed(stack):
        for _ in gen:
            pass


@pytest.mark.parametrize("case", CASES)
def test_reference_entry_case_on_port(case, request):
    ns, cls, name = _ALL[case]
    fn = getattr(ns[cls](), name) if cls is not None else ns[name]
    stack = []
    tracing = tracemalloc.is_tracing()
    try:
        for attr, obj in ns.items():
            if _is_fixture(obj) and obj._fixture_function_marker.autouse:
                _fixture(ns, attr, request, stack)
        args = [_fixture(ns, p, request, stack)
                for p in inspect.signature(fn).parameters]
        fn(*args)
    finally:
        _teardown(stack)
        if not tracing and tracemalloc.is_tracing():
            tracemalloc.stop()


def test_pprof_case_leaves_tracemalloc_as_found(request):
    """The port's heap endpoint starts ``tracemalloc``; its case stops it
    again, or the reference's ``test_pprof::test_endpoints_serve`` in the
    same worker finds it tracing and its first heap request gets a
    snapshot in which "tracemalloc" may not appear."""
    before = tracemalloc.is_tracing()
    test_reference_entry_case_on_port("test_pprof::test_endpoints_serve",
                                      request)
    assert tracemalloc.is_tracing() == before
