"""The reference's tests of the static-analysis gate, run on the port.

``tests/test_static_analysis.py`` is exec'd with every ``cadence_tpu.``
import taken from ``cadence_tpu_torch`` and every ``cadence_tpu/`` path it
names read as the port's; the baseline it reads
(``config/lint_baseline.json``) is bound to the port's accepted findings:
``cadence_tpu_torch/analysis/lint_baseline.json`` where a case passes one
file to the CLI, both of the port's files (``load_baselines``) where a
case gates the whole tree; the calls that probe the FSM step
(``transition_surface.build`` and ``emit_matrix``, ``run_all``), whose
default device on the port is the card, are given ``device="cpu"``. Each
of its test functions and test methods
is one parametrised case here, its fixtures (module-level, and the ones
its class defines) set up around it (a fixture of module or class scope
once per file), pytest's own fixtures (``tmp_path``, ``monkeypatch``)
taken from this test's ``request``.

Left out, each with its reason (``LEFT_OUT``): the cases whose fixtures
are JAX programs (``jax.jit`` roots, a ``make_jaxpr`` trace, Pallas
kernel bodies) and the retired ``JIT-SHAPE-ROUND`` rule's. Each has its
counterpart for the port's rules in ``tests/test_torch_analysis.py``.
"""

from __future__ import annotations

import inspect
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SOURCE = "test_static_analysis"

# what is not run on the port, and why (counterparts: test_torch_analysis)
_JAX_FIXTURE = ("its fixture is a JAX program ({}); the port's rule is "
                "held by test_torch_analysis::{}")
LEFT_OUT = {
    "TestJitHazards::test_host_sync_fixtures_fire": _JAX_FIXTURE.format(
        "a jax.jit root", "test_host_sync_fixtures_fire"),
    "TestJitHazards::test_py_branch_fixture_fires": _JAX_FIXTURE.format(
        "a jax.jit root", "test_tensor_branch_fires"),
    "TestJitHazards::test_none_checks_stay_legal": _JAX_FIXTURE.format(
        "a jax.jit root", "test_none_checks_stay_legal"),
    "TestJitHazards::test_traced_function_discovery": _JAX_FIXTURE.format(
        "jax.jit discovery", "test_launch_function_discovery"),
    "TestJitHazards::test_dtype_widen_fires_on_float": _JAX_FIXTURE.format(
        "a make_jaxpr trace", "test_mutation_float_promotion_fires"),
    "TestJitHazards::test_pallas_int16_arith_fixture_fires":
        _JAX_FIXTURE.format("a Pallas kernel",
                            "test_cuda_int16_accumulate_fires"),
    "TestJitHazards::test_pallas_int16_widened_passes": _JAX_FIXTURE.format(
        "a Pallas kernel", "test_cuda_int16_widened_passes"),
    "TestJitHazards::test_pallas_int16_renarrowed_after_widen_fires":
        _JAX_FIXTURE.format("a Pallas kernel",
                            "test_cuda_int16_renarrowed_fires"),
    "TestJitHazards::test_pallas_int16_rewiden_after_narrow_passes":
        _JAX_FIXTURE.format("a Pallas kernel",
                            "test_cuda_int16_rewidened_passes"),
    "TestJitHazards::test_pallas_int16_outside_kernel_ignored":
        _JAX_FIXTURE.format("a Pallas kernel",
                            "test_cuda_int16_plain_copy_passes"),
    "TestJitHazards::test_unrounded_shape_fixture_fires":
        "JIT-SHAPE-ROUND is retired on the port (eager torch compiles "
        "nothing per shape); test_torch_analysis::"
        "test_shape_round_is_retired",
    "TestJitHazards::test_rounded_shape_passes":
        "JIT-SHAPE-ROUND is retired on the port; test_torch_analysis::"
        "test_shape_round_is_retired",
}
_LINT_BASELINE = 'os.path.join(REPO_ROOT, "config", "lint_baseline.json")'
_PORT_LINT_BASELINE = ('os.path.join(REPO_ROOT, "cadence_tpu_torch", '
                       '"analysis", "lint_baseline.json")')
_GATE_BASELINE = f'''Baseline.load(
            {_LINT_BASELINE}
        )'''
# the reference's calls that probe the FSM step, each given the CPU
_ON_CPU = (
    ("transition_surface.build(REPO_ROOT)",
     'transition_surface.build(REPO_ROOT, device="cpu")'),
    ("transition_surface.emit_matrix(REPO_ROOT, path)",
     'transition_surface.emit_matrix(REPO_ROOT, path, device="cpu")'),
    ("run_all(REPO_ROOT)", 'run_all(REPO_ROOT, device="cpu")'),
)


def port_source(src: str) -> str:
    """The reference test module's source, on the port."""
    assert src.count(_GATE_BASELINE) == 1
    src = src.replace(
        _GATE_BASELINE,
        '__import__("cadence_tpu_torch.analysis", '
        'fromlist=["load_baselines"]).load_baselines()')
    assert src.count(_LINT_BASELINE) == 1
    src = src.replace(_LINT_BASELINE, _PORT_LINT_BASELINE)
    for call, on_cpu in _ON_CPU:
        assert src.count(call) == 1, call
        src = src.replace(call, on_cpu)
    src = src.replace("cadence_tpu/", "cadence_tpu_torch/")
    return re.sub(r"\bcadence_tpu\.", "cadence_tpu_torch.", src)


def _load() -> dict:
    path = REPO / "tests" / f"{SOURCE}.py"
    ns = {"__name__": f"tests.port_{SOURCE}", "__file__": str(path)}
    exec(compile(port_source(path.read_text()), str(path), "exec"), ns)
    return ns


def _tests(ns: dict):
    """(case name, class name or None, test name)."""
    for attr, obj in ns.items():
        if getattr(obj, "__module__", None) != ns["__name__"]:
            continue
        if attr.startswith("test_") and callable(obj):
            yield attr, None, attr
        elif attr.startswith("Test") and inspect.isclass(obj):
            for meth in dir(obj):
                if meth.startswith("test_"):
                    yield f"{attr}::{meth}", attr, meth


NS = _load()
CASES = sorted(name for name, _, _ in _tests(NS) if name not in LEFT_OUT)
_WHERE = {name: (cls, meth) for name, cls, meth in _tests(NS)}
# values of module- and class-scoped fixtures, made once
_SHARED: dict = {}


def test_reference_cases_found():
    """Every test of the source is a case here or named in ``LEFT_OUT``;
    the module under test is the port's."""
    assert set(CASES) | set(LEFT_OUT) == set(_WHERE)
    assert not set(CASES) & set(LEFT_OUT)
    assert len(_WHERE) == 95 and len(CASES) == 83
    assert NS["transition_surface"].__name__ == \
        "cadence_tpu_torch.analysis.transition_surface"
    assert NS["run_all"].__module__ == "cadence_tpu_torch.analysis"
    src = port_source((REPO / "tests" / f"{SOURCE}.py").read_text())
    assert '"config", "lint_baseline.json"' not in src


def _marker(obj):
    return getattr(obj, "_fixture_function_marker", None)


def _fixture(name: str, inst, request, stack: list):
    """The value of fixture ``name``: the case's class's or the module's
    own (a generator's teardown on ``stack``), else pytest's."""
    obj = getattr(type(inst), name, None) if inst is not None else None
    if _marker(obj) is None:
        obj = NS.get(name)
    if _marker(obj) is None:
        return request.getfixturevalue(name)
    scope = _marker(obj).scope
    key = (type(inst).__name__ if scope == "class" else None, name)
    if scope != "function" and key in _SHARED:
        return _SHARED[key]
    fn = obj._get_wrapped_function()
    params = list(inspect.signature(fn).parameters)
    args = [inst] if params[:1] == ["self"] else []
    args += [_fixture(p, inst, request, stack)
             for p in params[len(args):]]
    out = fn(*args)
    if inspect.isgenerator(out):
        stack.append(out)
        out = next(out)
    if scope != "function":
        _SHARED[key] = out
    return out


@pytest.mark.parametrize("case", CASES)
def test_reference_analysis_case_on_port(case, request):
    cls, meth = _WHERE[case]
    inst = NS[cls]() if cls is not None else None
    fn = getattr(inst, meth) if inst is not None else NS[meth]
    stack: list = []
    try:
        args = [_fixture(p, inst, request, stack)
                for p in inspect.signature(fn).parameters]
        fn(*args)
    finally:
        for gen in reversed(stack):
            for _ in gen:
                pass
