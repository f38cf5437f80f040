"""The port's static-analysis gate held against the reference's, on the CPU.

Tolerance: exact everywhere. The probed kernel matrix must equal the
reference's traced one label for label; the oracle table, the surface
findings, the queue handler footprints and the conflict-matrix artifact
(every key but the gate's own ``ms_columns``) must be equal as data; every probe's output rows must be bit-equal
across the probe implementations.

* the kernel matrix: the port's ``kernel_matrix()`` (one probed step of
  ``replay_rows_plain`` per transition group) against the reference's
  ``kernel_matrix()`` (a ``make_jaxpr`` trace of ``replay_step_cols``
  per group): ``common``, ``common_ts`` and each group's ``types``,
  ``written`` and ``ts_cols``. A probe sees only writes that change a
  value, so a label the reference writes without ever changing it may
  differ; ``INVISIBLE_WRITES`` names each such label with its reason
  (none with the probe states of ``transition_surface``). Then the other
  probe implementations on the CPU (the kernel wrapper on int32 and on
  the int16 narrow stream, the packed route, the parallel-in-time
  replay), each against the plain one;
* the oracle table and ``diff_surface``'s findings against the
  reference's;
* the queue pass: the port's ``handler_footprints`` against the
  reference's pass run over the port's tree, and the
  ``--emit-conflict-matrix`` artifact against ``ensure_conflict_matrix``'s
  on every key but ``ms_columns``, which only the gate adds;
* the gate in a subprocess: ``--strict-stale --device cpu`` exits 0
  within a minute and loads neither ``jax`` nor ``cadence_tpu``; without
  ``--device`` it probes the card, and raises (exit 2) without one;
* mutations, each on a copy under ``tmp_path``: a write removed from and
  a write added to ``_step_plain``, int16 accumulation in a ``.cu``
  fixture and in a copy of the real kernel, a float promotion in the
  step, a ``.item()`` in a launch root — each fires its rule; and the
  port's counterparts of the reference cases ``test_torch_analysis_cases``
  leaves out.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from cadence_tpu_torch.analysis import jit_hazards as PJ
from cadence_tpu_torch.analysis import oracle_ast as PO
from cadence_tpu_torch.analysis import transition_surface as PT
from cadence_tpu_torch.ops import replay_cuda as RC

REPO = Path(__file__).resolve().parents[1]

# labels the reference traces as written for a group but that no probe
# can see change (a write of the value already there): {(group types,
# label): reason}. The probe states reach every branch, so none.
INVISIBLE_WRITES: dict = {}


def _read(pkg: str, rel: str) -> str:
    return (REPO / pkg / rel).read_text()


@pytest.fixture(scope="module")
def ref_surface():
    from cadence_tpu.analysis import transition_surface as RT

    return RT.build(str(REPO))


@pytest.fixture(scope="module")
def port_probe():
    rel = PO.extract_rel_ts_attrs(_read("cadence_tpu_torch", "ops/pack.py"))
    return PT.probe("replay_rows_plain", "cpu", rel), rel


# --------------------------------------------------------------------------
# (a) the probed matrix against the traced one
# --------------------------------------------------------------------------


def test_probed_matrix_equals_traced(ref_surface, port_probe):
    ref, _, _, ref_rel = ref_surface
    run, rel = port_probe
    got = run.matrix
    assert rel == ref_rel
    assert got.common == ref.common
    assert got.common_ts == ref.common_ts
    assert [g.types for g in got.groups] == [g.types for g in ref.groups]
    missed = set()
    for g, r in zip(got.groups, ref.groups):
        assert g.written <= r.written, (g.types, g.written - r.written)
        missed |= {(r.types, lab) for lab in r.written - g.written}
        assert g.ts_cols == r.ts_cols, g.types
    assert missed == set(INVISIBLE_WRITES)


def test_probe_reaches_every_branch():
    """The probe states hold what the traced-only writes need: an empty
    and a random state, a version history full and past capacity, a
    workflow in Created; the lanes cover every slot from -1 to past the
    widest table and a same and a new version."""
    caps = PT.probe_caps()
    states = PT._probe_states(caps, np.random.default_rng(0))
    lens = {int(s["vh_len"]) for s in states}
    cap_v = caps.max_version_items
    assert {0, 1, cap_v, cap_v + 3} <= lens
    assert any(int(s["exec_info"][RC.S.X_STATE]) == 0 for s in states[1:])
    ev, rows = PT.probe_inputs((0,), caps)
    slots = set(ev[0, RC.S.EV_SLOT].tolist())
    assert slots == set(range(-1, caps.max_activities + 1))
    assert rows.shape == (RC.RowMap(caps).rows_padded, ev.shape[2])


@pytest.mark.parametrize("impl", PT.IMPLS[1:])
def test_probe_implementations_agree_on_cpu(impl, port_probe):
    """Every probe implementation (on CPU tensors: the plain routes the
    kernels are held to on the card) gives the plain step's matrix and
    its output rows bit for bit."""
    from cadence_tpu_torch.ops.assoc import assoc_types
    from cadence_tpu_torch.ops.replay import TYPE_GROUPS

    base, rel = port_probe
    groups = None
    if impl == "replay_assoc[segscan]":
        groups = [g for g in TYPE_GROUPS
                  if all(int(t) in assoc_types() for t in g)]
        assert len(groups) == len(TYPE_GROUPS)
    got = PT.probe(impl, "cpu", rel, groups=groups)
    assert got.matrix == base.matrix
    assert got.outputs.keys() == base.outputs.keys()
    for key, out in got.outputs.items():
        np.testing.assert_array_equal(out, base.outputs[key], err_msg=str(key))


# --------------------------------------------------------------------------
# (b) the oracle table and the surface findings
# --------------------------------------------------------------------------


def test_oracle_table_and_surface_findings_equal(ref_surface):
    from cadence_tpu.analysis import transition_surface as RT

    ref_k, ref_o, ref_pack, _ = ref_surface
    k, o, pack, _ = PT.build(str(REPO), device="cpu")
    assert {n: dataclasses.asdict(e) for n, e in o.items()} == \
        {n: dataclasses.asdict(e) for n, e in ref_o.items()}
    assert pack == ref_pack
    got = PT.diff_surface(k, o, pack_handled=pack)
    want = RT.diff_surface(ref_k, ref_o, pack_handled=ref_pack)
    assert [(f.rule, f.anchor, f.message) for f in got] == \
        [(f.rule, f.anchor, f.message) for f in want]
    assert PT.check_ts_coverage(k) == RT.check_ts_coverage(ref_k) == []
    assert PT.check_assoc_coverage(k) == []
    # the findings are the three the port's baseline accepts
    base = json.loads(
        (REPO / "cadence_tpu_torch/analysis/lint_baseline.json").read_text())
    surface = {(e["rule"], e["anchor"]) for e in base["findings"]
               if e["rule"].startswith("SURFACE-")}
    assert {(f.rule, f.anchor) for f in got} == surface


# --------------------------------------------------------------------------
# (c) the queue pass and the conflict matrix
# --------------------------------------------------------------------------


def test_handler_footprints_equal_reference_pass_over_port():
    from cadence_tpu.analysis import queue_effects as RQ
    from cadence_tpu_torch.analysis import queue_effects as PQ

    got = PQ.handler_footprints(str(REPO))
    with tempfile.TemporaryDirectory(prefix="port_queue_effects_") as root:
        os.symlink(REPO / "cadence_tpu_torch",
                   os.path.join(root, "cadence_tpu"))
        want = RQ.handler_footprints(root)
    assert got.keys() == want.keys()
    for key, (rel, handler, fp) in got.items():
        w_rel, w_handler, w_fp = want[key]
        assert rel == "cadence_tpu_torch/" + w_rel.split("/", 1)[1], key
        assert handler == w_handler, key
        assert dataclasses.asdict(fp) == dataclasses.asdict(w_fp), key
    assert PQ.diff_footprints(got) == []


def test_emit_conflict_matrix_equals_ensure(tmp_path):
    from cadence_tpu_torch.analysis import artifact
    from cadence_tpu_torch.analysis.__main__ import main
    from cadence_tpu_torch.runtime.queues import parallel
    from cadence_tpu_torch.runtime.queues.effects import (
        CONFLICT_MATRIX_SCHEMA, footprints_fingerprint,
    )

    emitted = str(tmp_path / "emitted.json")
    ensured = str(tmp_path / "ensured.json")
    assert main(["--passes", "queue", "--emit-conflict-matrix", emitted,
                 "--strict-stale", "-q"]) == 0
    assert parallel.ensure_conflict_matrix(ensured) == ensured
    a = json.loads(Path(emitted).read_text())
    b = json.loads(Path(ensured).read_text())
    # the gate adds the AST-extracted ms_columns; every other key,
    # fingerprint included, is the runtime's document
    assert "ms_columns" not in b
    assert {k: v for k, v in a.items() if k != "ms_columns"} == b
    doc = artifact.load_artifact(emitted, kind=CONFLICT_MATRIX_SCHEMA)
    assert doc["fingerprint"] == footprints_fingerprint()
    assert "timers" in doc["ms_columns"]["timer:UserTimer"]["ms_reads"]


# --------------------------------------------------------------------------
# (d) the gate in a subprocess
# --------------------------------------------------------------------------

_GATE = """
import runpy, sys, time
sys.argv = ["cadence_tpu_torch.analysis", "--strict-stale", "--device", "cpu"]
t0 = time.monotonic()
try:
    runpy.run_module("cadence_tpu_torch.analysis", run_name="__main__",
                     alter_sys=True)
    rc = 0
except SystemExit as e:
    rc = e.code
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "cadence_tpu"))
print("GATE", rc, time.monotonic() - t0, loaded)
"""


def test_gate_exits_zero_without_jax():
    r = subprocess.run([sys.executable, "-c", _GATE], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("GATE")]
    assert r.returncode == 0 and line, r.stdout[-2000:] + r.stderr[-2000:]
    _, rc, wall, loaded = line[0].split(" ", 3)
    assert rc == "0", r.stdout[-3000:]
    assert loaded == "[]"
    assert float(wall) < 60.0
    assert "0 new, 0 stale" in r.stdout


def test_gate_on_cuda_needs_a_card():
    from cadence_tpu_torch.analysis.__main__ import main

    # the default device is the card, as for every entry point of the port
    want = 0 if torch.cuda.is_available() else 2
    assert main(["--passes", "surface", "--device", "cuda", "-q"]) == want
    assert main(["--passes", "surface", "-q"]) == want


# --------------------------------------------------------------------------
# (e) mutations
# --------------------------------------------------------------------------


def _mutated_step(tmp_path, old: str, new: str):
    """A copy of ``_step_plain`` with ``old`` replaced by ``new``, written
    to and loaded from ``tmp_path``."""
    src = textwrap.dedent(inspect.getsource(RC._step_plain))
    assert src.count(old) == 1, old
    path = tmp_path / "step_copy.py"
    path.write_text(src.replace(old, new))
    ns = dict(vars(RC))
    exec(compile(path.read_text(), str(path), "exec"), ns)
    return ns["_step_plain"]


def _surface_findings():
    k, o, pack, _ = PT.build(str(REPO), device="cpu")
    return {(f.rule, f.anchor) for f in PT.diff_surface(k, o, pack)}


def test_mutation_removed_write_fires(tmp_path, monkeypatch):
    step = _mutated_step(
        tmp_path,
        "wr(X + S.X_CANCEL_REQUESTED, m(E.WorkflowExecutionCancelRequested), 1)",
        "pass")
    monkeypatch.setattr(RC, "_step_plain", step)
    assert ("SURFACE-MISSING-WRITE",
            "surface:WorkflowExecutionCancelRequested:missing") in \
        _surface_findings()


def test_mutation_extra_write_fires(tmp_path, monkeypatch):
    step = _mutated_step(
        tmp_path,
        "    # ---- decision sub-FSM\n",
        "    wr(X + S.X_SIGNAL_COUNT, m(E.TimerStarted), 7)\n"
        "    # ---- decision sub-FSM\n")
    monkeypatch.setattr(RC, "_step_plain", step)
    assert ("SURFACE-EXTRA-WRITE", "surface:TimerStarted:extra") in \
        _surface_findings()
    k = PT.kernel_matrix()
    assert any(f.rule == "ASSOC-UNPROVEN" and "X_SIGNAL_COUNT" in f.message
               for f in PT.check_assoc_coverage(k))


def test_unmutated_step_is_clean():
    assert _surface_findings() == {
        ("SURFACE-EXTRA-WRITE", "surface:WorkflowExecutionStarted:extra"),
        ("SURFACE-MISSING-WRITE", "surface:DecisionTaskStarted:missing"),
        ("SURFACE-MISSING-WRITE", "surface:DecisionTaskCompleted:missing"),
    }
    assert PJ.check_step_dtypes() == []


def test_mutation_float_promotion_fires(tmp_path, monkeypatch):
    step = _mutated_step(
        tmp_path,
        "    # ---- decision sub-FSM\n",
        "    st[X + S.X_SIGNAL_COUNT] = (st[X + S.X_SIGNAL_COUNT] * 1.5).to(\n"
        "        torch.int32)\n"
        "    # ---- decision sub-FSM\n")
    monkeypatch.setattr(RC, "_step_plain", step)
    fs = PJ.check_step_dtypes()
    assert [(f.rule, f.anchor.rsplit(":", 1)[-1]) for f in fs] == [
        ("TORCH-DTYPE-WIDEN", "float32")]


def test_mutation_int64_leak_fires(tmp_path, monkeypatch):
    step = _mutated_step(
        tmp_path,
        "    # ---- decision sub-FSM\n",
        "    st[X + S.X_SIGNAL_COUNT] = (st[X + S.X_SIGNAL_COUNT].long()\n"
        "                                + 1).to(torch.int32)\n"
        "    # ---- decision sub-FSM\n")
    monkeypatch.setattr(RC, "_step_plain", step)
    assert [f.anchor.rsplit(":", 1)[-1] for f in PJ.check_step_dtypes()] \
        == ["int64"]


def test_mutation_item_in_launch_root_fires(tmp_path):
    rel = "cadence_tpu_torch/ops/replay_cuda.py"
    src = (REPO / rel).read_text()
    old = ("    CUDA tensors launch the FSM kernel on the current stream (counted in\n"
           "    ``replay_rows.launches``); CPU tensors run ``replay_rows_plain``.\"\"\"\n")
    assert src.count(old) == 1
    copy = tmp_path / "replay_cuda.py"
    copy.write_text(src.replace(
        old, old + "    _ = rows.sum().item()\n", 1))
    got = {f.anchor for f in PJ.lint_source(copy.read_text(), rel)}
    want = {f.anchor for f in PJ.lint_source(src, rel)}
    assert got - want == {f"{rel}:replay_rows:item"}


def _cuda(tmp_path, src: str):
    path = tmp_path / "fixture.cu"
    path.write_text(textwrap.dedent(src))
    return PJ.lint_cuda_source(path.read_text(), "fixture.cu")


def test_cuda_int16_accumulate_fires(tmp_path):
    fs = _cuda(tmp_path, """
        __global__ void acc_kernel(const int16_t* ev, int* out, int n) {
          int16_t acc = 0;
          for (int i = 0; i < n; ++i) acc += ev[i];
          out[0] = acc;
        }
    """)
    assert fs and {f.rule for f in fs} == {"CUDA-INT16-ARITH"}
    assert all(f.anchor.startswith("fixture.cu:acc_kernel:int16#")
               for f in fs)


def test_cuda_int16_widened_passes(tmp_path):
    assert _cuda(tmp_path, """
        __global__ void acc_kernel(const int16_t* ev, int* out, int n) {
          int acc = 0;
          for (int i = 0; i < n; ++i) acc += (int)ev[i];
          out[0] = acc * 3 + static_cast<int>(ev[0]);
        }
    """) == []


def test_cuda_int16_renarrowed_fires(tmp_path):
    fs = _cuda(tmp_path, """
        __global__ void k(const int* a, int* out) {
          int x = a[0] + 1;
          short y = (short)x;
          out[0] = y * 3;
        }
    """)
    assert [f.rule for f in fs] == ["CUDA-INT16-ARITH"]


def test_cuda_int16_rewidened_passes(tmp_path):
    assert _cuda(tmp_path, """
        __global__ void k(const int16_t* a, int* out) {
          int16_t y = a[0];
          int x = (int)y;
          out[0] = x * 3;
        }
    """) == []


def test_cuda_int16_plain_copy_passes(tmp_path):
    """Moving narrow values without arithmetic (the kernel's staging
    copies) is the stream's legitimate use."""
    assert _cuda(tmp_path, """
        template <typename EvT>
        __device__ void copy(EvT* dst, const EvT* src, int n) {
          for (int i = 0; i < n; ++i) dst[i] = src[i];
          *dst = *src;
          dst += n;
        }
        void go(void* d, const void* s) {
          copy<int16_t>((int16_t*)d, (const int16_t*)s, 4);
        }
    """) == []


def test_cuda_template_parameter_is_narrow(tmp_path):
    fs = _cuda(tmp_path, """
        template <typename EvT>
        __device__ int read(const EvT* t, int base) { return t[0] + base; }
        int go(const void* e) {
          return read<int16_t>(static_cast<const int16_t*>(e), 3);
        }
    """)
    assert [f.anchor for f in fs] == ["fixture.cu:read:int16#1"]


def test_cuda_mutated_kernel_fires(tmp_path):
    rel = "cadence_tpu_torch/ops/csrc/replay_fsm.cu"
    src = (REPO / rel).read_text()
    assert PJ.lint_cuda_source(src, rel) == []
    old = "const int lo = (int)tile[ph * WARP];"
    assert src.count(old) == 1
    copy = tmp_path / "replay_fsm.cu"
    copy.write_text(src.replace(old, "const int lo = tile[ph * WARP] + 0;"))
    assert [f.anchor for f in PJ.lint_cuda_source(copy.read_text(), rel)] \
        == [f"{rel}:read_fields:int16#1"]


def test_host_sync_fixtures_fire():
    src = textwrap.dedent("""
        import torch

        def launch(rows: torch.Tensor, n):
            a = rows.sum().item()
            b = float(rows[0])
            c = rows.cpu()
            torch.cuda.synchronize()
            k = int(n)
            return rows
    """)
    fs = PJ.lint_source(src, "fix.py", roots=("launch",))
    kinds = {f.anchor.rsplit(":", 1)[-1] for f in fs
             if f.rule == "TORCH-HOST-SYNC"}
    assert kinds == {"item", "float", "cpu", "synchronize"}


def test_tensor_branch_fires():
    src = textwrap.dedent("""
        import torch

        def launch(rows: torch.Tensor):
            live = rows > 0
            if live.any():
                rows = rows + 1
            return rows
    """)
    fs = PJ.lint_source(src, "fix.py", roots=("launch",))
    assert [f.anchor for f in fs] == ["fix.py:launch:branch"]


def test_none_checks_stay_legal():
    src = textwrap.dedent("""
        import torch

        def launch(rows: torch.Tensor, out=None):
            if out is None:
                out = torch.empty_like(rows)
            if rows.dtype == torch.int16 or rows.shape[0] == 0:
                return out
            if rows.device.type != "cuda":
                raise ValueError("cuda only")
            return out
    """)
    assert PJ.lint_source(src, "fix.py", roots=("launch",)) == []


def test_launch_function_discovery():
    import ast

    src = textwrap.dedent("""
        def leaf(x):
            return x

        def thing_plain(x):
            return helper_of_plain(x)

        def helper_of_plain(x):
            return x

        def root(x):
            if x.is_cpu:
                return thing_plain(x)
            return leaf(x)

        def host(x):
            return root(x)
    """)
    assert PJ.launch_functions(ast.parse(src), ("root",)) == {"root", "leaf"}


def test_narrow_force_wide_on_port_callers():
    src = textwrap.dedent("""
        def stage(teb, wide):
            a = narrow_events_teb(teb)
            b = narrow_events_teb(teb, force_wide=wide)
    """)
    assert [f.anchor for f in PJ.lint_source(src, "fix.py")] == \
        ["fix.py:narrow#1"]


def test_shape_round_is_retired():
    """The port has no JIT-SHAPE-ROUND: nothing compiles per shape, so no
    rule is written that could never fire; the module and the README say
    why."""
    src = (REPO / "cadence_tpu_torch/analysis/jit_hazards.py").read_text()
    readme = (REPO / "cadence_tpu_torch/analysis/README.md").read_text()
    assert "JIT-SHAPE-ROUND" in PJ.__doc__ and "retired" in PJ.__doc__
    assert "JIT-SHAPE-ROUND" in readme and "retired" in readme
    assert '"JIT-SHAPE-ROUND"' not in src
    fs = PJ.run(str(REPO))
    assert {f.rule for f in fs} <= {
        "TORCH-HOST-SYNC", "JIT-NARROW-FORCE-WIDE", "TORCH-DTYPE-WIDEN",
        "CUDA-INT16-ARITH"}


def test_trace_demo_needs_a_card_unless_cpu():
    from cadence_tpu_torch.testing import trace_demo

    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trace_demo.run_demo(quiet=True)


def test_port_analysis_imports_no_jax():
    """The gate's modules and the demo import neither jax nor the
    reference package (checked on their sources: this process has both
    loaded)."""
    import ast

    for rel in sorted(Path(REPO, "cadence_tpu_torch/analysis").glob("*.py")) \
            + [REPO / "cadence_tpu_torch/testing/trace_demo.py"]:
        tree = ast.parse(rel.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("jax", "cadence_tpu"), \
                    (rel.name, n)
