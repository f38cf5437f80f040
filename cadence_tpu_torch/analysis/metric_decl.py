"""Pass 4: metric-name declaration check (rule METRIC-UNDECLARED).

Generalizes the replication metrics source-scan test (PR 8,
tests/test_replication_transport.py) into a lint-gate rule over the
whole runtime: every literal metric name emitted via
``.inc("...")`` / ``.gauge("...")`` / ``.record("...")`` under the
scanned packages must appear in one of the ``*_METRICS`` catalogs in
utils/metrics_defs.py (or be one of the standard per-operation triple
names). The catalogs are the operator documentation — dashboards,
alerts and the README glossary are written against them — so an
undeclared emission is a silently undocumented signal.

Scope and mechanics:

* scanned packages: ``cadence_tpu_torch/runtime``,
  ``cadence_tpu_torch/ops``, ``cadence_tpu_torch/matching``,
  ``cadence_tpu_torch/checkpoint``, ``cadence_tpu_torch/serving`` (the
  emission surfaces; utils/ emits only its own self-telemetry, covered by the
  TELEMETRY tuple's coverage test);
* only **constant-string** first arguments fire — f-strings and
  variables (the persistence decorator's per-API ``{name}.latency``
  family) are dynamic names outside the catalog contract and are
  skipped;
* anchors are ``<relpath>:<metric_name>`` — stable under unrelated
  edits, one finding per (file, name) after dedupe.

The inverse direction (declared but never emitted) stays with the
per-family coverage tests, which can assert it precisely.

A copy of the reference package's ``analysis/metric_decl.py``, scanning
the port's tree against the port's catalog.
"""

from __future__ import annotations

import ast
import os
from typing import List, Sequence, Set

from .findings import Finding

RULE = "METRIC-UNDECLARED"

SCAN_DIRS: Sequence[str] = (
    "cadence_tpu_torch/runtime",
    "cadence_tpu_torch/ops",
    "cadence_tpu_torch/matching",
    "cadence_tpu_torch/checkpoint",
    "cadence_tpu_torch/serving",
)

EMIT_METHODS = frozenset({"inc", "gauge", "record"})


def declared_names() -> Set[str]:
    """The union of every ``*_METRICS`` tuple in utils/metrics_defs.py
    plus the standard triple and the registry's own overflow counter —
    the full catalog an emission may legally use."""
    from ..utils import metrics_defs as defs
    from ..utils.metrics import DROPPED_SERIES

    names: Set[str] = set()
    for attr in dir(defs):
        if attr.endswith("_METRICS"):
            value = getattr(defs, attr)
            if isinstance(value, tuple) and all(
                isinstance(v, str) for v in value
            ):
                names.update(value)
    names.update({defs.REQUESTS, defs.LATENCY, defs.ERRORS})
    names.add(DROPPED_SERIES)
    return names


def scan_source(
    src: str, relpath: str, declared: Set[str]
) -> List[Finding]:
    """Findings for every undeclared constant-string metric emission in
    one module's source (exposed separately so the known-bad fixture
    tests can feed synthetic modules)."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding(
            rule=RULE,
            anchor=f"{relpath}:<syntax-error>",
            message=f"{relpath}: unparseable source ({e})",
        )]
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        fn = node.func
        if not isinstance(fn, ast.Attribute) or fn.attr not in EMIT_METHODS:
            continue
        arg = node.args[0]
        if not isinstance(arg, ast.Constant) or not isinstance(
            arg.value, str
        ):
            continue  # dynamic name: outside the catalog contract
        name = arg.value
        if name in declared:
            continue
        out.append(Finding(
            rule=RULE,
            anchor=f"{relpath}:{name}",
            message=(
                f"{relpath}:{node.lineno}: metric '{name}' is emitted "
                f"via .{fn.attr}() but declared in no "
                "utils/metrics_defs.py *_METRICS catalog — declare it "
                "(with operator docs) or rename to a declared family"
            ),
        ))
    return out


def run(repo_root: str) -> List[Finding]:
    declared = declared_names()
    findings: List[Finding] = []
    for scan_dir in SCAN_DIRS:
        base = os.path.join(repo_root, scan_dir)
        if not os.path.isdir(base):
            continue
        for dirpath, _, files in os.walk(base):
            for fname in sorted(files):
                if not fname.endswith(".py"):
                    continue
                fpath = os.path.join(dirpath, fname)
                rel = os.path.relpath(fpath, repo_root)
                with open(fpath) as f:
                    findings.extend(scan_source(f.read(), rel, declared))
    return findings
