"""Static-analysis gate for the port's kernel/runtime contract.

Five passes, run together by ``python -m cadence_tpu_torch.analysis``:

1. **transition surface** (transition_surface.py) — the FSM kernel's
   event-type × column write matrix, probed one step per transition
   group through the CUDA kernel (or, with ``--device cpu``, the plain
   step), diffed against the host oracle's AST-extracted transition
   table and the ops/schema.py invariants (column density, EV_A
   windows, epoch-rebase coverage, the affine decomposition's
   coverage).
2. **launch hazards** (jit_hazards.py) — host syncs in the functions
   that launch a kernel, the narrow stream's wide-column discipline,
   dtype widening in the replay step, and int16 arithmetic in the CUDA
   sources.
3. **lock order** (lock_order.py) — the runtime's lock graph:
   acquisition-order inversions and blocking work (store I/O, sleeps,
   joins, foreign waits) done while holding a lock. The runtime race
   witness (``testing/race_witness``) cross-validates every lock edge
   it observes against this graph.
4. **metrics** (metric_decl.py) — every literal metric emission under
   runtime/ops/matching/checkpoint/serving must be declared in a
   utils/metrics_defs.py catalog (rule METRIC-UNDECLARED).
5. **queue effects** (queue_effects.py) — AST-derived effect
   footprints of every queue-task handler diffed against the declared
   footprint table (runtime/queues/effects.py); the footprints derive
   the task-type commutativity matrix (--emit-conflict-matrix) the
   parallel queue executor gates on.

Findings gate against the port's accepted findings,
``lint_baseline.json`` (surface, hazard, metric and queue passes) and
``lock_baseline.json`` (lock pass) in this package: each accepted
finding carries a one-line justification; anything new exits non-zero.
``sanitizer_waivers.json`` holds the race witness's waivers. See
README.md here for per-rule docs and how to baseline.

A copy of the reference package's static-analysis gate
(``analysis/``), scanning the port's tree.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from .findings import Baseline, BaselineEntry, Finding, dedupe

PASSES = ("surface", "jit", "locks", "metrics", "queue")

# rule-id prefixes per pass — lets a --passes subset run scope the
# baseline to the rules that could actually fire, so entries belonging
# to skipped passes are not reported (or strict-failed) as stale
PASS_RULE_PREFIXES = {
    "surface": ("SURFACE-", "SCHEMA-", "ASSOC-"),
    "jit": ("JIT-", "TORCH-", "CUDA-"),
    "locks": ("LOCK-",),
    "metrics": ("METRIC-",),
    "queue": ("QUEUE-",),
}

_HERE = os.path.dirname(os.path.abspath(__file__))
# the gate's accepted findings: the lock pass's file stays where the race
# witness reads it
BASELINE_PATHS = (
    os.path.join(_HERE, "lint_baseline.json"),
    os.path.join(_HERE, "lock_baseline.json"),
)


def load_baselines(paths=BASELINE_PATHS) -> Baseline:
    """One baseline of every entry of ``paths``, in order."""
    return Baseline([e for p in paths for e in Baseline.load(p).entries])


def scope_baseline(baseline, passes):
    """Baseline restricted to entries whose rule belongs to ``passes``
    (None = all passes, returned unchanged). Entries with rules outside
    every known prefix only gate on full runs."""
    if passes is None:
        return baseline
    prefixes = tuple(
        p for name in passes for p in PASS_RULE_PREFIXES.get(name, ())
    )
    return Baseline([
        e for e in baseline.entries if e.rule.startswith(prefixes)
    ]) if prefixes else Baseline([])


def run_pass(name: str, repo_root: str, device="cuda") -> List[Finding]:
    """One pass over the tree at ``repo_root``; ``device`` is where the
    surface pass probes the FSM step."""
    if name == "surface":
        from . import transition_surface

        return transition_surface.run(repo_root, device=device)
    if name == "jit":
        from . import jit_hazards

        return jit_hazards.run(repo_root)
    if name == "locks":
        from . import lock_order

        return lock_order.run(repo_root)
    if name == "metrics":
        from . import metric_decl

        return metric_decl.run(repo_root)
    if name == "queue":
        from . import queue_effects

        return queue_effects.run(repo_root)
    raise ValueError(f"unknown pass {name!r} (have: {PASSES})")


def run_all(
    repo_root: str, passes: Optional[List[str]] = None, device="cuda"
) -> Dict[str, List[Finding]]:
    """{pass name → deduped findings} over the real tree."""
    out: Dict[str, List[Finding]] = {}
    for name in passes or PASSES:
        out[name] = dedupe(run_pass(name, repo_root, device=device))
    return out


__all__ = [
    "BASELINE_PATHS", "Baseline", "BaselineEntry", "Finding", "PASSES",
    "PASS_RULE_PREFIXES", "dedupe", "load_baselines", "run_all",
    "run_pass", "scope_baseline",
]
