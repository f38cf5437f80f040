"""Runtime effect witness: record queue-task persistence effects and
check them against the static footprints.

The dynamic half of Pass 5's bidirectional proof
(the reference package's ``analysis/queue_effects.py``). The static side
AST-derives each queue-task type's effect footprint and gates it
against the declared table (``runtime/queues/effects.py``); this module
validates the same claim under execution — including the ≥10%
write-fault storm of the chaos suites, where retries, torn writes and
park/retry loops exercise paths an AST reading can only assume:

* ``EffectRecordingClient`` — a persistence decorator in the
  ``_Wrapped`` family, installed innermost by
  ``wrap_bundle(effects=...)`` exactly like ``FaultInjectionClient``
  (the two compose: the witness sees the real call UNDER the fault
  client, so a torn write that landed is recorded and an injected
  error that never reached the store is not);
* ``EffectRecorder`` — the aggregation store: every persistence call
  made while a queue task is executing (attributed via
  ``runtime/queues/effects.task_effect_scope``) lands as
  (plane, task type) → {(manager, method)};
* ``check_witness`` — recorded ⊆ footprint, per task type. Any
  recorded effect escaping its static footprint is a violation: either
  the handler grew an undeclared effect the AST extractor's
  neutral-by-default heuristic missed, or the footprint table is
  stale. Both mean the conflict matrix can no longer be trusted — the
  exact failure this witness exists to catch before the parallel
  queue does.

A copy of the reference package's ``testing/effect_witness.py`` over the
port's footprint table (``runtime/queues/effects.py``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

from ..runtime.persistence.decorators import _Wrapped
from ..runtime.queues import effects as rt_effects


class EffectRecorder:
    """Thread-safe (plane, task type) → {(manager, method)} aggregator.

    Install with :func:`install`; remove with :func:`uninstall` (or use
    ``recording()``). One recorder is expected per process at a time —
    the underlying hook is a module global, same as the tracer."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._calls: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}

    def record(self, plane: str, task_type: str, manager: str,
               method: str) -> None:
        with self._lock:
            self._calls.setdefault((plane, task_type), set()).add(
                (manager, method)
            )

    def snapshot(self) -> Dict[Tuple[str, str], Set[Tuple[str, str]]]:
        with self._lock:
            return {k: set(v) for k, v in self._calls.items()}

    def recorded_surfaces(
        self,
    ) -> Dict[Tuple[str, str], Set[Tuple[str, str]]]:
        """{(plane, task type) → {(surface, "r"|"w")}} — the recorded
        calls mapped through the shared verb→surface vocabulary."""
        out: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}
        for key, calls in self.snapshot().items():
            surfaces: Set[Tuple[str, str]] = set()
            for manager, method in calls:
                surfaces.update(rt_effects.verb_effects(manager, method))
            out[key] = surfaces
        return out

    def install(self) -> "EffectRecorder":
        rt_effects.set_recorder(self.record)
        return self

    def uninstall(self) -> None:
        rt_effects.set_recorder(None)

    def __enter__(self) -> "EffectRecorder":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


class EffectRecordingClient(_Wrapped):
    """Persistence decorator feeding the task-attribution hook.

    Pure pass-through when the calling thread is outside a task scope
    or no recorder is installed (one module-global check)."""

    def __init__(self, base, manager: str = "") -> None:
        super().__init__(base)
        self._manager = manager or type(base).__name__

    def _invoke(self, name, method, args, kwargs):
        rt_effects.record_persistence_call(self._manager, name)
        return method(*args, **kwargs)


def check_witness(
    recorder: EffectRecorder,
    footprints: Optional[Dict[Tuple[str, str], object]] = None,
) -> List[str]:
    """Violation messages for every recorded effect escaping its
    footprint (empty = the witness holds).

    ``footprints`` defaults to the DECLARED table (+ plane-common
    reads); the chaos witness test passes the AST-EXTRACTED footprints
    instead, which is the stronger check — it validates the extractor
    itself, not just the hand-maintained declarations."""
    violations: List[str] = []
    for (plane, ttype), surfaces in sorted(
        recorder.recorded_surfaces().items()
    ):
        if footprints is None:
            fp = rt_effects.effective_footprint(plane, ttype)
        else:
            fp = footprints.get((plane, ttype))
        if fp is None:
            violations.append(
                f"{plane}:{ttype}: task executed with NO footprint "
                f"(recorded {sorted(surfaces)})"
            )
            continue
        reads = set(fp.reads) | rt_effects.PLANE_COMMON_READS
        writes = set(fp.writes)
        for surface, kind in sorted(surfaces):
            if kind == "r":
                if surface not in reads and surface not in writes:
                    violations.append(
                        f"{plane}:{ttype}: recorded READ of {surface} "
                        "outside the static footprint"
                    )
            elif surface not in writes:
                violations.append(
                    f"{plane}:{ttype}: recorded WRITE of {surface} "
                    "outside the static footprint"
                )
    return violations
