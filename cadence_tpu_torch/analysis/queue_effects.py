"""Pass 5 — queue-task effect analysis (the parallel-queue proof).

Extends the PR-4 discipline (event-type × state-column write matrix for
the replay kernel) one layer up, to the queue-task handlers that today
run strictly sequentially per shard. For every handler reachable from a
queue dispatch table — ``TransferQueueProcessor._process_*``,
``TimerQueueProcessor._process_*``, the standby verification twins, and
the NDC replication apply path — this pass AST-derives the handler's
*effect footprint*:

* persistence **surfaces** read/written (execution rows, current-run
  rows, history branches, queue-task rows, matching task lists,
  visibility records, checkpoints — the vocabulary lives in
  ``runtime/queues/effects.py`` so the runtime witness shares it);
* **mutable-state columns** read/written (``execution_info`` fields +
  pending-map tables, reusing oracle_ast.py's alias/write-set
  machinery);
* **cross-workflow effects** (parent-close-policy fan-out, child
  starts, external cancel/signal) — the effects that break
  per-workflow conflict keying.

and diffs it against the declared footprint table
(``runtime/queues/effects.TASK_FOOTPRINTS``):

| rule | fires when |
|---|---|
| ``QUEUE-EFFECT-UNKNOWN`` | the footprint is unextractable: a call on an effect-carrying receiver (persistence/engine/matching/…) with no vocabulary entry, an untracked bare helper, or dynamic dispatch inside a handler body |
| ``QUEUE-CONFLICT-UNDECLARED`` | the handler touches a persistence surface outside its declared footprint (or has no declaration at all) |
| ``QUEUE-CROSS-WF`` | the handler fans out to another workflow without declaring the effect |

Extraction is purely syntactic over handler bodies with a same-class
call closure (``self._helper`` folds the helper's effects into the
caller, fixpoint) plus a small vocabulary of module-level helpers
(``delete_workflow_retention``, ``open_visibility_record``). Calls on
receivers with no effect-carrying name (in-memory version-history
algebra, record constructors, logging) default to neutral — the
deliberately conservative half the runtime *effect witness*
(testing/effect_witness.py) covers dynamically: recorded persistence
calls must land inside the static footprint, so a neutral-defaulted
call that actually hits the store fails the chaos witness test.

The footprints also feed ``--emit-conflict-matrix``: the task-type ×
task-type commute/conflict matrix (runtime/queues/effects.py
``build_conflict_matrix``) written as a versioned JSON artifact — the
parallel queue executor's gate.

A copy of the reference package's ``analysis/queue_effects.py``, over the
port's handlers and footprint table. ``--emit-conflict-matrix`` writes
the document that the executor's
``runtime/queues/parallel.ensure_conflict_matrix`` writes, plus the
AST-extracted ``ms_columns``.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Set, Tuple

from .findings import Finding
from .oracle_ast import PENDING_TABLES

RULE_UNKNOWN = "QUEUE-EFFECT-UNKNOWN"
RULE_UNDECLARED = "QUEUE-CONFLICT-UNDECLARED"
RULE_CROSS = "QUEUE-CROSS-WF"

# (module path, class, plane, task-type enum receiver)
DISPATCH_CLASSES = (
    ("cadence_tpu_torch/runtime/queues/transfer.py",
     "TransferQueueProcessor", "transfer", "TransferTaskType"),
    ("cadence_tpu_torch/runtime/queues/timer.py",
     "TimerQueueProcessor", "timer", "TimerTaskType"),
    ("cadence_tpu_torch/runtime/queues/standby.py",
     "TransferQueueStandbyProcessor", "transfer-standby",
     "TransferTaskType"),
    ("cadence_tpu_torch/runtime/queues/standby.py",
     "TimerQueueStandbyProcessor", "timer-standby", "TimerTaskType"),
)

# the NDC apply path is not task-type dispatched; its entry points are
# pseudo task types on the "replication" plane
REPLICATION_HANDLERS = (
    ("cadence_tpu_torch/runtime/replication/ndc.py", "NDCHistoryReplicator",
     "replication", {
         "apply_events": "HistoryReplication",
         "apply_state_snapshot": "SnapshotReplication",
         "backfill_history": "HistoryBackfill",
     }),
)

# ---------------------------------------------------------------------------
# call vocabulary
# ---------------------------------------------------------------------------

# receiver-chain fragments that mark a receiver as effect-carrying: a
# call on one of these MUST classify (vocabulary or neutral list) or it
# is an unextractable footprint (QUEUE-EFFECT-UNKNOWN)
EFFECT_RECEIVER_HINTS = (
    "persistence", "engine", "matching", "visibility", "history_client",
    "shard", "txn", "ctx", "store", "rebuilder", "client",
)

# cross-workflow client verbs → (xwf effect, implied surface writes on
# the TARGET workflow). The implied writes ride in the footprint so the
# runtime witness can attribute the in-process fan-out's persistence
# calls to the originating task.
XWF_CLIENT_VERBS = {
    "record_child_execution_completed": (
        "xwf.record_child_close",
        ("execution", "history", "queue_tasks", "shard_seq"),
    ),
    "terminate_workflow_execution": (
        "xwf.terminate",
        ("execution", "history", "queue_tasks", "shard_seq"),
    ),
    "request_cancel_workflow_execution": (
        "xwf.request_cancel",
        ("execution", "history", "queue_tasks", "shard_seq"),
    ),
    "signal_workflow_execution": (
        "xwf.signal",
        ("execution", "history", "queue_tasks", "shard_seq"),
    ),
    "start_workflow_execution": (
        "xwf.start_child",
        ("execution", "current_run", "history", "queue_tasks",
         "shard_seq", "task_store", "visibility"),
    ),
}

# engine verbs that mint events on the task's OWN workflow
ENGINE_MINT_VERBS = {
    "record_external_cancel_result", "record_external_signal_result",
    "record_child_execution_started", "record_start_child_execution_failed",
}

# neutral methods allowed on effect-carrying receivers (reads of
# in-memory state, notifier wakes, span/cache plumbing)
NEUTRAL_EFFECT_METHODS = {
    "now", "current_time", "tagged", "evict", "get_or_create",
    "notify", "_notify", "close",  # txn.close handled explicitly below
}

# bare module-level helper functions with known effects
FUNC_EFFECTS = {
    "delete_workflow_retention": {
        "reads": {"execution"},
        "writes": {"execution", "current_run", "visibility", "history"},
    },
    "open_visibility_record": {"reads": set(), "writes": set()},
    "try_continue_after_close": {
        # cron/retry relaunch: mints the continue/close events via the
        # caller's txn and reads the first event for the relaunch attrs
        "reads": {"history"},
        "writes": {"execution", "history", "queue_tasks"},
    },
}

# neutral bare callables (builtins + pure in-module helpers)
NEUTRAL_FUNCS = {
    "dict", "list", "set", "tuple", "frozenset", "sorted", "max", "min",
    "len", "int", "str", "float", "bool", "enumerate", "zip", "range",
    "repr", "isinstance", "getattr", "setattr", "hasattr", "print",
    "abs", "sum", "any", "all", "iter", "next", "vars", "type",
    "task_span", "make_fault_hook", "defer_task", "read_due_timers",
    "run_task_attempts", "sweep_ack", "timed_task", "refresh_tasks",
    "task_effect_scope", "_incoming_history",
}

_LOG_RECEIVERS = {"_log", "_tlog", "_slog", "_gclog", "log", "logger"}
_LOG_METHODS = {"info", "debug", "warning", "error", "exception"}


def _dotted(node: ast.expr) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return f"{_dotted(node.value)}.{node.attr}"
    if isinstance(node, ast.Call):
        return f"{_dotted(node.func)}()"
    if isinstance(node, ast.Subscript):
        return f"{_dotted(node.value)}[]"
    return "<expr>"


@dataclasses.dataclass
class ExtractedFootprint:
    """AST-derived effect footprint of one handler closure."""

    reads: Set[str] = dataclasses.field(default_factory=set)
    writes: Set[str] = dataclasses.field(default_factory=set)
    cross_workflow: Set[str] = dataclasses.field(default_factory=set)
    ms_reads: Set[str] = dataclasses.field(default_factory=set)
    ms_writes: Set[str] = dataclasses.field(default_factory=set)
    unknown: List[Tuple[int, str]] = dataclasses.field(default_factory=list)
    self_calls: Set[str] = dataclasses.field(default_factory=set)

    def merge(self, other: "ExtractedFootprint") -> bool:
        """Fold ``other`` (a callee) into this footprint; True when
        anything new arrived (drives the closure fixpoint)."""
        before = (
            len(self.reads), len(self.writes), len(self.cross_workflow),
            len(self.ms_reads), len(self.ms_writes), len(self.unknown),
        )
        self.reads |= other.reads
        self.writes |= other.writes
        self.cross_workflow |= other.cross_workflow
        self.ms_reads |= other.ms_reads
        self.ms_writes |= other.ms_writes
        for u in other.unknown:
            if u not in self.unknown:
                self.unknown.append(u)
        after = (
            len(self.reads), len(self.writes), len(self.cross_workflow),
            len(self.ms_reads), len(self.ms_writes), len(self.unknown),
        )
        return after != before


class _EffectVisitor(ast.NodeVisitor):
    """Classify every call in one method body into surface effects.

    ``class_methods`` drives the same-class closure (self-calls are
    recorded, resolved by the caller's fixpoint); ``module_funcs`` are
    functions defined in the same module (treated like FUNC_EFFECTS
    entries when present, neutral otherwise — a module helper the
    vocabulary doesn't know is exactly the "untracked helper" case and
    fires UNKNOWN)."""

    def __init__(self, class_methods: Set[str], module_funcs: Set[str],
                 local_names: Set[str] = frozenset()) -> None:
        self.fp = ExtractedFootprint()
        self.class_methods = class_methods
        self.module_funcs = module_funcs
        # parameters + nested defs + lambda bindings of THIS method: a
        # call through one is a locally-visible callable whose body is
        # visited where it is defined (nested def) or bound (argument
        # at the call site) — neutral here, never an untracked helper
        self.local_names = set(local_names)
        # Name → persistence manager, for `history = self.shard.
        # persistence.history` style aliases
        self.mgr_aliases: Dict[str, str] = {}
        # names bound to a whole persistence BUNDLE (`p = self.shard.
        # persistence`): calls through `p.<manager>.<method>` classify
        # by the manager segment
        self.bundle_aliases: Set[str] = set()
        # Names bound to execution_info within the body (pending-map
        # tables are matched by attribute name, receiver-independent)
        self.ei_aliases: Set[str] = {"ei"}

    # -- helpers -------------------------------------------------------

    def _surface(self, surface: str, kind: str) -> None:
        (self.fp.reads if kind == "r" else self.fp.writes).add(surface)

    def _manager_effect(self, manager: str, method: str) -> None:
        from ..runtime.queues import effects as rt

        for surface, kind in rt.verb_effects(manager, method):
            self._surface(surface, kind)

    def _unknown(self, node: ast.Call, why: str) -> None:
        self.fp.unknown.append((node.lineno, why))

    # -- alias discovery ----------------------------------------------

    def visit_Assign(self, node: ast.Assign) -> None:
        chain = _dotted(node.value) if isinstance(
            node.value, (ast.Attribute, ast.Name)
        ) else ""
        segs = chain.replace("()", "").split(".") if chain else []
        for tgt in node.targets:
            if not isinstance(tgt, ast.Name):
                continue
            if segs and segs[-1].endswith("persistence"):
                self.bundle_aliases.add(tgt.id)
            elif any(s.endswith("persistence") for s in segs[:-1]):
                self.mgr_aliases[tgt.id] = segs[-1]
            elif chain.endswith(".execution_info"):
                self.ei_aliases.add(tgt.id)
        # ms column writes: ei.field = / ms.execution_info.field =
        for tgt in node.targets:
            self._ms_store(tgt)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._ms_store(node.target)
        self.generic_visit(node)

    def _ms_store(self, tgt: ast.expr) -> None:
        if not isinstance(tgt, ast.Attribute):
            return
        base = tgt.value
        if isinstance(base, ast.Name) and base.id in self.ei_aliases:
            self.fp.ms_writes.add(f"exec:{tgt.attr}")
        elif (
            isinstance(base, ast.Attribute)
            and base.attr == "execution_info"
        ):
            self.fp.ms_writes.add(f"exec:{tgt.attr}")

    def visit_Attribute(self, node: ast.Attribute) -> None:
        # ms column/table reads (loads only; stores recorded above)
        if isinstance(node.ctx, ast.Load):
            base = node.value
            if isinstance(base, ast.Name) and base.id in self.ei_aliases:
                self.fp.ms_reads.add(f"exec:{node.attr}")
            if node.attr in PENDING_TABLES:
                self.fp.ms_reads.add(PENDING_TABLES[node.attr])
        self.generic_visit(node)

    # -- call classification ------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        self._classify(node)
        self.generic_visit(node)

    def _classify(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Name):
            name = fn.id
            if name in FUNC_EFFECTS:
                eff = FUNC_EFFECTS[name]
                self.fp.reads |= eff["reads"]
                self.fp.writes |= eff["writes"]
                return
            if (
                name in NEUTRAL_FUNCS
                or name in self.module_funcs
                or name in self.local_names
            ):
                return
            if name[:1].isupper():
                return  # constructor / exception: in-memory
            self._unknown(node, f"untracked helper {name}()")
            return
        if not isinstance(fn, ast.Attribute):
            # calling a subscript/lambda result: dynamic dispatch
            self._unknown(node, f"dynamic call {_dotted(fn)}(...)")
            return

        recv = _dotted(fn.value)
        tail = recv.rsplit(".", 1)[-1]
        attr = fn.attr

        if tail in _LOG_RECEIVERS and attr in _LOG_METHODS:
            return
        # persistence chains + aliases of them: any segment NAMING the
        # bundle ("persistence", "get_persistence()", …) classifies the
        # next segment as the manager — a bundle reached through a
        # helper call must not fall through to neutral
        segs = recv.replace("()", "").split(".")
        for i, seg in enumerate(segs[:-1]):
            if seg.endswith("persistence"):
                self._manager_effect(segs[i + 1], attr)
                return
        if isinstance(fn.value, ast.Name) and fn.value.id in self.mgr_aliases:
            self._manager_effect(self.mgr_aliases[fn.value.id], attr)
            return
        parts = recv.split(".")
        if parts[0] in self.bundle_aliases and len(parts) >= 2:
            self._manager_effect(parts[1], attr)
            return
        # checkpoint store handle (mgr.store.put_checkpoint)
        if tail == "store" and "checkpoint" in attr:
            self._surface("checkpoint",
                          "r" if attr.startswith(("get_", "list_")) else "w")
            return
        # matching pushes
        if tail == "matching" and attr.startswith("add_"):
            self._surface("task_store", "w")
            return
        # visibility records
        if tail == "visibility":
            self._surface(
                "visibility",
                "r" if attr.startswith(("get_", "list_", "count_")) else "w",
            )
            return
        # cross-workflow client calls
        if tail == "history_client":
            if attr in XWF_CLIENT_VERBS:
                xwf, implied = XWF_CLIENT_VERBS[attr]
                self.fp.cross_workflow.add(xwf)
                self.fp.writes |= set(implied)
                return
            self._unknown(node, f"history_client.{attr}(...) unvocabularied")
            return
        # engine surface
        if "engine" in recv.split("."):
            if "domains" in recv.split("."):
                self._surface("metadata", "r")
                return
            if attr == "with_workflow":
                self._surface("execution", "r")
                return
            if attr in ENGINE_MINT_VERBS:
                for s in ("execution", "history", "queue_tasks",
                          "shard_seq"):
                    self._surface(s, "w")
                return
            if attr in ("_txn",) or attr in NEUTRAL_EFFECT_METHODS:
                return
            if attr in ("cache",):
                return
            self._unknown(node, f"engine.{attr}(...) unvocabularied")
            return
        # active-transaction mints (inside _mutate-style closures)
        if tail == "txn":
            if attr.startswith("add_"):
                for s in ("execution", "history", "queue_tasks"):
                    self._surface(s, "w")
                return
            if attr == "schedule_timer_task":
                self._surface("queue_tasks", "w")
                return
            if attr == "close":
                for s in ("execution", "history", "queue_tasks",
                          "shard_seq"):
                    self._surface(s, "w")
                return
            if attr.startswith(("has_", "is_", "get_")):
                return
            self._unknown(node, f"txn.{attr}(...) unvocabularied")
            return
        # workflow execution context
        if tail == "ctx":
            if attr == "load":
                self._surface("execution", "r")
                return
            if attr == "update_workflow":
                for s in ("execution", "history", "queue_tasks",
                          "shard_seq"):
                    self._surface(s, "w")
                return
            if attr in ("read_history", "get_event"):
                self._surface("history", "r")
                return
            self._unknown(node, f"ctx.{attr}(...) unvocabularied")
            return
        # shard context
        if tail == "shard":
            if attr in ("now",):
                return
            if attr in ("next_task_id", "assign_task_ids"):
                self._surface("shard_seq", "w")
                if attr == "assign_task_ids":
                    self._surface("queue_tasks", "w")
                return
            self._unknown(node, f"shard.{attr}(...) unvocabularied")
            return
        # rebuilder: reads history (+checkpoint consult/refresh)
        if tail in ("rebuilder", "rb") or recv.endswith(".rebuilder"):
            if attr in ("rebuild", "rebuild_many"):
                self._surface("history", "r")
                self._surface("checkpoint", "r")
                self._surface("checkpoint", "w")
                return
            self._unknown(node, f"rebuilder.{attr}(...) unvocabularied")
            return
        # archival fan-out
        if attr == "maybe_archive":
            self._surface("archival", "w")
            return
        # state-builder apply: in-memory mutable-state mutation (the
        # persisted write is the explicit update/create call)
        if tail == "sb" and attr == "apply_events":
            self.fp.ms_writes.add("state_builder")
            return
        # domain cache off a bare name (self.domains.resolve)
        if tail == "domains":
            self._surface("metadata", "r")
            return
        # allocator classification reads domain records
        if tail == "_allocator":
            self._surface("metadata", "r")
            return
        # self-calls: same-class closure, resolved by the caller
        if isinstance(fn.value, ast.Name) and fn.value.id == "self":
            if attr in self.class_methods:
                self.fp.self_calls.add(attr)
                return
            if attr in ("_task_notifier", "_timer_notifier",
                        "_fault_hook", "_on_handover"):
                return  # pump wakes / chaos hooks: no persistence
            if attr == "_is_active_locally":
                # constructor-injected active-cluster predicate: a
                # domain-record read however it is wired
                self._surface("metadata", "r")
                return
            self._unknown(node, f"self.{attr}(...) not a class method")
            return
        # any other effect-carrying receiver: must classify
        if any(h in recv.split(".") for h in EFFECT_RECEIVER_HINTS):
            if attr in NEUTRAL_EFFECT_METHODS:
                return
            self._unknown(node, f"{recv}.{attr}(...) unvocabularied")
            return
        # everything else (version-history algebra, record objects,
        # containers) is in-memory: neutral by default — the runtime
        # effect witness covers this conservative half dynamically


# ---------------------------------------------------------------------------
# dispatch-table + handler extraction
# ---------------------------------------------------------------------------


def _class_def(tree: ast.Module, name: str) -> Optional[ast.ClassDef]:
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    return None


def extract_dispatch(cls: ast.ClassDef, enum_name: str) -> Dict[str, str]:
    """{task type name → handler method name} from ``_process``.

    Understands the dict-dispatch idiom (``{TaskType.X:
    self._handler}.get(task.task_type)``; a lambda value is a declared
    no-op and maps to ``<noop>``) and the guard idiom (``if
    task.task_type == TaskType.X: self._handler(task)``)."""
    proc = None
    for item in cls.body:
        if isinstance(item, ast.FunctionDef) and item.name == "_process":
            proc = item
            break
    if proc is None:
        return {}
    table: Dict[str, str] = {}

    def enum_member(node: ast.expr) -> Optional[str]:
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == enum_name
        ):
            return node.attr
        return None

    for node in ast.walk(proc):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                m = enum_member(k) if k is not None else None
                if m is None:
                    continue
                if (
                    isinstance(v, ast.Attribute)
                    and isinstance(v.value, ast.Name)
                    and v.value.id == "self"
                ):
                    table[m] = v.attr
                elif isinstance(v, ast.Lambda):
                    table[m] = "<noop>"
        if isinstance(node, ast.If):
            # if task.task_type == TaskType.X: self._handler(task)
            t = node.test
            if (
                isinstance(t, ast.Compare) and len(t.ops) == 1
                and isinstance(t.ops[0], ast.Eq)
            ):
                m = enum_member(t.comparators[0])
                if m is not None and m not in table:
                    for stmt in node.body:
                        if (
                            isinstance(stmt, ast.Expr)
                            and isinstance(stmt.value, ast.Call)
                            and isinstance(stmt.value.func, ast.Attribute)
                            and isinstance(stmt.value.func.value, ast.Name)
                            and stmt.value.func.value.id == "self"
                        ):
                            table[m] = stmt.value.func.attr
                            break
    return table


def extract_method_footprints(
    cls: ast.ClassDef, module_funcs: Set[str]
) -> Dict[str, ExtractedFootprint]:
    """Per-method footprints with the same-class call closure folded in
    (fixpoint, mirroring oracle_ast.extract_replicate_writes)."""
    methods = {
        item.name for item in cls.body if isinstance(item, ast.FunctionDef)
    }
    out: Dict[str, ExtractedFootprint] = {}
    for item in cls.body:
        if not isinstance(item, ast.FunctionDef):
            continue
        local_names = {a.arg for a in item.args.args}
        local_names |= {a.arg for a in item.args.kwonlyargs}
        for n in ast.walk(item):
            if isinstance(n, ast.FunctionDef) and n is not item:
                local_names.add(n.name)
            if isinstance(n, ast.Assign) and isinstance(
                n.value, ast.Lambda
            ):
                local_names |= {
                    t.id for t in n.targets if isinstance(t, ast.Name)
                }
        v = _EffectVisitor(methods, module_funcs, local_names)
        for stmt in item.body:
            v.visit(stmt)
        out[item.name] = v.fp
    changed = True
    while changed:
        changed = False
        for fp in out.values():
            for callee in list(fp.self_calls):
                target = out.get(callee)
                if target is not None and fp.merge(target):
                    changed = True
    return out


def handler_footprints(repo_root: str) -> Dict[Tuple[str, str], Tuple[
        str, str, Optional[ExtractedFootprint]]]:
    """{(plane, task type) → (module relpath, handler name, footprint)}
    for every dispatch-reachable handler in the tree. A ``<noop>``
    dispatch entry (lambda) yields an empty footprint."""
    out: Dict[Tuple[str, str], Tuple[str, str,
                                     Optional[ExtractedFootprint]]] = {}
    for rel, clsname, plane, enum_name in DISPATCH_CLASSES:
        path = os.path.join(repo_root, rel)
        with open(path) as f:
            tree = ast.parse(f.read())
        module_funcs = {
            n.name for n in tree.body if isinstance(n, ast.FunctionDef)
        }
        cls = _class_def(tree, clsname)
        if cls is None:
            continue
        dispatch = extract_dispatch(cls, enum_name)
        fps = extract_method_footprints(cls, module_funcs)
        for ttype, handler in dispatch.items():
            if handler == "<noop>":
                out[(plane, ttype)] = (rel, handler, ExtractedFootprint())
            else:
                out[(plane, ttype)] = (rel, handler, fps.get(handler))
    for rel, clsname, plane, entry_map in REPLICATION_HANDLERS:
        path = os.path.join(repo_root, rel)
        with open(path) as f:
            tree = ast.parse(f.read())
        module_funcs = {
            n.name for n in tree.body if isinstance(n, ast.FunctionDef)
        }
        cls = _class_def(tree, clsname)
        if cls is None:
            continue
        fps = extract_method_footprints(cls, module_funcs)
        for method, ttype in entry_map.items():
            out[(plane, ttype)] = (rel, method, fps.get(method))
    return out


# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------


def diff_footprints(
    extracted: Dict[Tuple[str, str],
                    Tuple[str, str, Optional[ExtractedFootprint]]],
    declared: Optional[Dict[Tuple[str, str], object]] = None,
) -> List[Finding]:
    """Diff extracted handler footprints against the declared table."""
    from ..runtime.queues import effects as rt

    if declared is None:
        declared = rt.TASK_FOOTPRINTS
    findings: List[Finding] = []
    for (plane, ttype), (rel, handler, fp) in sorted(extracted.items()):
        anchor = f"queue:{plane}:{ttype}"
        if fp is None:
            findings.append(Finding(
                RULE_UNKNOWN, f"{anchor}:missing-handler",
                f"{rel}: dispatch maps {plane}:{ttype} to {handler} "
                "but no such method exists — unextractable footprint",
            ))
            continue
        for lineno, why in fp.unknown:
            findings.append(Finding(
                RULE_UNKNOWN, f"{anchor}:{why.split('(', 1)[0].strip()}",
                f"{rel}:{lineno}: {plane}:{ttype} handler {handler} has "
                f"an unextractable effect: {why} — add it to the Pass-5 "
                "vocabulary or refactor to a tracked helper",
            ))
        decl = declared.get((plane, ttype))
        if decl is None:
            findings.append(Finding(
                RULE_UNDECLARED, f"{anchor}:undeclared",
                f"{rel}: {plane}:{ttype} ({handler}) has no declared "
                "footprint in runtime/queues/effects.TASK_FOOTPRINTS — "
                "the conflict matrix cannot cover it",
            ))
            continue
        extra_w = sorted(fp.writes - decl.writes)
        if extra_w:
            findings.append(Finding(
                RULE_UNDECLARED, f"{anchor}:writes",
                f"{rel}: {plane}:{ttype} ({handler}) writes "
                f"{','.join(extra_w)} outside its declared footprint — "
                "extend TASK_FOOTPRINTS (and re-derive the conflict "
                "matrix) or remove the effect",
            ))
        # handlers may read anything the plane-common prelude already
        # pays (domain-owner classification), hence PLANE_COMMON_READS
        extra_r = sorted(
            fp.reads - decl.reads - decl.writes - rt.PLANE_COMMON_READS
        )
        if extra_r:
            findings.append(Finding(
                RULE_UNDECLARED, f"{anchor}:reads",
                f"{rel}: {plane}:{ttype} ({handler}) reads "
                f"{','.join(extra_r)} outside its declared footprint",
            ))
        extra_x = sorted(fp.cross_workflow - decl.cross_workflow)
        if extra_x:
            findings.append(Finding(
                RULE_CROSS, f"{anchor}:cross-wf",
                f"{rel}: {plane}:{ttype} ({handler}) fans out across "
                f"workflows ({','.join(extra_x)}) without declaring it "
                "— cross-workflow effects break per-workflow conflict "
                "keying and MUST be explicit in TASK_FOOTPRINTS",
            ))
    return findings


def run(repo_root: str) -> List[Finding]:
    return diff_footprints(handler_footprints(repo_root))


# ---------------------------------------------------------------------------
# conflict-matrix artifact
# ---------------------------------------------------------------------------


def emit_conflict_matrix(repo_root: str, path: str) -> None:
    """Write the task-type commutativity matrix as a versioned JSON
    artifact (the parallel queue executor's gate). The matrix derives
    from the DECLARED footprints; the gate (this pass) proves declared ⊇
    extracted and the chaos witness proves recorded ⊆ static, so
    consumers may trust the artifact's verdicts. The runtime's
    ``ensure_conflict_matrix`` writes the same document without
    ``ms_columns``."""
    from ..runtime.queues import effects as rt

    from .artifact import write_artifact

    doc = rt.build_conflict_matrix()
    # ms-column granularity rides along for the executor's future
    # finer-grained keying (informational; verdicts are surface-level)
    cols: Dict[str, Dict[str, List[str]]] = {}
    for (plane, ttype), (_, _, fp) in handler_footprints(repo_root).items():
        if fp is not None:
            cols[f"{plane}:{ttype}"] = {
                "ms_reads": sorted(fp.ms_reads),
                "ms_writes": sorted(fp.ms_writes),
            }
    doc["ms_columns"] = cols
    write_artifact(path, rt.CONFLICT_MATRIX_SCHEMA, doc)
