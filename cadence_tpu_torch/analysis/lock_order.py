"""Pass 3 — concurrency lint: lock graph + blocking-calls-under-lock.

The runtime is a thread pile: queue pumps, worker pools, ack sweeps,
replication appliers, the shard sequencer. This pass builds, purely
from the AST:

* a **lock inventory** — ``self.x = threading.Lock()/RLock()/
  Condition()`` attributes per class, plus local locks;
* a **lock-order graph** — an edge A→B wherever B is acquired while A
  is held (nested ``with``, ``.acquire()``, or a same-class method call
  that acquires B), with cycle (inversion) detection;
* **blocking-call-under-lock** findings — store I/O (persistence
  managers, sqlite cursors), ``time.sleep``, ``.join()``, blocking
  queue ``get``/``put``, and ``.wait()`` on anything *other than the
  condition being held* (waiting on a held Condition releases it; an
  Event.wait under someone else's lock stalls every other holder).

Cross-class lock propagation: a call under a held lock whose receiver
is NOT ``self`` (``handle.shard.fence()``, ``c.acquire_shards()``) is
resolved by METHOD NAME against every class in scope. When the name
resolves unambiguously — exactly one scope class defines it, or every
defining class agrees it blocks — the callee's blocking work surfaces
as LOCK-CROSS-BLOCKING at the caller, and the callee's lock
acquisitions become cross-class edges in the inversion graph (a
coordinator holding its own lock while fencing a shard context now
participates in the same order proof as the context's lock). Names
defined by many scope classes with disagreeing behavior are skipped —
resolution is by name, not type inference, and a wrong guess would be
noise, not safety.

Known limits (documented, deliberate): remaining cross-class reasoning
is attribute-name heuristics (a call whose receiver chain mentions
``persistence``/store managers counts as I/O), and dynamic dispatch
through callbacks is matched by callable-attribute *name* (e.g.
``self._update_shard_ack(...)``). Non-blocking try-locks
(``acquire(blocking=False)``) are exempt.

A copy of the reference package's ``analysis/lock_order.py``, scanning
the port's tree (``SCOPE_DIRS``, ``SCOPE_FILES``); its accepted findings
live in ``cadence_tpu_torch/analysis/lock_baseline.json``.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Set, Tuple

from .findings import Finding

# threading primitives AND the tracked factory (utils/locks.py):
# sanitizer-instrumented construction sites must stay in the same
# inventory/inversion proof as raw threading ones
LOCK_FACTORIES = {"Lock", "RLock", "Condition",
                  "make_lock", "make_rlock", "make_condition"}

# method names that are store/persistence I/O wherever they appear
STORE_METHODS = {
    "update_shard", "create_shard", "get_shard",
    "append_history_nodes", "read_history_branch", "new_history_branch",
    "get_workflow_execution", "update_workflow_execution",
    "create_workflow_execution", "delete_workflow_execution",
    "get_transfer_tasks", "get_timer_tasks",
    "range_complete_transfer_tasks", "range_complete_timer_tasks",
    "complete_transfer_task", "complete_timer_task",
    "list_domains", "get_domain", "update_domain",
    "put_checkpoint", "list_checkpoints", "list_tree_checkpoints",
    "delete_checkpoint", "prune_tree",
    "execute", "executemany", "executescript", "commit",
}

# receiver-chain substrings that mark a call as store I/O
STORE_RECEIVERS = ("persistence", "_conn", ".store", ".shard.")

ALWAYS_BLOCKING_ATTRS = {"sleep", "join"}

# lock-protocol attrs never treated as cross-class method calls
_LOCK_OPS = {"acquire", "release", "wait", "notify", "notify_all",
             "locked"}

# names shared with builtin container/string/file protocols: a
# same-named scope method is coincidence, not a resolution target
# (``failures.append(...)`` is a list, not TaskWriter.append)
_BUILTIN_METHOD_NAMES = {
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "update", "get", "put", "add", "discard", "setdefault", "keys",
    "values", "items", "sort", "reverse", "count", "index", "copy",
    "split", "rsplit", "join", "strip", "lstrip", "rstrip", "replace",
    "format", "encode", "decode", "startswith", "endswith", "lower",
    "upper", "read", "write", "close", "flush", "seek",
}

# callable-attribute name fragments treated as blocking when invoked
BLOCKING_CALLABLE_HINTS = ("update_shard",)


def _dotted(node: ast.expr) -> str:
    """Best-effort dotted string of an expression ("self._lock",
    "self.persistence.shard.update_shard", "ctx.lock")."""
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
class BlockingCall:
    receiver: str
    lineno: int
    why: str


def _blocking_reason(
    node: ast.Call, held: Tuple[str, ...], queue_attrs: Set[str]
) -> Optional[str]:
    """Why this call is blocking, or None."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        recv = _dotted(fn.value)
        attr = fn.attr
        if attr in ALWAYS_BLOCKING_ATTRS:
            return f"{recv}.{attr}() blocks"
        if attr == "wait":
            # waiting on the condition you hold releases it; anything
            # else parks the thread with the lock still held
            if recv in held:
                return None
            return f"{recv}.wait() parks the thread while locked"
        if attr == "acquire":
            for kw in node.keywords:
                if (
                    kw.arg == "blocking"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is False
                ):
                    return None
            if recv in held:
                return None  # re-entrant acquire of the held lock
            return None  # plain acquire handled as a lock edge, not I/O
        if attr in ("get", "put") and recv.rsplit(".", 1)[-1] in queue_attrs:
            for kw in node.keywords:
                if kw.arg == "block" and isinstance(
                    kw.value, ast.Constant
                ) and kw.value.value is False:
                    return None
                if kw.arg == "timeout" and isinstance(
                    kw.value, ast.Constant
                ) and kw.value.value == 0:
                    return None
            return f"queue {recv}.{attr}() can block on capacity"
        if attr in STORE_METHODS:
            return f"store I/O {recv}.{attr}(...)"
        if any(s in recv for s in STORE_RECEIVERS):
            # receiver chain names a store manager: any method on it is
            # I/O even if the name isn't in STORE_METHODS
            return f"store I/O {recv}.{attr}(...)"
    elif isinstance(fn, ast.Name):
        pass
    # callable attributes by name: self._update_shard_ack(...)
    if isinstance(fn, ast.Attribute) and any(
        h in fn.attr for h in BLOCKING_CALLABLE_HINTS
    ):
        return f"callable {_dotted(fn)}(...) persists shard state"
    return None


@dataclasses.dataclass
class MethodInfo:
    qualname: str               # Class.method or function name
    acquires: Set[str]          # lock attrs acquired anywhere (self-relative)
    blocking: List[BlockingCall]            # blocking calls ANYWHERE in body
    under_lock: List[Tuple[str, BlockingCall]]   # (held lock, call)
    edges: List[Tuple[str, str, int]]       # (held, acquired, lineno)
    self_calls_under_lock: List[Tuple[str, str, int]]  # (held, method, line)
    # every self.method() call anywhere in the body — the same-class
    # closure that lets edge propagation see a lock acquired two
    # helper hops below the held region
    self_calls: Set[str] = dataclasses.field(default_factory=set)
    # every foreign-receiver method call anywhere in the body (same
    # name filters as ext_calls_under_lock) — the cross-class closure
    # input: ctx.persist() acquiring the shard lock two classes away
    ext_calls: Set[str] = dataclasses.field(default_factory=set)
    # (held lock, method name, lineno, receiver, blocking-classified)
    # for non-self receivers — resolved cross-class by name in
    # collect_findings. Blocking-classified calls still propagate lock
    # EDGES (store I/O acquires the store's lock) but are not
    # re-reported as LOCK-CROSS-BLOCKING (already a LOCK-BLOCKING)
    ext_calls_under_lock: List[
        Tuple[str, str, int, str, bool]
    ] = dataclasses.field(default_factory=list)
    # (held lock, class name, lineno) for ClassName(...) constructor
    # calls under a held lock — construction that leases from the
    # store (TaskListManager) acquires locks the caller must order
    ctor_calls_under_lock: List[Tuple[str, str, int]] = dataclasses.field(
        default_factory=list
    )
    # every ClassName(...) call anywhere in the body (closure input)
    ctor_calls: Set[str] = dataclasses.field(default_factory=set)


class _MethodVisitor(ast.NodeVisitor):
    def __init__(self, qualname: str, lock_names: Set[str],
                 queue_attrs: Set[str]) -> None:
        self.info = MethodInfo(
            qualname=qualname, acquires=set(), blocking=[],
            under_lock=[], edges=[], self_calls_under_lock=[],
        )
        self.lock_names = lock_names
        self.queue_attrs = queue_attrs
        self.held: List[str] = []

    # -- helpers -------------------------------------------------------

    def _is_known_lock(self, dotted: str) -> bool:
        last = dotted.rsplit(".", 1)[-1]
        return last in self.lock_names or _lockish_name(last)

    def _enter_lock(self, dotted: str, body, lineno: int) -> None:
        if self.held:
            self.info.edges.append((self.held[-1], dotted, lineno))
        self.info.acquires.add(dotted)
        self.held.append(dotted)
        for stmt in body:
            self.visit(stmt)
        self.held.pop()

    # -- visitors ------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        lock_expr = None
        for item in node.items:
            d = _dotted(item.context_expr)
            if self._is_known_lock(d):
                lock_expr = d
                break
        if lock_expr is not None:
            self._enter_lock(lock_expr, node.body, node.lineno)
        else:
            self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        reason = _blocking_reason(node, tuple(self.held), self.queue_attrs)
        if reason is not None:
            call = BlockingCall(
                receiver=_dotted(node.func), lineno=node.lineno, why=reason
            )
            self.info.blocking.append(call)
            if self.held:
                self.info.under_lock.append((self.held[-1], call))
        # blocking .acquire() of another lock while one is held = edge
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "acquire"
        ):
            recv = _dotted(node.func.value)
            nonblocking = any(
                kw.arg == "blocking"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is False
                for kw in node.keywords
            )
            if not nonblocking and self._is_known_lock(recv):
                if self.held and recv != self.held[-1]:
                    self.info.edges.append(
                        (self.held[-1], recv, node.lineno)
                    )
                self.info.acquires.add(recv)
        # self.method(...) under a held lock → propagation candidate
        if (
            isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "self"
        ):
            self.info.self_calls.add(node.func.attr)
            if self.held:
                self.info.self_calls_under_lock.append(
                    (self.held[-1], node.func.attr, node.lineno)
                )
        # any OTHER receiver's method under a held lock → cross-class
        # propagation candidate (resolved by name in collect_findings);
        # calls already classified blocking above are not re-recorded
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr not in _LOCK_OPS
            and node.func.attr not in _BUILTIN_METHOD_NAMES
        ):
            recv = _dotted(node.func.value)
            if recv != "self" and not recv.startswith("super()"):
                self.info.ext_calls.add(node.func.attr)
                if self.held:
                    self.info.ext_calls_under_lock.append(
                        (self.held[-1], node.func.attr, node.lineno,
                         recv, reason is not None)
                    )
        elif isinstance(node.func, ast.Name) and node.func.id[:1].isupper():
            # ClassName(...) — scope-class construction resolves to
            # __init__ (a constructor that leases from the store
            # acquires the store lock under whatever the caller holds)
            self.info.ctor_calls.add(node.func.id)
            if self.held:
                self.info.ctor_calls_under_lock.append(
                    (self.held[-1], node.func.id, node.lineno)
                )
        self.generic_visit(node)


def _lockish_name(name: str) -> bool:
    """Does this attribute name look like a lock/condition object?"""
    n = name.rsplit(".", 1)[-1]
    return (
        "lock" in n
        or n.lstrip("_") in ("cond", "condition", "cv")
        or n.endswith("_cond")
    )


@dataclasses.dataclass
class ClassAnalysis:
    module: str
    name: str
    lock_attrs: Set[str]
    queue_attrs: Set[str]
    methods: Dict[str, MethodInfo]


def _class_lock_attrs(cls: ast.ClassDef) -> Tuple[Set[str], Set[str]]:
    locks: Set[str] = set()
    queues: Set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        v = node.value
        if not isinstance(v, ast.Call):
            continue
        fname = (
            v.func.attr if isinstance(v.func, ast.Attribute)
            else v.func.id if isinstance(v.func, ast.Name) else ""
        )
        for tgt in node.targets:
            if (
                isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"
            ):
                if fname in LOCK_FACTORIES:
                    locks.add(tgt.attr)
                elif fname == "Queue":
                    queues.add(tgt.attr)
            elif isinstance(tgt, ast.Name) and fname in LOCK_FACTORIES:
                locks.add(tgt.id)
    return locks, queues


def analyze_module(source: str, relmodule: str) -> List[ClassAnalysis]:
    tree = ast.parse(source)
    out: List[ClassAnalysis] = []
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        locks, queues = _class_lock_attrs(node)
        methods: Dict[str, MethodInfo] = {}
        for item in node.body:
            if isinstance(item, ast.FunctionDef):
                v = _MethodVisitor(
                    f"{node.name}.{item.name}", locks, queues
                )
                for stmt in item.body:
                    v.visit(stmt)
                methods[item.name] = v.info
        out.append(ClassAnalysis(
            module=relmodule, name=node.name,
            lock_attrs=locks, queue_attrs=queues, methods=methods,
        ))
    return out


def _lock_id(cls: ClassAnalysis, dotted: str) -> str:
    """Stable lock identity: module:Class.attr for self locks, else the
    dotted expression itself."""
    last = dotted.rsplit(".", 1)[-1]
    if dotted.startswith("self.") and last in cls.lock_attrs:
        return f"{cls.module}:{cls.name}.{last}"
    return f"{cls.module}:{cls.name}:{dotted}"


def collect_findings(classes: List[ClassAnalysis]) -> List[Finding]:
    findings, _ = collect_graph(classes)
    return findings


def collect_graph(
    classes: List[ClassAnalysis],
) -> Tuple[List[Finding], Dict[Tuple[str, str], str]]:
    """(findings, acquisition-order edge map). The edge map — lock id
    pair → first witnessing site — is the static half of the
    bidirectional lock proof: the runtime witness cross-validates its
    observed edges against it (``testing/race_witness.cross_validate``)
    and ``--emit-lock-graph`` publishes it."""
    findings: List[Finding] = []
    # edge map for inversion detection across the whole scope
    edges: Dict[Tuple[str, str], str] = {}

    # cross-class resolution index: method name → defining scope classes
    defs: Dict[str, List[Tuple[ClassAnalysis, MethodInfo]]] = {}
    by_name: Dict[str, ClassAnalysis] = {}
    for cls in classes:
        by_name.setdefault(cls.name, cls)
        for mname, info in cls.methods.items():
            defs.setdefault(mname, []).append((cls, info))

    # multi-candidate resolution guard: a name defined by several
    # scope classes resolves to ALL of them only when every definer is
    # a persistence-store class (the memory/sqlite manager twins and
    # the checkpoint stores share every verb; either may be behind a
    # store receiver, so edge extraction wants the may-union). Any
    # other collision ("merge" on Histogram vs ReshardCoordinator)
    # stays unresolved — name resolution is not type inference.
    _STORE_MODULES = ("cadence_tpu_torch/runtime/persistence/",
                      "cadence_tpu_torch/checkpoint/")

    def resolve_cands(callee: str) -> List[Tuple[ClassAnalysis, MethodInfo]]:
        cands = defs.get(callee, [])
        if len(cands) <= 1:
            return cands
        if all(
            c[0].module.startswith(_STORE_MODULES) for c in cands
        ):
            return cands
        return []

    # same-class acquisition closure: a callee's lock acquisitions
    # include everything its own self-calls acquire, to any depth —
    # without this, ``with ctx.lock: shard.assign_task_ids(...)`` never
    # produced the ctx.lock → ShardContext._lock edge (assign_task_ids
    # only acquires through next_task_id), and the runtime witness
    # proved the hole by observing edges the static graph lacked
    closure_memo: Dict[Tuple[int, str], Set[Tuple[str, str]]] = {}

    def _eff(
        cls: ClassAnalysis, mname: str,
        stack: Set[Tuple[int, str]],
    ) -> Tuple[Set[Tuple[str, str]], bool]:
        """(closure, tainted). ``tainted`` means a cycle cut truncated
        this computation — such a result is correct for the CURRENT
        root but must not be memoized, or the truncation would leak
        into unrelated callers (a caller of B.n computed while A.m was
        on the stack would permanently miss everything behind A.m)."""
        key = (id(cls), mname)
        hit = closure_memo.get(key)
        if hit is not None:
            return hit, False
        info = cls.methods.get(mname)
        if info is None:
            return set(), False
        if key in stack:
            return {
                (_lock_id(cls, a), f"{cls.name}.{mname}")
                for a in info.acquires
            }, True
        stack.add(key)
        out = {
            (_lock_id(cls, a), f"{cls.name}.{mname}")
            for a in info.acquires
        }
        tainted = False
        for callee in info.self_calls:
            if callee != mname and callee in cls.methods:
                sub, t = _eff(cls, callee, stack)
                out |= sub
                tainted |= t
        for callee in info.ext_calls:
            for tcls, _ in resolve_cands(callee):
                if tcls is not cls:
                    sub, t = _eff(tcls, callee, stack)
                    out |= sub
                    tainted |= t
        for cname in info.ctor_calls:
            tcls = by_name.get(cname)
            if tcls is not None and tcls is not cls:
                sub, t = _eff(tcls, "__init__", stack)
                out |= sub
                tainted |= t
        stack.discard(key)
        if not tainted:
            closure_memo[key] = out
        return out, tainted

    def eff_acquires(
        cls: ClassAnalysis, mname: str,
    ) -> Set[Tuple[str, str]]:
        """Lock IDS transitively acquired by Class.mname: its own
        acquisitions (id-resolved against its class) plus everything
        reachable through same-class self-calls, unambiguously
        resolved foreign-receiver calls, and scope-class constructor
        calls; cycles cut at the recursion point."""
        out, _ = _eff(cls, mname, set())
        return out

    for cls in classes:
        for mname, info in cls.methods.items():
            # direct blocking calls under a held lock
            for held, call in info.under_lock:
                findings.append(Finding(
                    "LOCK-BLOCKING",
                    f"{cls.module}:{cls.name}.{mname}:"
                    f"{held.rsplit('.', 1)[-1]}:"
                    f"{call.receiver.rsplit('.', 1)[-1]}",
                    f"{cls.module}:{call.lineno}: {cls.name}.{mname} "
                    f"holds {held} while {call.why}",
                ))
            # self-calls under lock into methods that block anywhere
            for held, callee, line in info.self_calls_under_lock:
                target = cls.methods.get(callee)
                if target is None:
                    continue
                if target.blocking and not target.under_lock:
                    why = target.blocking[0].why
                    findings.append(Finding(
                        "LOCK-BLOCKING",
                        f"{cls.module}:{cls.name}.{mname}:"
                        f"{held.rsplit('.', 1)[-1]}:{callee}",
                        f"{cls.module}:{line}: {cls.name}.{mname} holds "
                        f"{held} while calling self.{callee}() which "
                        f"does blocking work ({why})",
                    ))
                # lock edges through the callee (call closure)
                a = _lock_id(cls, held)
                for b, via in eff_acquires(cls, callee):
                    if a != b:
                        edges.setdefault(
                            (a, b),
                            f"{cls.module}:{line} "
                            f"({cls.name}.{mname} → self.{callee} "
                            f"[{via}])",
                        )
            # cross-class propagation: a non-self receiver's method,
            # resolved by name against the scope classes — blocking
            # work in the callee fires at the caller, and the callee's
            # lock acquisitions join the inversion graph. Ambiguous
            # names (several scope classes, disagreeing behavior) are
            # skipped: name resolution is not type inference.
            for held, callee, line, recv, blocked in (
                info.ext_calls_under_lock
            ):
                cands = defs.get(callee, [])
                if not cands:
                    continue
                blocking = [
                    c for c in cands
                    if c[1].blocking or c[1].under_lock
                ]
                if not blocked and (
                    len(cands) == 1 or len(blocking) == len(cands)
                ):
                    # already reported as LOCK-BLOCKING when blocked —
                    # the call still propagates edges below
                    if blocking:
                        tcls, tinfo = blocking[0]
                        why = (
                            tinfo.blocking[0].why if tinfo.blocking
                            else tinfo.under_lock[0][1].why
                        )
                        findings.append(Finding(
                            "LOCK-CROSS-BLOCKING",
                            f"{cls.module}:{cls.name}.{mname}:"
                            f"{held.rsplit('.', 1)[-1]}:{callee}",
                            f"{cls.module}:{line}: {cls.name}.{mname} "
                            f"holds {held} while calling "
                            f"{recv}.{callee}() → {tcls.name}.{callee}"
                            f" which does blocking work ({why})",
                        ))
                a = _lock_id(cls, held)
                for tcls, _ in resolve_cands(callee):
                    if tcls is cls:
                        continue
                    for b, via in eff_acquires(tcls, callee):
                        if a != b:
                            edges.setdefault(
                                (a, b),
                                f"{cls.module}:{line} ({cls.name}."
                                f"{mname} → {tcls.name}.{callee} "
                                f"[{via}])",
                            )
            # constructor calls under lock: the constructed class's
            # __init__ closure (a store-leasing constructor acquires
            # the store lock under whatever the caller holds)
            for held, cname, line in info.ctor_calls_under_lock:
                tcls = by_name.get(cname)
                if tcls is None or tcls is cls:
                    continue
                a = _lock_id(cls, held)
                for b, via in eff_acquires(tcls, "__init__"):
                    if a != b:
                        edges.setdefault(
                            (a, b),
                            f"{cls.module}:{line} ({cls.name}.{mname} "
                            f"→ {cname}() [{via}])",
                        )
            # direct nesting edges
            for held, acquired, line in info.edges:
                a, b = _lock_id(cls, held), _lock_id(cls, acquired)
                if a != b:
                    edges.setdefault(
                        (a, b),
                        f"{cls.module}:{line} ({cls.name}.{mname})",
                    )

    # inversions: both A→B and B→A observed anywhere in scope
    reported: Set[Tuple[str, str]] = set()
    for (a, b), where in sorted(edges.items()):
        if (b, a) in edges and (b, a) not in reported:
            reported.add((a, b))
            findings.append(Finding(
                "LOCK-INVERSION",
                f"inversion:{min(a, b)}<->{max(a, b)}",
                f"inconsistent acquisition order: {a} → {b} at {where} "
                f"but {b} → {a} at {edges[(b, a)]} — deadlock-capable",
            ))
    return findings, edges


SCOPE_DIRS = ("cadence_tpu_torch/runtime", "cadence_tpu_torch/checkpoint",
              "cadence_tpu_torch/matching",
              # the serving edge — frontend handlers, the
              # routed/retrying clients (stub caches, resolver
              # listeners), and the rpc plane were unscanned lock
              # sites until the runtime witness demanded parity
              "cadence_tpu_torch/frontend", "cadence_tpu_torch/client",
              "cadence_tpu_torch/rpc",
              # the resident serving engine's lane-table lock
              "cadence_tpu_torch/serving")

# single files outside the scanned packages that grew locks (the
# telemetry plane: the flight-recorder ring and the registry series
# map) — every serving thread passes through these under load, so
# their locks belong in the same inventory/inversion proof
SCOPE_FILES = ("cadence_tpu_torch/utils/tracing.py",
               "cadence_tpu_torch/utils/metrics.py")


def scope_classes(repo_root: str) -> List[ClassAnalysis]:
    classes: List[ClassAnalysis] = []
    for scope in SCOPE_DIRS:
        base = os.path.join(repo_root, scope)
        if not os.path.isdir(base):
            continue
        for dirpath, _, files in os.walk(base):
            for fname in sorted(files):
                if not fname.endswith(".py"):
                    continue
                fpath = os.path.join(dirpath, fname)
                rel = os.path.relpath(fpath, repo_root)
                with open(fpath) as f:
                    classes += analyze_module(f.read(), rel)
    for rel in SCOPE_FILES:
        fpath = os.path.join(repo_root, rel)
        if os.path.isfile(fpath):
            with open(fpath) as f:
                classes += analyze_module(f.read(), rel)
    return classes


def run(repo_root: str) -> List[Finding]:
    return collect_findings(scope_classes(repo_root))


# --------------------------------------------------------------------------
# static graph export + runtime cross-validation support
# --------------------------------------------------------------------------


@dataclasses.dataclass
class LockGraph:
    """The whole static lock picture for one tree: inventory (lock id →
    owning class), acquisition-order edges (id pair → witnessing
    site), and the Pass 3 findings."""

    locks: Dict[str, str]                  # lock id → module:Class
    edges: Dict[Tuple[str, str], str]      # (a, b) → where
    findings: List[Finding]


def build_graph(repo_root: str) -> LockGraph:
    classes = scope_classes(repo_root)
    findings, edges = collect_graph(classes)
    locks: Dict[str, str] = {}
    for cls in classes:
        for attr in sorted(cls.lock_attrs):
            locks[f"{cls.module}:{cls.name}.{attr}"] = (
                f"{cls.module}:{cls.name}"
            )
    return LockGraph(locks=locks, edges=edges, findings=findings)


def _norm_lock_id(lock_id: str) -> Tuple[Optional[str], str]:
    """Normalize a lock id to (Class.attr or None, attr).

    Self-attribute ids ("module:Class.attr") carry the owning class;
    caller-relative expression ids ("module:Class:ctx.lock" — the
    holder nested a FOREIGN receiver's lock, owner class unknowable to
    the AST) normalize to attr only."""
    parts = lock_id.split(":")
    if len(parts) >= 3:
        return None, parts[-1].rsplit(".", 1)[-1].rstrip("[]()")
    tail = parts[-1]
    return tail, tail.rsplit(".", 1)[-1]


def _ends_match(runtime_id: str, static_id: str) -> bool:
    r_ca, r_attr = _norm_lock_id(runtime_id)
    s_ca, s_attr = _norm_lock_id(static_id)
    if s_ca is not None and r_ca is not None:
        return s_ca == r_ca
    return s_attr == r_attr


def edge_in_static(
    runtime_edge: Tuple[str, str],
    static_edges: List[Tuple[str, str]],
) -> bool:
    """Does a runtime-observed edge have a static counterpart?

    Matching is at Class.attr granularity when both sides know the
    owning class, attr granularity when the static endpoint is an
    expression id (the AST saw ``ctx.lock``, not the owner class) —
    the same granularity the static inversion proof itself runs at."""
    a, b = runtime_edge
    return any(
        _ends_match(a, sa) and _ends_match(b, sb)
        for sa, sb in static_edges
    )


# rules whose baselined entries the lock-graph artifact annotates
LOCK_RULES = ("LOCK-BLOCKING", "LOCK-CROSS-BLOCKING", "LOCK-INVERSION")

LOCK_GRAPH_SCHEMA = "lock_graph"
WITNESS_SCHEMA = "lock_witness"


def emit_lock_graph(
    repo_root: str,
    path: str,
    witness_path: Optional[str] = None,
    baseline_path: Optional[str] = None,
    graph: Optional[LockGraph] = None,
) -> Dict:
    """Write the versioned lock-graph artifact: the full static
    inventory + edge list, each edge annotated ``observed``
    true/false against the latest runtime witness
    (``build/torch_lock_witness.json``, written by the sanitized tier-1 /
    ``CHAOS_SANITIZE=1`` runs), and every baselined lock finding
    annotated ``observed``/``never-observed`` — turning the
    baseline's prose justifications into machine-checked evidence.

    With no witness artifact on disk the annotations are ``null`` and
    ``witness`` records why — the static half still publishes.
    ``graph`` takes a prebuilt :class:`LockGraph` so a gate that
    already ran the static pass does not re-parse the tree."""
    import fnmatch as _fnmatch
    import json

    from . import artifact
    from .findings import Baseline

    if graph is None:
        graph = build_graph(repo_root)

    witness = None
    witness_note = "no witness artifact (run a sanitized suite first)"
    wpath = witness_path or os.path.join(
        repo_root, "build", "torch_lock_witness.json"
    )
    if os.path.isfile(wpath):
        try:
            witness = artifact.load_artifact(wpath, WITNESS_SCHEMA)
            witness_note = wpath
        except (ValueError, json.JSONDecodeError) as e:
            witness_note = f"witness artifact rejected: {e}"

    observed_edges = []
    blocking_anchors: List[str] = []
    inversion_anchors: List[str] = []
    if witness is not None:
        observed_edges = [(e["a"], e["b"]) for e in witness["edges"]]
        blocking_anchors = [
            b["anchor"] for b in witness.get("blocking", [])
        ]
        inversion_anchors = [
            f["anchor"] for f in witness.get("findings", [])
            if f["rule"] == "RUNTIME-LOCK-INVERSION"
        ]

    def _edge_observed(a: str, b: str):
        if witness is None:
            return None
        return any(
            _ends_match(ra, a) and _ends_match(rb, b)
            for ra, rb in observed_edges
        )

    def _entry_observed(rule: str, anchor: str):
        if witness is None:
            return None
        if rule == "LOCK-INVERSION":
            # runtime inversion anchors carry a "runtime-" prefix on
            # top of the static "inversion:..." shape — strip it so a
            # baselined static inversion can actually match
            pool = [
                a[len("runtime-"):] if a.startswith("runtime-") else a
                for a in inversion_anchors
            ]
        else:
            pool = blocking_anchors
        return any(
            _fnmatch.fnmatchcase(runtime_anchor, anchor)
            for runtime_anchor in pool
        )

    baseline = Baseline()
    bpath = baseline_path or os.path.join(
        repo_root, "cadence_tpu_torch", "analysis", "lock_baseline.json"
    )
    if os.path.isfile(bpath):
        baseline = Baseline.load(bpath)

    lock_findings = [f for f in graph.findings if f.rule in LOCK_RULES]
    entries = []
    for e in baseline.entries:
        if e.rule not in LOCK_RULES:
            continue
        obs = _entry_observed(e.rule, e.anchor)
        entries.append({
            "rule": e.rule,
            "anchor": e.anchor,
            "justification": e.justification,
            "matches_static": sum(
                1 for f in lock_findings if e.matches(f)
            ),
            "observed": obs,
            "status": (
                "unknown" if obs is None
                else "observed" if obs else "never-observed"
            ),
        })

    runtime_only = []
    if witness is not None:
        static_edge_keys = list(graph.edges)
        runtime_only = [
            {"a": a, "b": b}
            for a, b in observed_edges
            if not edge_in_static((a, b), static_edge_keys)
        ]

    doc = {
        "locks": [
            {"id": lock_id, "owner": owner}
            for lock_id, owner in sorted(graph.locks.items())
        ],
        "edges": [
            {
                "a": a, "b": b, "where": where,
                "observed": _edge_observed(a, b),
            }
            for (a, b), where in sorted(graph.edges.items())
        ],
        "findings": [
            {"rule": f.rule, "anchor": f.anchor}
            for f in lock_findings
        ],
        "baseline_entries": entries,
        "runtime_only_edges": runtime_only,
        "witness": witness_note,
    }
    artifact.write_artifact(path, LOCK_GRAPH_SCHEMA, doc)
    return doc
