"""AST extraction of the host oracle's transition table.

Three extractors, all purely syntactic (no imports of the target
modules, so a broken tree still lints):

* :func:`extract_event_dispatch` — the ``et == EventType.X`` /
  ``et in (EventType.A, ...)`` if/elif chain of a function body
  (``StateBuilder.apply_events`` here, reused for ``pack_workflow``),
  returning {event-type name → branch info (handler calls, is_noop)}.
* :func:`extract_replicate_writes` — per ``MutableState.replicate_*``
  method: which pending-map tables it touches and which
  ``execution_info`` fields it assigns, with a same-class call closure
  so ``replicate_decision_task_completed_event → _delete_decision``
  attributes the delete's writes to the replicate method.
* :func:`extract_rel_ts_attrs` — which ``attrs[i]`` slots
  ``pack_workflow`` fills from ``rel_ts(...)`` per event type: those
  event columns carry epoch-relative timestamps onto the device, so
  any state column derived from them is epoch-bearing.

A copy of the reference package's ``analysis/oracle_ast.py``; the gate
points it at the port's ``core/state_builder.py``,
``core/mutable_state.py`` and ``ops/pack.py``.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

# oracle pending-map attribute → schema table name
PENDING_TABLES = {
    "pending_activities": "activities",
    "pending_timers": "timers",
    "pending_children": "children",
    "pending_request_cancels": "cancels",
    "pending_signals": "signals",
}


@dataclasses.dataclass
class Branch:
    """One arm of the event-type dispatch chain."""

    types: Tuple[str, ...]          # EventType member names
    handler_calls: Tuple[str, ...]  # ms.replicate_* method names called
    is_noop: bool                   # body is (effectively) `pass`


def _event_types_of(test: ast.expr) -> Optional[Tuple[str, ...]]:
    """EventType names matched by an if/elif test, or None if the test
    isn't an event-type dispatch."""

    def name_of(node: ast.expr) -> Optional[str]:
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id in ("EventType", "E")
        ):
            return node.attr
        return None

    if not isinstance(test, ast.Compare) or len(test.ops) != 1:
        return None
    op = test.ops[0]
    rhs = test.comparators[0]
    if isinstance(op, ast.Eq):
        n = name_of(rhs)
        return (n,) if n else None
    if isinstance(op, ast.In) and isinstance(rhs, (ast.Tuple, ast.List)):
        names = [name_of(e) for e in rhs.elts]
        if all(names):
            return tuple(names)
    return None


def _calls_on(body: List[ast.stmt], receiver: str, prefix: str) -> List[str]:
    out: List[str] = []
    for node in ast.walk(ast.Module(body=body, type_ignores=[])):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == receiver
            and node.func.attr.startswith(prefix)
        ):
            out.append(node.func.attr)
    return out


def extract_event_dispatch(
    source: str,
    func_name: str = "apply_events",
    receiver: str = "ms",
    call_prefix: str = "replicate_",
) -> Dict[str, Branch]:
    """Parse the event-type dispatch chain of ``func_name``.

    Returns {EventType name → Branch}. Types not present raise-by-default
    in the oracle (``else: raise``) and are simply absent here.
    """
    tree = ast.parse(source)
    fn = None
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == func_name:
            fn = node
            break
    if fn is None:
        raise ValueError(f"no function {func_name!r} in source")

    table: Dict[str, Branch] = {}

    def walk_chain(stmt: ast.If) -> None:
        cur: Optional[ast.stmt] = stmt
        while isinstance(cur, ast.If):
            types = _event_types_of(cur.test)
            if types is not None:
                calls = tuple(_calls_on(cur.body, receiver, call_prefix))
                is_noop = not calls and all(
                    isinstance(s, (ast.Pass, ast.Expr)) for s in cur.body
                )
                for t in types:
                    table[t] = Branch(types, calls, is_noop)
            nxt = cur.orelse
            cur = nxt[0] if len(nxt) == 1 else None

    for node in ast.walk(fn):
        if isinstance(node, ast.If) and _event_types_of(node.test) is not None:
            # only take top chains (an elif arm is reachable from its
            # parent's orelse; walking it again is harmless — same data)
            walk_chain(node)
    return table


# --------------------------------------------------------------------------
# MutableState replicate-method write sets
# --------------------------------------------------------------------------


@dataclasses.dataclass
class WriteSet:
    tables: Set[str] = dataclasses.field(default_factory=set)
    exec_fields: Set[str] = dataclasses.field(default_factory=set)


def _method_writes(fn: ast.FunctionDef) -> Tuple[WriteSet, Set[str]]:
    """Direct writes of one method + names of self-methods it calls."""
    ws = WriteSet()
    calls: Set[str] = set()
    # aliases of self.execution_info within the method (ei = self.execution_info)
    exec_aliases: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(
            node.value, ast.Attribute
        ):
            v = node.value
            if (
                isinstance(v.value, ast.Name)
                and v.value.id == "self"
                and v.attr == "execution_info"
            ):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        exec_aliases.add(tgt.id)
    for node in ast.walk(fn):
        # pending-map touches (read/write/del all count as "touches")
        if isinstance(node, ast.Attribute) and node.attr in PENDING_TABLES:
            ws.tables.add(PENDING_TABLES[node.attr])
        # execution_info field stores: self.execution_info.f = / ei.f =
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for tgt in targets:
                if not isinstance(tgt, ast.Attribute):
                    continue
                base = tgt.value
                if (
                    isinstance(base, ast.Attribute)
                    and base.attr == "execution_info"
                ) or (
                    isinstance(base, ast.Name) and base.id in exec_aliases
                ):
                    ws.exec_fields.add(tgt.attr)
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "self"
        ):
            calls.add(node.func.attr)
    return ws, calls


def extract_replicate_writes(
    source: str, class_name: str = "MutableState"
) -> Dict[str, WriteSet]:
    """Per-method write sets for ``class_name``, with writes of called
    same-class methods folded in (fixpoint)."""
    tree = ast.parse(source)
    cls = None
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == class_name:
            cls = node
            break
    if cls is None:
        raise ValueError(f"no class {class_name!r} in source")
    direct: Dict[str, WriteSet] = {}
    callees: Dict[str, Set[str]] = {}
    for item in cls.body:
        if isinstance(item, ast.FunctionDef):
            ws, calls = _method_writes(item)
            direct[item.name] = ws
            callees[item.name] = calls

    # fixpoint: fold callee writes into callers
    changed = True
    while changed:
        changed = False
        for m, calls in callees.items():
            ws = direct[m]
            for c in calls:
                if c not in direct:
                    continue
                cw = direct[c]
                if not (cw.tables <= ws.tables) or not (
                    cw.exec_fields <= ws.exec_fields
                ):
                    ws.tables |= cw.tables
                    ws.exec_fields |= cw.exec_fields
                    changed = True
    return direct


# --------------------------------------------------------------------------
# pack_workflow rel_ts attribute slots
# --------------------------------------------------------------------------


def extract_rel_ts_attrs(
    source: str, func_name: str = "pack_workflow"
) -> Dict[str, Set[int]]:
    """{EventType name → attr indices assigned from rel_ts(...)}.

    An ``attrs[i] = ... rel_ts(...) ...`` under an event-type branch
    marks EV_A{i} as epoch-bearing for that type.
    """
    tree = ast.parse(source)
    fn = None
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == func_name:
            fn = node
            break
    if fn is None:
        raise ValueError(f"no function {func_name!r} in source")

    out: Dict[str, Set[int]] = {}

    def has_rel_ts(node: ast.expr) -> bool:
        for n in ast.walk(node):
            if (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Name)
                and n.func.id == "rel_ts"
            ):
                return True
        return False

    def scan_branch(types: Tuple[str, ...], body: List[ast.stmt]) -> None:
        for node in ast.walk(ast.Module(body=body, type_ignores=[])):
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                if (
                    isinstance(tgt, ast.Subscript)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "attrs"
                    and isinstance(tgt.slice, ast.Constant)
                    and isinstance(tgt.slice.value, int)
                    and has_rel_ts(node.value)
                ):
                    for t in types:
                        out.setdefault(t, set()).add(tgt.slice.value)

    def walk_chain(stmt: ast.If) -> None:
        cur: Optional[ast.stmt] = stmt
        while isinstance(cur, ast.If):
            types = _event_types_of(cur.test)
            if types is not None:
                scan_branch(types, cur.body)
            nxt = cur.orelse
            cur = nxt[0] if len(nxt) == 1 else None

    for node in ast.walk(fn):
        if isinstance(node, ast.If) and _event_types_of(node.test) is not None:
            walk_chain(node)
    return out


def extract_attr_indices(
    source: str, func_name: str = "pack_workflow"
) -> Set[int]:
    """Every ``attrs[i]`` store index in ``func_name`` — checked against
    the schema's EV_A0..EV_A7 window (an out-of-window write would be
    silently dropped by the row constructor or corrupt a neighbor)."""
    tree = ast.parse(source)
    fn = None
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == func_name:
            fn = node
            break
    if fn is None:
        raise ValueError(f"no function {func_name!r} in source")
    out: Set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (
                    isinstance(tgt, ast.Subscript)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "attrs"
                    and isinstance(tgt.slice, ast.Constant)
                    and isinstance(tgt.slice.value, int)
                ):
                    out.add(tgt.slice.value)
    return out
