"""Visibility query language: SQL-like WHERE clause → predicate.

Reference: common/elasticsearch/esql/esql.go — Cadence's advanced
visibility accepts `ListWorkflowExecutions(query="WorkflowType = 'x'
AND CloseTime > 0 ORDER BY StartTime DESC")`; the reference translates
SQL to an Elasticsearch DSL, this build compiles the same grammar to a
Python predicate + sort key applied by the advanced store.

Grammar (the subset the reference's esql supports for visibility):
    query  := expr [ORDER BY ident [ASC|DESC]]
    expr   := term (OR term)*
    term   := factor (AND factor)*
    factor := '(' expr ')' | NOT factor | comparison
    comp   := ident op value | ident BETWEEN value AND value
              | ident IN (value, ...)
    op     := = | != | <> | > | >= | < | <=

A copy of the reference package's ``visibility/query.py``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, List, Optional, Tuple

from ..runtime.api import BadRequestError
from ..runtime.persistence.records import VisibilityRecord


class QueryError(BadRequestError):
    """Malformed visibility query — a CLIENT error (maps to
    INVALID_ARGUMENT over RPC), never an internal fault."""


_TOKEN_RE = re.compile(
    r"""
    \s*(?:
        (?P<lparen>\() |
        (?P<rparen>\)) |
        (?P<comma>,) |
        (?P<op><>|!=|>=|<=|=|>|<) |
        (?P<string>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*") |
        (?P<number>-?\d+(?:\.\d+)?) |
        (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    )
    """,
    re.VERBOSE,
)

_KEYWORDS = {"AND", "OR", "NOT", "BETWEEN", "IN", "ORDER", "BY", "ASC", "DESC"}

# close-status names accepted as string literals (reference esql maps
# e.g. CloseStatus = 'COMPLETED' to the int column)
_CLOSE_STATUS_NAMES = {
    "COMPLETED": 1,
    "FAILED": 2,
    "CANCELED": 3,
    "TERMINATED": 4,
    "CONTINUED_AS_NEW": 5,
    "TIMED_OUT": 6,
}


def _tokenize(s: str) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    pos = 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if m is None or m.end() == pos:
            rest = s[pos:].strip()
            if not rest:
                break
            raise QueryError(f"cannot tokenize near {rest[:20]!r}")
        pos = m.end()
        kind = m.lastgroup
        text = m.group(kind)
        if kind == "ident" and text.upper() in _KEYWORDS:
            out.append(("kw", text.upper()))
        elif kind == "string":
            out.append(("value", text[1:-1].replace("\\'", "'").replace('\\"', '"')))
        elif kind == "number":
            out.append(("value", float(text) if "." in text else int(text)))
        else:
            out.append((kind, text))
    return out


def _field_getter(name: str) -> Callable[[VisibilityRecord], Any]:
    system = {
        "domainid": lambda r: r.domain_id,
        "workflowid": lambda r: r.workflow_id,
        "runid": lambda r: r.run_id,
        "workflowtype": lambda r: r.workflow_type,
        "starttime": lambda r: r.start_time,
        "executiontime": lambda r: r.execution_time,
        "closetime": lambda r: r.close_time,
        "closestatus": lambda r: r.close_status,
        "historylength": lambda r: r.history_length,
    }
    getter = system.get(name.lower())
    if getter is not None:
        return getter
    return lambda r: r.search_attributes.get(name)


def _coerce(field: str, value: Any) -> Any:
    if field.lower() == "closestatus" and isinstance(value, str):
        try:
            return _CLOSE_STATUS_NAMES[value.upper()]
        except KeyError:
            raise QueryError(f"unknown close status {value!r}")
    return value


_Pred = Callable[[VisibilityRecord], bool]


class _Parser:
    def __init__(self, tokens: List[Tuple[str, Any]]) -> None:
        self.tokens = tokens
        self.i = 0

    def peek(self) -> Optional[Tuple[str, Any]]:
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def next(self) -> Tuple[str, Any]:
        tok = self.peek()
        if tok is None:
            raise QueryError("unexpected end of query")
        self.i += 1
        return tok

    def expect(self, kind: str, value: Any = None) -> Tuple[str, Any]:
        tok = self.next()
        if tok[0] != kind or (value is not None and tok[1] != value):
            raise QueryError(f"expected {value or kind}, got {tok[1]!r}")
        return tok

    # expr := term (OR term)*
    def expr(self) -> _Pred:
        left = self.term()
        while self.peek() == ("kw", "OR"):
            self.next()
            right = self.term()
            l, left = left, None
            left = (lambda a, b: lambda r: a(r) or b(r))(l, right)
        return left

    # term := factor (AND factor)*
    def term(self) -> _Pred:
        left = self.factor()
        while self.peek() == ("kw", "AND"):
            self.next()
            right = self.factor()
            l, left = left, None
            left = (lambda a, b: lambda r: a(r) and b(r))(l, right)
        return left

    def factor(self) -> _Pred:
        tok = self.peek()
        if tok == ("kw", "NOT"):
            self.next()
            inner = self.factor()
            return lambda r: not inner(r)
        if tok is not None and tok[0] == "lparen":
            self.next()
            inner = self.expr()
            self.expect("rparen")
            return inner
        return self.comparison()

    def comparison(self) -> _Pred:
        kind, field = self.next()
        if kind != "ident":
            raise QueryError(f"expected attribute name, got {field!r}")
        get = _field_getter(field)
        tok = self.next()
        if tok == ("kw", "BETWEEN"):
            _, low = self.expect("value")
            self.expect("kw", "AND")
            _, high = self.expect("value")
            low = _coerce(field, low)
            high = _coerce(field, high)
            def between(r, low=low, high=high):
                v = get(r)
                if v is None:
                    return False
                try:
                    return low <= v <= high
                except TypeError:
                    return False  # type-mismatched literal: no match

            return between
        if tok == ("kw", "IN"):
            self.expect("lparen")
            values = []
            while True:
                _, v = self.expect("value")
                values.append(_coerce(field, v))
                nxt = self.next()
                if nxt[0] == "rparen":
                    break
                if nxt[0] != "comma":
                    raise QueryError("expected , or ) in IN list")
            vals = set(values)

            def in_pred(r: VisibilityRecord) -> bool:
                try:
                    return get(r) in vals
                except TypeError:
                    return False  # unhashable attr value: no match

            return in_pred
        if tok[0] != "op":
            raise QueryError(f"expected operator after {field!r}")
        op = tok[1]
        _, raw = self.expect("value")
        value = _coerce(field, raw)

        def cmp(r: VisibilityRecord) -> bool:
            v = get(r)
            if v is None:
                return False
            try:
                if op == "=":
                    return v == value
                if op in ("!=", "<>"):
                    return v != value
                if op == ">":
                    return v > value
                if op == ">=":
                    return v >= value
                if op == "<":
                    return v < value
                if op == "<=":
                    return v <= value
            except TypeError:
                return False
            raise QueryError(f"unknown operator {op}")

        return cmp

    def order_by(self) -> Optional[Tuple[str, bool]]:
        if self.peek() != ("kw", "ORDER"):
            return None
        self.next()
        self.expect("kw", "BY")
        _, field = self.expect("ident")
        desc = False
        nxt = self.peek()
        if nxt in (("kw", "ASC"), ("kw", "DESC")):
            self.next()
            desc = nxt[1] == "DESC"
        return field, desc


@dataclasses.dataclass
class VisibilityQuery:
    predicate: _Pred
    order_field: Optional[str] = None
    order_desc: bool = False

    def apply(self, records: List[VisibilityRecord]) -> List[VisibilityRecord]:
        out = [r for r in records if self.predicate(r)]
        if self.order_field:
            get = _field_getter(self.order_field)

            def key(r):
                # type-stable key: mixed-typed search-attribute values
                # must not blow up list.sort with a str-vs-int
                # comparison — but all NUMERIC types (bool/int/float)
                # collapse into one group so 1 sorts before 2.5, not
                # after it by type name. The raw value is kept (Python
                # compares bool/int/float natively): a float() cast
                # would collapse distinct ints above 2^53 — epoch-nanos
                # are ~1.7e18 where float64 granularity is ~190ns
                v = get(r)
                if v is None:
                    return (True, "", 0)
                if isinstance(v, (bool, int, float)):
                    return (False, "\x00number", v)
                return (False, type(v).__name__, v)

            out.sort(key=key, reverse=self.order_desc)
        return out


def compile_query(query: str) -> VisibilityQuery:
    """Compile a WHERE-clause query; empty string matches everything."""
    query = (query or "").strip()
    if not query:
        return VisibilityQuery(predicate=lambda r: True)
    parser = _Parser(_tokenize(query))
    if parser.peek() == ("kw", "ORDER"):
        pred: _Pred = lambda r: True
    else:
        pred = parser.expr()
    order = parser.order_by()
    if parser.peek() is not None:
        raise QueryError(f"trailing tokens near {parser.peek()[1]!r}")
    if order:
        return VisibilityQuery(pred, order[0], order[1])
    return VisibilityQuery(pred)
