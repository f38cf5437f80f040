"""Pass 2 — launch-hazard lint over the kernel stack and its callers.

The port's replay is eager PyTorch around two hand-written CUDA kernels.
Its throughput lives and dies on launch discipline: a host sync
(``.item()``, ``.cpu()``, a Python branch on a tensor) in a function that
launches a kernel stalls the host until the card drains, a dtype that
widens doubles the bytes the replay is bound by, and an int16 narrow
value that enters arithmetic before it is widened corrupts values. Four
rules:

* ``TORCH-HOST-SYNC`` — ``.item()`` / ``.tolist()`` / ``.cpu()`` /
  ``.numpy()``, ``float()`` / ``int()`` / ``bool()`` of a tensor,
  ``torch.cuda.synchronize()``, and ``if``/``while``/conditional tests
  on a tensor inside a function that launches a port kernel or the task
  refresh (``LAUNCH_ROOTS``), closed over same-module calls. In eager
  torch a Python branch on tensor data is itself a sync, so the
  reference's ``JIT-HOST-SYNC`` and ``JIT-PY-BRANCH`` are one rule
  here. The plain versions (``*_plain``) are the CPU route and are not
  followed. A value is a tensor when it is a parameter annotated
  ``torch.Tensor``, a ``torch.*`` call, or a name assigned from one of
  those; shape, dtype and device reads are host metadata.
* ``JIT-NARROW-FORCE-WIDE`` — ``narrow_events_teb`` called without
  ``force_wide``: a caller that narrows several batches must say which
  columns stay wide across them.
* ``TORCH-DTYPE-WIDEN`` — one step of ``replay_rows_plain`` on the CPU
  under a ``TorchDispatchMode`` that records every op's output dtype:
  only int32 and bool, plus the int64 index operands of gather and
  scatter (``INDEX_OPS``, ``INDEX_CASTS``); a leaked float or int64
  promotion doubles the bytes the replay streams and breaks bit-parity.
* ``CUDA-INT16-ARITH`` — over ``ops/csrc/*.cu``, token by token (no C++
  parser is needed): a narrow value (a variable or element of type
  ``int16_t``/``short``, or of a template type parameter where the file
  instantiates a template with ``int16_t``) must pass through a widening
  cast before any arithmetic, and no arithmetic result is stored into a
  narrow lvalue (no assignment, compound assignment or ``++``/``--``).
  The narrow event stream is a transfer format, never an arithmetic one.

The reference's ``JIT-SHAPE-ROUND`` is retired: it guards against a
fresh XLA compile for every distinct batch size, and the port has no
such compile — eager torch does not retrace, and each ``.cu`` source is
built once per source hash (``ops/_build.py``) and takes every shape as
a launch parameter.

A copy of the reference package's ``analysis/jit_hazards.py``, with its
rules carried over for eager torch and CUDA.
"""

from __future__ import annotations

import ast
import glob
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .findings import Finding

# functions that launch a port kernel or the refresh, by module
LAUNCH_ROOTS: Dict[str, Tuple[str, ...]] = {
    "cadence_tpu_torch/ops/replay_cuda.py": (
        "replay_rows", "replay_rows_packed", "_launch", "replay_scan_teb",
        "replay_scan_packed"),
    "cadence_tpu_torch/ops/assoc_cuda.py": ("affine_segscan",),
    "cadence_tpu_torch/ops/refresh.py": ("refresh_tasks_device",),
}
# the CPU route of a kernel wrapper: not followed by the closure
PLAIN_SUFFIX = "_plain"

SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
SYNC_CASTS = ("float", "int", "bool")
# tensor attributes and methods that read host metadata, never data
HOST_METADATA = {
    "shape", "dtype", "device", "ndim", "dim", "numel", "size", "stride",
    "data_ptr", "is_contiguous", "element_size", "nelement", "is_cuda",
    "type", "index", "requires_grad",
}
# torch.* calls that return host values
TORCH_HOST_CALLS = {"device", "is_tensor", "get_default_dtype"}


# --------------------------------------------------------------------------
# TORCH-HOST-SYNC
# --------------------------------------------------------------------------


def _module_functions(tree: ast.Module) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def launch_functions(tree: ast.Module, roots: Sequence[str]) -> Set[str]:
    """The roots and every module function they reach through
    same-module calls, the plain versions excepted."""
    fns = _module_functions(tree)
    out = {r for r in roots if r in fns}
    frontier = list(out)
    while frontier:
        cur = frontier.pop()
        for node in ast.walk(fns[cur]):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                callee = node.func.id
                if (callee in fns and callee not in out
                        and not callee.endswith(PLAIN_SUFFIX)):
                    out.add(callee)
                    frontier.append(callee)
    return out


def _is_torch_tensor_annotation(ann: Optional[ast.expr]) -> bool:
    return (isinstance(ann, ast.Attribute) and ann.attr == "Tensor"
            and isinstance(ann.value, ast.Name) and ann.value.id == "torch")


def _torch_call(node: ast.AST) -> bool:
    """A call of ``torch.f(...)`` or ``torch.x.f(...)`` that returns a
    tensor."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    chain = []
    while isinstance(fn, ast.Attribute):
        chain.append(fn.attr)
        fn = fn.value
    return (isinstance(fn, ast.Name) and fn.id == "torch" and bool(chain)
            and chain[0] not in TORCH_HOST_CALLS and "cuda" not in chain)


class _Tensors:
    """Which expressions of one function are tensors."""

    def __init__(self, fn: ast.FunctionDef) -> None:
        self.names: Set[str] = {
            a.arg for a in fn.args.args + fn.args.kwonlyargs
            if _is_torch_tensor_annotation(a.annotation)
        }
        changed = True
        while changed:
            changed = False
            for node in ast.walk(fn):
                if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                    continue
                if node.value is None or not self.expr(node.value):
                    continue
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    for n in ast.walk(tgt):
                        if isinstance(n, ast.Name) and n.id not in self.names:
                            self.names.add(n.id)
                            changed = True

    def expr(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if _torch_call(node):
            return True
        if isinstance(node, ast.Attribute):
            return node.attr not in HOST_METADATA and self.expr(node.value)
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute):
                if fn.attr in HOST_METADATA or fn.attr in SYNC_METHODS:
                    return False
                return self.expr(fn.value)
            return False
        if isinstance(node, ast.Subscript):
            return self.expr(node.value)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return any(self.expr(n) for n in [node.left, *node.comparators])
        if isinstance(node, ast.BinOp):
            return self.expr(node.left) or self.expr(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.expr(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.expr(v) for v in node.values)
        return False


def _lint_launch_fn(fn: ast.FunctionDef, relpath: str,
                    findings: List[Finding]) -> None:
    anchor = f"{relpath}:{fn.name}"
    tensors = _Tensors(fn)
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in SYNC_METHODS:
                findings.append(Finding(
                    "TORCH-HOST-SYNC", f"{anchor}:{f.attr}",
                    f"{relpath}:{node.lineno}: .{f.attr}() in {fn.name}, "
                    "which launches a kernel, copies to the host and waits "
                    "for the card",
                ))
            elif (isinstance(f, ast.Name) and f.id in SYNC_CASTS
                  and node.args and tensors.expr(node.args[0])):
                findings.append(Finding(
                    "TORCH-HOST-SYNC", f"{anchor}:{f.id}",
                    f"{relpath}:{node.lineno}: {f.id}() of a tensor in "
                    f"{fn.name}, which launches a kernel, waits for the "
                    "card",
                ))
            elif (isinstance(f, ast.Attribute) and f.attr == "synchronize"
                  and "cuda" in ast.dump(f.value)):
                findings.append(Finding(
                    "TORCH-HOST-SYNC", f"{anchor}:synchronize",
                    f"{relpath}:{node.lineno}: torch.cuda.synchronize() in "
                    f"{fn.name}, which launches a kernel",
                ))
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            if tensors.expr(node.test):
                findings.append(Finding(
                    "TORCH-HOST-SYNC", f"{anchor}:branch",
                    f"{relpath}:{node.test.lineno}: Python branch on tensor "
                    f"data in {fn.name}, which launches a kernel — the "
                    "test copies the value to the host and waits for the "
                    "card",
                ))


# --------------------------------------------------------------------------
# JIT-NARROW-FORCE-WIDE
# --------------------------------------------------------------------------


def _lint_narrow_force_wide(
    tree: ast.Module, relpath: str, findings: List[Finding]
) -> None:
    seen = 0
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = (
            node.func.id
            if isinstance(node.func, ast.Name)
            else node.func.attr
            if isinstance(node.func, ast.Attribute)
            else ""
        )
        if name != "narrow_events_teb":
            continue
        seen += 1
        if not any(k.arg == "force_wide" for k in node.keywords):
            findings.append(Finding(
                "JIT-NARROW-FORCE-WIDE", f"{relpath}:narrow#{seen}",
                f"{relpath}:{node.lineno}: narrow_events_teb() without "
                "force_wide= — a caller that narrows several batches must "
                "grow the wide-column set monotonically, or say that each "
                "batch carries its own",
            ))


def lint_source(source: str, relpath: str,
                roots: Optional[Sequence[str]] = None) -> List[Finding]:
    """The AST rules over one module's source; ``roots``: its functions
    that launch a kernel (default: ``LAUNCH_ROOTS`` for ``relpath``)."""
    tree = ast.parse(source)
    findings: List[Finding] = []
    if roots is None:
        roots = LAUNCH_ROOTS.get(relpath, ())
    launch = launch_functions(tree, roots)
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in launch:
            _lint_launch_fn(node, relpath, findings)
    _lint_narrow_force_wide(tree, relpath, findings)
    return findings


# --------------------------------------------------------------------------
# TORCH-DTYPE-WIDEN: the replay step's ops under a dispatch mode
# --------------------------------------------------------------------------

ALLOWED_DTYPES = {"torch.int32", "torch.bool"}
# ops that take an int64 index operand, and the casts that make one
INDEX_OPS = {"gather", "scatter", "scatter_", "index_select", "index",
             "index_put", "index_put_", "take_along_dim"}
INDEX_CASTS = {"_to_copy"}


def dtype_findings(records, anchor: str) -> List[Finding]:
    """Findings of (op name, output dtype, consumed only as an index)
    records: any dtype outside int32/bool, save int64 made by an index
    cast and consumed only by index ops."""
    bad: Dict[str, int] = {}
    for op, dt, index_only in records:
        if dt in ALLOWED_DTYPES:
            continue
        if dt == "torch.int64" and op in INDEX_CASTS and index_only:
            continue
        bad[dt] = bad.get(dt, 0) + 1
    return [
        Finding(
            "TORCH-DTYPE-WIDEN", f"{anchor}:{dt.split('.')[-1]}",
            f"{anchor}: {n} op output(s) of dtype {dt} — the replay rows "
            "must stay int32/bool (widening doubles the bytes the replay "
            "streams; floats break bit-parity with the oracle)",
        )
        for dt, n in sorted(bad.items())
    ]


def record_dtypes(fn):
    """Run ``fn()`` under a dispatch mode; returns (fn's result, [(op
    name, output dtype, consumed only as an index operand)])."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class _Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.made: Dict[int, Tuple] = {}
            self.records: List[List] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            for a in tree_flatten((args, kwargs))[0]:
                if isinstance(a, torch.Tensor) and id(a) in self.made:
                    if name not in INDEX_OPS:
                        self.made[id(a)][1][2] = False
            out = func(*args, **kwargs)
            for o in tree_flatten(out)[0]:
                if isinstance(o, torch.Tensor):
                    rec = [name, str(o.dtype), True]
                    self.records.append(rec)
                    if o.dtype == torch.int64:
                        # the tensor is held, so its id is not reused
                        self.made[id(o)] = (o, rec)
            return out

    rec = _Recorder()
    with rec:
        res = fn()
    return res, [tuple(r) for r in rec.records]


def check_step_dtypes() -> List[Finding]:
    """Dtype sweep of one unspecialized plain replay step."""
    import numpy as np
    import torch

    from ..ops import replay_cuda as RC
    from ..ops import schema as S

    caps = S.Capacities(
        max_events=8, max_activities=3, max_timers=2, max_children=2,
        max_request_cancels=2, max_signals_ext=2, max_version_items=2,
    )
    rm = RC.RowMap(caps)
    rows = RC.state_to_rows(S.state_from_numpy(S.empty_state(4, caps),
                                               "cpu"), rm)
    ev = torch.from_numpy(np.zeros((1, S.EV_N, 4), np.int32))
    _, records = record_dtypes(lambda: RC.replay_rows_plain(ev, rows, caps))
    return dtype_findings(records, "ops/replay_cuda.py:replay_rows_plain")


# --------------------------------------------------------------------------
# CUDA-INT16-ARITH: narrow values in the CUDA sources, token by token
# --------------------------------------------------------------------------

NARROW_TYPES = {"int16_t", "short"}
WIDE_TYPES = {"int", "int32_t", "unsigned", "uint32_t", "long", "int64_t",
              "size_t"}
ARITH_OPS = {"+", "-", "*", "/", "%", "<<", ">>", "&", "|", "^"}
COMPOUND_OPS = {"+=", "-=", "*=", "/=", "%=", "<<=", ">>=", "&=", "|=",
                "^="}
_TOKEN = re.compile(
    r"[A-Za-z_]\w*|\d[\w.]*|<<=|>>=|->|::|\+\+|--|<<|>>|[-+*/%&|^!=<>]=|"
    r"&&|\|\||\S")
_OPERATORS = ARITH_OPS | COMPOUND_OPS | {
    "=", "==", "!=", "<", ">", "<=", ">=", "&&", "||", "!", "~", "?", ":",
    "(", "[", "{", ",", ";", "return"}


def cuda_tokens(source: str) -> List[str]:
    """The tokens of a CUDA source: comments, strings and preprocessor
    lines dropped."""
    source = re.sub(r"/\*.*?\*/", " ", source, flags=re.S)
    source = re.sub(r"//[^\n]*", " ", source)
    source = re.sub(r'"(\\.|[^"\\])*"', '""', source)
    source = re.sub(r"^\s*#[^\n]*", " ", source, flags=re.M)
    return _TOKEN.findall(source)


def _units(tokens: List[str]):
    """(name, tokens) of each unit: a header and its brace block (a
    function or a struct), looking inside ``namespace`` and
    ``extern "C"`` blocks."""
    start, depth, transparent = 0, 0, []
    for i, tok in enumerate(tokens):
        if tok == "{":
            head = tokens[start:i]
            if depth == len(transparent) and (
                    "namespace" in head or head[:1] == ["extern"]):
                transparent.append(depth)
                start = i + 1
            depth += 1
        elif tok == "}":
            depth -= 1
            if transparent and depth == transparent[-1]:
                transparent.pop()
                start = i + 1
            elif depth == len(transparent):
                unit = tokens[start:i + 1]
                yield _unit_name(unit), unit
                start = i + 1
        elif tok == ";" and depth == len(transparent):
            start = i + 1


def _unit_name(unit: List[str]) -> str:
    """The last name called at paren depth 0 in the unit's header (a
    function's name), else its last name (a struct's)."""
    head = unit[:unit.index("{")]
    name, last, depth = None, "<unit>", 0
    for i, tok in enumerate(head):
        if tok == "(":
            depth += 1
        elif tok == ")":
            depth -= 1
        elif depth == 0 and re.match(r"[A-Za-z_]\w*$", tok):
            last = tok
            if i + 1 < len(head) and head[i + 1] == "(":
                name = tok
    return name or last


def _narrow_decls(unit: List[str], narrow: Set[str]):
    """(scalars, pointers, [(declared name index, initializer start)]) of
    one unit: names declared with a narrow type."""
    scalars: Set[str] = set()
    pointers: Set[str] = set()
    inits: List[int] = []
    for i, tok in enumerate(unit):
        if tok not in narrow:
            continue
        j = i + 1
        ptr = False
        while j < len(unit) and unit[j] in ("const", "volatile", "*",
                                            "__restrict__", "&"):
            ptr |= unit[j] == "*"
            j += 1
        if j < len(unit) and re.match(r"[A-Za-z_]\w*$", unit[j]) \
                and unit[j] not in narrow:
            (pointers if ptr else scalars).add(unit[j])
            if not ptr and j + 1 < len(unit) and unit[j + 1] == "=":
                inits.append(j + 2)
    return scalars, pointers, inits


def _match(unit: List[str], i: int, open_: str, close: str) -> int:
    depth = 0
    for j in range(i, len(unit)):
        if unit[j] == open_:
            depth += 1
        elif unit[j] == close:
            depth -= 1
            if depth == 0:
                return j
    return len(unit) - 1


def _widened(unit: List[str], i: int) -> bool:
    """Whether the value starting at token ``i`` sits under a widening
    cast: ``(int)v`` or ``static_cast<int>(v)``."""
    if i >= 3 and unit[i - 1] == ")" and unit[i - 2] in WIDE_TYPES:
        return True
    if (i >= 5 and unit[i - 1] == "(" and unit[i - 2] == ">"
            and unit[i - 3] in WIDE_TYPES and unit[i - 4] == "<"
            and unit[i - 5] == "static_cast"):
        return True
    return False


def _rhs_has_arith(unit: List[str], k: int) -> bool:
    """Whether the expression starting at token ``k`` (up to its ``;`` or
    ``,``) does arithmetic: a binary operator (one that follows an
    operand) or an increment."""
    depth, prev = 0, "="
    for tok in unit[k:]:
        if tok in ("(", "[", "{"):
            depth += 1
        elif tok in (")", "]", "}"):
            if depth == 0:
                return False
            depth -= 1
        elif tok in (";", ",") and depth == 0:
            return False
        elif tok in ("++", "--"):
            return True
        elif tok in ARITH_OPS and prev not in _OPERATORS:
            return True
        prev = tok
    return False


def lint_cuda_source(source: str, relpath: str) -> List[Finding]:
    """CUDA-INT16-ARITH over one CUDA source."""
    tokens = cuda_tokens(source)
    narrow = set(NARROW_TYPES)
    # a template type parameter is narrow where the file instantiates a
    # template with a narrow type
    if any(tokens[i] == "<" and tokens[i + 1] in NARROW_TYPES
           and tokens[i + 2] == ">" for i in range(len(tokens) - 2)):
        for i in range(len(tokens) - 1):
            if tokens[i] == "typename":
                narrow.add(tokens[i + 1])
    findings: List[Finding] = []
    for name, unit in _units(tokens):
        scalars, pointers, inits = _narrow_decls(unit, narrow)
        lines: List[str] = []
        for k in inits:
            if _rhs_has_arith(unit, k):
                lines.append("an arithmetic initializer of a narrow value")
        i = 0
        while i < len(unit):
            tok = unit[i]
            start, end = i, None
            if tok in scalars and (i == 0 or unit[i - 1] not in narrow):
                end = i
            elif tok in pointers and i + 1 < len(unit) and \
                    unit[i + 1] == "[":
                end = _match(unit, i + 1, "[", "]")
            elif (tok == "*" and i + 1 < len(unit)
                  and unit[i + 1] in pointers
                  and (i == 0 or unit[i - 1] in _OPERATORS)):
                end = i + 1
            if end is None:
                i += 1
                continue
            before = unit[start - 1] if start else ""
            before2 = unit[start - 2] if start > 1 else ""
            after = unit[end + 1] if end + 1 < len(unit) else ""
            if after in COMPOUND_OPS or after in ("++", "--") \
                    or before in ("++", "--"):
                lines.append(f"{after or before} on a narrow lvalue")
            elif after == "=" and _rhs_has_arith(unit, end + 2):
                lines.append("an arithmetic result stored into a narrow "
                             "lvalue")
            elif not _widened(unit, start) and (
                    after in ARITH_OPS
                    or (before in ARITH_OPS | COMPOUND_OPS
                        and before2 not in _OPERATORS)):
                lines.append("a narrow value in arithmetic before a "
                             "widening cast")
            i = end + 1
        for n, what in enumerate(lines, 1):
            findings.append(Finding(
                "CUDA-INT16-ARITH", f"{relpath}:{name}:int16#{n}",
                f"{relpath}: {what} in {name} — int16 arithmetic wraps; "
                "widen the narrow stream with (int) before any arithmetic",
            ))
    return findings


# --------------------------------------------------------------------------
# Orchestration
# --------------------------------------------------------------------------

SCOPE = (
    "cadence_tpu_torch/ops",
    "cadence_tpu_torch/runtime/replication/rebuilder.py",
    "cadence_tpu_torch/checkpoint/manager.py",
)
CUDA_SCOPE = "cadence_tpu_torch/ops/csrc/*.cu"


def run(repo_root: str) -> List[Finding]:
    findings: List[Finding] = []
    for entry in SCOPE:
        path = os.path.join(repo_root, entry)
        files = []
        if os.path.isdir(path):
            files = [
                os.path.join(path, f)
                for f in sorted(os.listdir(path))
                if f.endswith(".py")
            ]
        elif os.path.isfile(path):
            files = [path]
        for fpath in files:
            rel = os.path.relpath(fpath, repo_root)
            with open(fpath) as f:
                findings += lint_source(f.read(), rel)
    for fpath in sorted(glob.glob(os.path.join(repo_root, CUDA_SCOPE))):
        rel = os.path.relpath(fpath, repo_root)
        with open(fpath) as f:
            findings += lint_cuda_source(f.read(), rel)
    findings += check_step_dtypes()
    return findings
