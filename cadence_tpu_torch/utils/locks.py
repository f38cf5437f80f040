"""Tracked lock primitives for the runtime concurrency sanitizer.

The dynamic half of the Pass 3 lock analysis (the static half lives in
``cadence_tpu_torch/analysis/lock_order.py``). The runtime constructs its
locks through this module's factory:

    self._lock = locks.make_lock("ShardContext._lock")

**Disabled path** (the default, and every production/tier-1 run that
is not a sanitizer test): ``make_lock``/``make_rlock`` return the raw
``threading`` primitive after ONE module-global check — no wrapper, no
frame inspection, no per-acquire work. ``make_guarded`` returns its
container argument unchanged. This mirrors the
``wrap_bundle(faults=..., effects=...)`` contract: nothing is
installed unless a chaos/sanitizer harness asks for it.

**Sanitizer mode**: ``wrap_locks(tracker)`` installs a process-wide
tracker (``testing/race_witness.RaceWitness``) and the factory starts
returning ``TrackedLock``/``TrackedRLock`` wrappers that record

* a per-thread **acquisition stack** (which tracked locks this thread
  holds, with the acquiring ``module:Class.method`` site) — the raw
  material for the runtime lock-order graph and its inversion check;
* **held durations** (max per lock name, for the overhead/stall docs);
* **guarded-field accesses** — ``make_guarded(container, field,
  guard)`` wraps the declared hot shared dicts/lists in proxies that
  report every read/write together with whether the declared guard was
  held on the calling thread (the Eraser-style lockset input);
* **blocking-while-locked events** — ``note_blocking`` is called by
  the sanitizer's persistence probe and by the patched
  ``time.sleep``/``Queue.get``/``Thread.join`` entry points.

Lock naming. A tracked lock's full name is
``<module relpath>:<short name>`` (module inferred from the
construction site), e.g. ``cadence_tpu_torch/runtime/shard.py:
ShardContext._lock`` — byte-compatible with the static pass's
``_lock_id`` for self-attribute locks, so the runtime-observed graph
and the static graph speak the same identifiers.

A copy of the reference package's ``utils/locks.py``. Names carry the
port's module paths (``cadence_tpu_torch/...``), so the runtime graph
matches the port's own static pass.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import List, Tuple

_tracker = None  # the installed RaceWitness (or None = disabled)

_held = threading.local()  # .stack: List[_Held] per thread


class _Held:
    __slots__ = ("lock", "site", "t0", "reentrant")

    def __init__(self, lock, site, t0, reentrant):
        self.lock = lock
        self.site = site
        self.t0 = t0
        self.reentrant = reentrant


def wrap_locks(tracker):
    """Install the process-wide lock tracker (sanitizer mode ON).
    Mirrors ``wrap_bundle(faults=...)``: only a test harness calls
    this; everything constructed afterwards through the factory is
    tracked. Returns the tracker for chaining."""
    global _tracker
    _tracker = tracker
    return tracker


def unwrap_locks() -> None:
    """Remove the tracker (sanitizer mode OFF). Wrappers constructed
    while tracking was on keep working — they just stop reporting."""
    global _tracker
    _tracker = None


def tracking_enabled() -> bool:
    return _tracker is not None


def _stack() -> List[_Held]:
    try:
        return _held.stack
    except AttributeError:
        s = _held.stack = []
        return s


def held_locks() -> Tuple[str, ...]:
    """Names of tracked locks the CURRENT thread holds (innermost
    last); always () when the sanitizer is disabled."""
    if _tracker is None:
        return ()
    return tuple(e.lock.name for e in _stack() if not e.reentrant)


def innermost_held():
    """The most recently acquired non-reentrant hold on this thread
    (a ``_Held`` record), or None."""
    for e in reversed(_stack()):
        if not e.reentrant:
            return e
    return None


# --------------------------------------------------------------------------
# acquisition-site capture
# --------------------------------------------------------------------------

_THIS_FILE = os.path.abspath(__file__)
_UNKNOWN_SITE = ("<unknown>", "", "", 0)


def _relpath(filename: str) -> str:
    """Repo-relative path matching the static pass's module ids
    ("cadence_tpu_torch/runtime/shard.py"); absolute path when the file is
    outside the package (tests, fixtures)."""
    norm = filename.replace(os.sep, "/")
    idx = norm.rfind("cadence_tpu_torch/")
    if idx >= 0:
        return norm[idx:]
    return norm


def call_site(skip_self: bool = True) -> Tuple[str, str, str, int]:
    """(module relpath, class name, function name, lineno) of the
    nearest frame outside this module (and outside threading.py —
    Condition.wait re-acquires through the wrapper)."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if os.path.abspath(fn) != _THIS_FILE and not fn.endswith(
            "threading.py"
        ):
            klass = ""
            zelf = f.f_locals.get("self")
            if zelf is not None:
                klass = type(zelf).__name__
            return (_relpath(fn), klass, f.f_code.co_name, f.f_lineno)
        f = f.f_back
    return _UNKNOWN_SITE


def site_anchor(site: Tuple[str, str, str, int]) -> str:
    """"module:Class.method" (or "module:method" for free functions) —
    the prefix the static pass uses in its finding anchors."""
    mod, klass, func, _ = site
    qual = f"{klass}.{func}" if klass else func
    return f"{mod}:{qual}"


# --------------------------------------------------------------------------
# tracked primitives
# --------------------------------------------------------------------------

# monotonic time source; swapped out never (tests read the counter)
from time import monotonic as _now

_constructed = 0  # TrackedLock/TrackedRLock instances ever built —
                  # the disabled-path overhead guard asserts this
                  # stays 0 across a full untracked run


def constructed_count() -> int:
    return _constructed


class TrackedLock:
    """Drop-in ``threading.Lock`` recording acquisitions/releases to
    the installed tracker. Attribute access falls through to the inner
    primitive so ``threading.Condition`` can be constructed over it.

    Known limit (deliberate): holds are tracked per-thread, so the
    cross-thread handoff ``threading.Lock`` technically permits
    (acquire on thread A, release on thread B) would leave A's stack
    stale — the release silently finds no entry. The runtime never
    does this (every factory call site is a scoped ``with`` block, the
    one shape the static Pass 3 can prove things about); a handoff
    pattern would need an owner registry, not a thread-local stack."""

    _reentrant = False

    def __init__(self, name: str, inner=None) -> None:
        global _constructed
        _constructed += 1
        self.name = name
        self._inner = inner if inner is not None else threading.Lock()

    # -- core protocol -------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            # try-locks cannot deadlock, so they contribute no
            # acquisition-ORDER edge (the static pass exempts them the
            # same way) — but the hold itself is real: guarded-field
            # checks and blocking attribution still see it
            self._on_acquired(edge=bool(blocking))
        return ok

    def release(self) -> None:
        self._on_release()
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        return self._inner.locked()

    def __getattr__(self, name: str):
        return getattr(self._inner, name)

    # -- tracking ------------------------------------------------------

    def _on_acquired(self, edge: bool = True) -> None:
        t = _tracker
        stack = _stack()
        reentrant = self._reentrant and any(
            e.lock is self for e in stack
        )
        site = call_site() if t is not None else _UNKNOWN_SITE
        entry = _Held(self, site, _now(), reentrant)
        if t is not None and not reentrant:
            prior = innermost_held()
            stack.append(entry)
            t.on_acquire(self, entry, prior if edge else None)
        else:
            stack.append(entry)

    def _on_release(self) -> None:
        stack = _stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i].lock is self:
                entry = stack.pop(i)
                t = _tracker
                if t is not None and not entry.reentrant:
                    t.on_release(self, entry, _now() - entry.t0)
                return

    def _drop_all(self) -> int:
        """Pop every hold of this lock from the thread's stack
        (Condition._release_save on an RLock fully releases)."""
        stack = _stack()
        n = 0
        for i in range(len(stack) - 1, -1, -1):
            if stack[i].lock is self:
                stack.pop(i)
                n += 1
        return n

    def _repush(self, n: int) -> None:
        stack = _stack()
        for i in range(n):
            # restore after a Condition.wait: re-entry, no new edges
            stack.append(_Held(self, _UNKNOWN_SITE, _now(), i > 0))


class TrackedRLock(TrackedLock):
    _reentrant = True

    def __init__(self, name: str, inner=None) -> None:
        super().__init__(
            name, inner if inner is not None else threading.RLock()
        )

    # Condition-protocol support: these must go through the wrapper,
    # or a Condition built over the inner RLock's own methods would
    # desync the held stack while parked in wait().
    def _release_save(self):
        n = self._drop_all()
        return (self._inner._release_save(), n)

    def _acquire_restore(self, saved):
        state, n = saved
        self._inner._acquire_restore(state)
        self._repush(max(n, 1))

    def _is_owned(self):
        return self._inner._is_owned()


class TrackedCondition(threading.Condition):
    """``threading.Condition`` over a tracked lock, with wait counted
    as a release-while-parked (NOT a blocking violation — waiting on
    the condition you hold releases it, same exemption as the static
    pass)."""

    def __init__(self, lock=None, name: str = "") -> None:
        if lock is None:
            lock = TrackedRLock(name or "condition")
        self.name = name or getattr(lock, "name", "condition")
        super().__init__(lock)


# --------------------------------------------------------------------------
# factory — the tree-wide construction entry points
# --------------------------------------------------------------------------


def _full_name(short: str) -> str:
    """Prefix the caller's module relpath so the runtime name matches
    the static pass's lock ids ("cadence_tpu_torch/runtime/shard.py:
    ShardContext._lock")."""
    f = sys._getframe(2)
    return f"{_relpath(f.f_code.co_filename)}:{short}"


def make_lock(name: str):
    """A mutex. Disabled: a raw ``threading.Lock`` (one global check,
    nothing else). Sanitizer mode: a ``TrackedLock`` whose full name
    is ``<caller module>:<name>``."""
    if _tracker is None:
        return threading.Lock()
    return TrackedLock(_full_name(name))


def make_rlock(name: str):
    if _tracker is None:
        return threading.RLock()
    return TrackedRLock(_full_name(name))


def make_condition(lock=None, name: str = "condition"):
    """A condition variable; over ``lock`` when given (tracked or
    plain), else over its own (tracked, in sanitizer mode) lock."""
    if _tracker is None:
        return threading.Condition(lock)
    if lock is None:
        lock = TrackedRLock(_full_name(name))
    return TrackedCondition(lock, name=_full_name(name))


# --------------------------------------------------------------------------
# guarded-field proxies (Eraser-style lockset input)
# --------------------------------------------------------------------------


def _guard_event(field: str, guard, writing: bool) -> None:
    t = _tracker
    if t is None:
        return
    held = any(e.lock is guard for e in _stack())
    t.on_guarded_access(field, held, writing,
                        None if held else call_site())


class GuardedDict(dict):
    """Dict proxy reporting every access with the guard-held bit. Only
    ever constructed in sanitizer mode."""

    def __init__(self, field: str, guard, initial=None,
                 default_factory=None) -> None:
        super().__init__(initial or {})
        self._field = field
        self._guard = guard
        self._default_factory = default_factory

    # -- writes --------------------------------------------------------

    def __setitem__(self, k, v):
        _guard_event(self._field, self._guard, True)
        super().__setitem__(k, v)

    def __delitem__(self, k):
        _guard_event(self._field, self._guard, True)
        super().__delitem__(k)

    def pop(self, *a):
        _guard_event(self._field, self._guard, True)
        return super().pop(*a)

    def popitem(self):
        _guard_event(self._field, self._guard, True)
        return super().popitem()

    def clear(self):
        _guard_event(self._field, self._guard, True)
        super().clear()

    def update(self, *a, **kw):
        _guard_event(self._field, self._guard, True)
        super().update(*a, **kw)

    def setdefault(self, k, default=None):
        _guard_event(self._field, self._guard, True)
        return super().setdefault(k, default)

    def __missing__(self, k):
        if self._default_factory is None:
            raise KeyError(k)
        v = self._default_factory()
        super().__setitem__(k, v)
        return v

    def __ior__(self, other):
        _guard_event(self._field, self._guard, True)
        super().update(other)
        return self

    # -- reads ---------------------------------------------------------

    def __getitem__(self, k):
        _guard_event(self._field, self._guard, False)
        # raw dict probe: the instrumented __contains__ would fire a
        # second guard event per read on the metrics hot path
        if self._default_factory is not None and not dict.__contains__(
            self, k
        ):
            return self.__missing__(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        _guard_event(self._field, self._guard, False)
        return super().get(k, default)

    def __contains__(self, k):
        _guard_event(self._field, self._guard, False)
        return super().__contains__(k)

    def __iter__(self):
        _guard_event(self._field, self._guard, False)
        return super().__iter__()

    def keys(self):
        _guard_event(self._field, self._guard, False)
        return super().keys()

    def values(self):
        _guard_event(self._field, self._guard, False)
        return super().values()

    def items(self):
        _guard_event(self._field, self._guard, False)
        return super().items()

    def __len__(self):
        _guard_event(self._field, self._guard, False)
        return super().__len__()


class GuardedList(list):
    """List proxy reporting every access with the guard-held bit."""

    def __init__(self, field: str, guard, initial=None) -> None:
        super().__init__(initial or [])
        self._field = field
        self._guard = guard

    def append(self, v):
        _guard_event(self._field, self._guard, True)
        super().append(v)

    def extend(self, it):
        _guard_event(self._field, self._guard, True)
        super().extend(it)

    def insert(self, i, v):
        _guard_event(self._field, self._guard, True)
        super().insert(i, v)

    def remove(self, v):
        _guard_event(self._field, self._guard, True)
        super().remove(v)

    def pop(self, *a):
        _guard_event(self._field, self._guard, True)
        return super().pop(*a)

    def clear(self):
        _guard_event(self._field, self._guard, True)
        super().clear()

    def __setitem__(self, i, v):
        _guard_event(self._field, self._guard, True)
        super().__setitem__(i, v)

    def __delitem__(self, i):
        _guard_event(self._field, self._guard, True)
        super().__delitem__(i)

    def __iadd__(self, other):
        _guard_event(self._field, self._guard, True)
        super().extend(other)
        return self

    def __imul__(self, n):
        _guard_event(self._field, self._guard, True)
        list.__imul__(self, n)
        return self

    def sort(self, *a, **kw):
        _guard_event(self._field, self._guard, True)
        super().sort(*a, **kw)

    def reverse(self):
        _guard_event(self._field, self._guard, True)
        super().reverse()

    def __getitem__(self, i):
        _guard_event(self._field, self._guard, False)
        return super().__getitem__(i)

    def __iter__(self):
        _guard_event(self._field, self._guard, False)
        return super().__iter__()

    def __len__(self):
        _guard_event(self._field, self._guard, False)
        return super().__len__()

    def __contains__(self, v):
        _guard_event(self._field, self._guard, False)
        return super().__contains__(v)


def make_guarded(container, field: str, guard):
    """Declare ``container`` (a dict or list) guarded by ``guard``.

    Disabled: returns ``container`` unchanged (zero cost, zero type
    change). Sanitizer mode: returns a recording proxy and registers
    the field with the tracker — every subsequent access reports
    (field, guard-held?, read/write) for the GUARDED-FIELD-RACE rule.
    ``defaultdict`` inputs keep their default factory."""
    t = _tracker
    if t is None:
        return container
    full = _full_name(field)
    t.on_guard_registered(full, getattr(guard, "name", str(guard)))
    if isinstance(container, dict):
        factory = getattr(container, "default_factory", None)
        return GuardedDict(full, guard, container,
                           default_factory=factory)
    if isinstance(container, list):
        return GuardedList(full, guard, container)
    raise TypeError(
        f"make_guarded: unsupported container {type(container).__name__}"
    )


# --------------------------------------------------------------------------
# blocking-op reporting (the RUNTIME-LOCK-BLOCKING feed)
# --------------------------------------------------------------------------


def note_blocking(kind: str, detail: str) -> None:
    """Report a blocking operation (store I/O, sleep, join, blocking
    queue op) if the calling thread holds any tracked lock. Called by
    the sanitizer's persistence probe and the patched stdlib entry
    points; one global check + one thread-local read when nothing is
    held."""
    t = _tracker
    if t is None:
        return
    entry = innermost_held()
    if entry is None:
        return
    t.on_blocking(entry, kind, detail)
