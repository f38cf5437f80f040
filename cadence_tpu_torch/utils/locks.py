"""Lock constructors under the reference package's names.

The reference package's ``utils/locks.py`` hands out locks through
``make_lock`` / ``make_rlock`` / ``make_condition`` and declares guarded
containers through ``make_guarded``, so its concurrency sanitizer can
swap in tracking locks. The port keeps the names, so the copied runtime
modules read as their counterparts do, and returns plain ``threading``
objects: lock-order tracking is not ported.
"""

from __future__ import annotations

import threading


def make_lock(name: str):
    """A mutex (``name`` labels it for a tracker the port lacks)."""
    return threading.Lock()


def make_rlock(name: str):
    return threading.RLock()


def make_condition(lock=None, name: str = "condition"):
    return threading.Condition(lock)


def make_guarded(container, field: str, guard):
    """Declare ``container`` guarded by ``guard``; returns it unchanged."""
    return container
