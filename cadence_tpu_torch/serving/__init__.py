"""The serving plane: resident hot state with O(Δ) replay-on-append.

A port of the reference package's ``serving`` package, with the same
exports. ``ResidentEngine`` (engine.py) keeps a fixed-shape resident store
of S lanes and replays each tick's appended suffixes on the card in one
packed launch of the FSM kernel per group: continuous batching for
workflow replay. ``admission.py`` is the fair admission scheduler
(weighted, deadline-aged and per-domain-quota'd refill of freed lanes).
``pump.py`` is the background tick pump bounding resident-row staleness.
``harness.py`` is the open-loop SLO load harness (Poisson or bursty
arrivals at a sustained QPS through token buckets, with retry-budgeted
re-offers of shed arrivals).
"""

from .admission import AdmissionPolicy, FairAdmissionQueue
from .engine import (
    LaneTicket,
    ResidentEngine,
    ResidentRead,
)
from .harness import ArrivalProcess, OpenLoopHarness, ServeWorkload
from .pump import TickPump

__all__ = [
    "AdmissionPolicy",
    "ArrivalProcess",
    "FairAdmissionQueue",
    "LaneTicket",
    "OpenLoopHarness",
    "ResidentEngine",
    "ResidentRead",
    "ServeWorkload",
    "TickPump",
]
