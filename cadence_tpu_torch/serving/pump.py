"""Background tick pump: bounded staleness for write-heavy lanes.

A port of the reference package's ``serving/pump.py``. Ticks otherwise
ride reads and appends, so a write-heavy, read-light workflow could stage
persist-feed debt with no reader to compose it. The pump is one daemon
thread driving ``ResidentEngine.tick()`` at a configured cadence, so every
dirty lane composes within about one interval whatever the read traffic;
the engine's ``serving_staleness_ms`` histogram (first dirty to composed,
per lane) is the observable.

Discipline:

* **drain-on-stop**: ``stop()`` joins the thread and runs one final tick,
  so Δs staged between the last cycle and the stop are composed before
  the lanes are flushed;
* **error back-off**: a failed cycle logs, counts
  ``serving_tick_pump_errors`` and backs off (doubling, capped at 8× the
  cadence) so a down store is not hammered at full cadence. A fault of
  the card counts here too: the engine raises it out of ``tick()``
  instead of hiding it, and the pump's log line names it;
* **no locks held while sleeping**: the pump owns no lock; the engine's
  ``_tick_lock`` serializes it against inline tick callers.
"""

from __future__ import annotations

import threading

from ..utils.backoff import BackoffLadder
from ..utils.log import get_logger
from ..utils.metrics import NOOP, Scope


class TickPump:
    """Drives ``engine.tick()`` every ``interval_s`` until stopped."""

    def __init__(
        self,
        engine,
        interval_s: float,
        metrics: Scope = None,
        name: str = "serving-tick-pump",
    ) -> None:
        if interval_s <= 0:
            raise ValueError("tick pump: interval_s must be > 0")
        self.engine = engine
        self.interval_s = float(interval_s)
        self._metrics = (
            metrics if metrics is not None else NOOP
        ).tagged(layer="serving")
        self._log = get_logger("cadence_tpu_torch.serving.pump")
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True
        )
        self._started = False
        self.cycles = 0
        self.errors = 0

    def start(self) -> "TickPump":
        self._started = True
        self._thread.start()
        return self

    def _run(self) -> None:
        ladder = BackoffLadder(self.interval_s, self.interval_s * 8.0)
        delay = self.interval_s
        while not self._stop.wait(delay):
            try:
                self.engine.tick()
                self.cycles += 1
                ladder.success()
                delay = self.interval_s
            except Exception as e:
                # a sick store must not kill the staleness bound for
                # good — log, count, back off (capped), keep pumping
                self.errors += 1
                self._metrics.inc("serving_tick_pump_errors")
                self._log.warn(f"tick pump cycle failed ({e}); backoff")
                delay = ladder.failure()

    def stop(self, timeout_s: float = 5.0) -> None:
        """Drain-on-stop: join the pump, then one final tick composes
        whatever was staged after the last cycle."""
        if not self._started:
            return
        self._stop.set()
        self._thread.join(timeout_s)
        try:
            self.engine.tick()
            self.cycles += 1
        except Exception as e:
            self.errors += 1
            self._metrics.inc("serving_tick_pump_errors")
            self._log.warn(f"tick pump drain tick failed ({e})")

    @property
    def running(self) -> bool:
        return self._thread.is_alive()
