"""Fault tolerance: preemption handling, a straggler watchdog and a
restart loop — the counterpart of ``repro.distributed.fault``.

* SIGTERM / SIGINT set a flag; the train loop checkpoints at the next step
  boundary and exits 0 (clean preemption).
* A watchdog tracks each step's wall time; a step slower than
  ``threshold ×`` the rolling median is recorded as a straggler event.  It
  times what the caller brackets: on the card a step's kernels run after
  the host returns, so the caller must synchronise (read the loss) before
  ``step_end``, which the port's train driver does and the reference's,
  timing JAX's asynchronous dispatch, does not (ROADMAP Queue C).
* :func:`restart_loop` wraps a train function: on a crash it runs it again
  (the function resumes from its latest complete checkpoint) up to
  ``max_restarts`` times.  With the deterministic-by-step data pipeline
  this gives exactly-once batch semantics.
"""

from __future__ import annotations

import signal
import statistics
import time
from typing import Callable


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._prev = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        return False

    def _handle(self, signum, frame):
        self.requested = True


class StragglerWatchdog:
    """Rolling-median step timer; flags abnormal steps."""

    def __init__(self, window: int = 50, threshold: float = 3.0):
        self.window = window
        self.threshold = threshold
        self.times: list[float] = []
        self.events: list[dict] = []
        self._t0 = None

    def step_start(self):
        self._t0 = time.monotonic()

    def step_end(self, step: int):
        dt = time.monotonic() - self._t0
        median = statistics.median(self.times) if self.times else dt
        if self.times and dt > self.threshold * median:
            self.events.append({"step": step, "seconds": dt, "median": median})
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def straggler_count(self):
        return len(self.events)


def restart_loop(
    run: Callable[[int], int],
    *,
    max_restarts: int = 3,
    on_restart: Callable[[int, Exception], None] | None = None,
) -> int:
    """Run ``run(attempt)`` with crash-restart semantics.

    ``run`` must resume from its own checkpoints; its return value is the
    final step reached.  Raises after ``max_restarts`` failures."""
    attempt = 0
    while True:
        try:
            return run(attempt)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — anything can kill a node
            attempt += 1
            if attempt > max_restarts:
                raise
            if on_restart is not None:
                on_restart(attempt, e)
