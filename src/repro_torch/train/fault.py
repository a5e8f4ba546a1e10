"""Fault tolerance: auto-restart, preemption handling, straggler watchdog
(port of ``repro.train.fault``; the watchdog's clock is injectable).

Designed for the 1000+ node posture (DESIGN.md §5):

  * ``run_with_restarts`` — supervisor that restarts the train loop from the
    latest complete checkpoint after a crash (node failure model: the job
    scheduler relaunches the process; this supervisor makes a single process
    behave identically under injected failures, which is what the tests do),
  * ``PreemptionGuard`` — SIGTERM/SIGINT turn into a "save and exit cleanly
    at the next step boundary" flag (maintenance-event preemption),
  * ``StragglerWatchdog`` — per-step wall-time monitor; steps slower than
    ``threshold x`` the rolling median are flagged (on a real fleet this
    feeds the controller that cordons slow hosts; here it logs and counts,
    and the count is assertable in tests).
"""
from __future__ import annotations

import logging
import signal
import time
from collections import deque
from typing import Callable, Optional

log = logging.getLogger("repro_torch.fault")


class PreemptionGuard:
    """Convert SIGTERM/SIGINT into a graceful should_stop flag."""

    def __init__(self, install: bool = True):
        self.should_stop = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:  # non-main thread (tests)
                    pass

    def _handler(self, signum, frame):
        log.warning("preemption signal %s received; stopping at step boundary",
                    signum)
        self.should_stop = True

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


class StragglerWatchdog:
    """Rolling-median step-time monitor. ``clock`` returns seconds
    (default ``time.monotonic``; tests pass a fake one)."""

    def __init__(self, window: int = 32, threshold: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.times = deque(maxlen=window)
        self.threshold = threshold
        self.flagged = 0
        self._t0 = None

    def step_start(self):
        self._t0 = self.clock()

    def step_end(self) -> bool:
        dt = self.clock() - self._t0
        slow = False
        if len(self.times) >= 8:
            med = sorted(self.times)[len(self.times) // 2]
            if dt > self.threshold * med:
                self.flagged += 1
                slow = True
                log.warning("straggler step: %.3fs vs median %.3fs", dt, med)
        self.times.append(dt)
        return slow


def run_with_restarts(
        make_loop: Callable[[Optional[int]], int], max_restarts: int = 3,
        on_restart: Optional[Callable[[int, Exception], None]] = None):
    """Supervise ``make_loop(resume_step) -> final_step`` with restarts.

    ``make_loop`` must checkpoint internally and be able to resume from the
    latest checkpoint when re-invoked (resume_step=None means "find latest").
    """
    attempts = 0
    while True:
        try:
            return make_loop(None)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — node-failure model
            attempts += 1
            log.error("train loop crashed (%s); restart %d/%d",
                      e, attempts, max_restarts)
            if on_restart is not None:
                on_restart(attempts, e)
            if attempts > max_restarts:
                raise
