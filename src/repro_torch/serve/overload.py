"""Admission control under overload (port of ``repro.serve.overload``).

Once the engine saturates, a request's admission latency (submit to
first sampled token) is mostly its wait in the queue, and that wait is
the queue depth times the interval between successive first tokens. The
controller keeps two exponentially weighted averages, of that interval
and of the admission latency itself (the floor at an empty queue), both
measured, so they follow prompt lengths, prefill budgets, speculation and
tiering without a model of any of them. It predicts

    predicted(depth) = depth * interval + latency

and sheds a submission (``ShedError``, HTTP 429) when the prediction
passes ``slo_ms``, or when the queue has reached ``max_queue``. Shedding
starts above the SLO and stops only once the prediction falls under
``hysteresis * slo``, so the gate does not flap at the boundary. A
submission that finds the queue empty is always admitted: it waits
behind nothing, and the first token it produces refreshes the estimates,
so a stale floor measured under load cannot hold the gate shut while the
engine drains. Every ``retry_after_s`` is at least ``min_retry_after_s``:
a cold controller's queue cap has no interval to offer, and the latency
model's excess can round to nothing at the SLO, and a ``Retry-After: 0``
sends clients straight back.

Pure host bookkeeping, O(1) an event, with an injectable clock.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


class ShedError(RuntimeError):
    """A submission refused by overload control (HTTP 429); servers send
    ``retry_after_s`` (never negative) as ``Retry-After``."""

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = max(0.0, float(retry_after_s))


@dataclasses.dataclass
class OverloadConfig:
    """The controller's knobs (the reference's names and defaults).

    ``slo_ms``: admission-latency target, None for no latency shedding.
    ``max_queue``: hard queue-depth cap, None for none. ``ewma_alpha``:
    weight of a new sample in both averages. ``hysteresis``: the fraction
    of the SLO the prediction must fall under before shedding stops.
    ``min_retry_after_s``: floor of every shed's ``retry_after_s``.
    """

    slo_ms: Optional[float] = None
    max_queue: Optional[int] = None
    ewma_alpha: float = 0.3
    hysteresis: float = 0.85
    min_retry_after_s: float = 0.05

    def validate(self) -> "OverloadConfig":
        if self.slo_ms is not None and self.slo_ms <= 0:
            raise ValueError(f"slo_ms must be > 0, got {self.slo_ms}")
        if self.max_queue is not None and self.max_queue < 0:
            raise ValueError(
                f"max_queue must be >= 0, got {self.max_queue}")
        if not 0 < self.ewma_alpha <= 1:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if not 0 < self.hysteresis <= 1:
            raise ValueError("hysteresis must be in (0, 1]")
        if self.min_retry_after_s < 0:
            raise ValueError(
                f"min_retry_after_s must be >= 0, "
                f"got {self.min_retry_after_s}")
        return self


class OverloadController:
    """The admission gate of the module docstring."""

    def __init__(self, cfg: OverloadConfig,
                 clock: Callable[[], float] = time.perf_counter):
        self.cfg = cfg.validate()
        self.clock = clock
        self.ewma_interval: Optional[float] = None  # s between first tokens
        self.ewma_latency: Optional[float] = None  # s, submit to first token
        self._last_first_token: Optional[float] = None
        self.shedding = False
        self.shed_count = 0
        self.admitted_count = 0

    def _average(self, prev: Optional[float], sample: float) -> float:
        if prev is None:
            return sample
        a = self.cfg.ewma_alpha
        return (1 - a) * prev + a * sample

    def observe_first_token(self, latency_s: float) -> None:
        """A request sampled its first token ``latency_s`` after submit."""
        now = self.clock()
        if self._last_first_token is not None:
            self.ewma_interval = self._average(
                self.ewma_interval, now - self._last_first_token)
        self._last_first_token = now
        self.ewma_latency = self._average(self.ewma_latency, latency_s)

    def predicted_latency(self, queue_depth: int) -> Optional[float]:
        """Predicted admission latency (s) behind ``queue_depth`` queued
        requests; None before the first sample."""
        if self.ewma_latency is None:
            return None
        return queue_depth * (self.ewma_interval or 0.0) + self.ewma_latency

    def _shed(self, message: str, retry_after_s: float) -> ShedError:
        self.shed_count += 1
        return ShedError(message, retry_after_s=max(
            retry_after_s, self.cfg.min_retry_after_s))

    def admit(self, queue_depth: int) -> None:
        """Gate one submission behind ``queue_depth`` queued requests:
        returns to admit it, raises :class:`ShedError` to shed it."""
        cfg = self.cfg
        if cfg.max_queue is not None and queue_depth >= cfg.max_queue:
            raise self._shed(
                f"queue full ({queue_depth} >= max_queue={cfg.max_queue})",
                self.ewma_interval or 0.0)
        # at depth 0 nothing is priced: admit (liveness, see above)
        predicted = self.predicted_latency(queue_depth)
        if cfg.slo_ms is not None and queue_depth > 0 \
                and predicted is not None:
            slo = cfg.slo_ms / 1e3
            if self.shedding and predicted < cfg.hysteresis * slo:
                self.shedding = False
            elif not self.shedding and predicted > slo:
                self.shedding = True
            if self.shedding:
                raise self._shed(
                    f"predicted first-token latency {predicted * 1e3:.0f}ms "
                    f"exceeds SLO {cfg.slo_ms:.0f}ms at queue depth "
                    f"{queue_depth}", predicted - slo)
        self.admitted_count += 1

    def stats(self) -> dict:
        return {
            "shed_count": self.shed_count,
            "admitted_count": self.admitted_count,
            "shedding": self.shedding,
            "ewma_first_token_interval_s": self.ewma_interval,
            "ewma_admission_latency_s": self.ewma_latency,
        }
