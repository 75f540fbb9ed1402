"""Deadline-aware admission control for the prediction hot path — own
copy of the reference's ``predictionio_tpu/serving/admission.py``.

A server that accepts every `/queries.json` request lets saturation
express itself as unbounded queueing: latency grows without bound and
every client times out at once. Instead the queue is bounded and load is
shed deliberately:

- each request is admitted against a bounded concurrent-request budget
  (`max_queue`); past it the server answers **429 + Retry-After** instead
  of queueing into collapse;
- a client may send `X-PIO-Deadline-Ms: 50` — a per-request latency
  budget. A request whose deadline expires before dispatch answers
  **503** and never reaches the scoring path (the device never does work
  nobody is waiting for);
- shedding and deadline misses are first-class telemetry
  (`serving_shed_total{reason}`, `serving_deadline_misses_total`).

The controller is intentionally tiny — one lock, one counter — because it
runs on every request of the hot path.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

from predictionio_torch.telemetry.registry import REGISTRY

DEADLINE_HEADER = "X-PIO-Deadline-Ms"

SHED = REGISTRY.counter(
    "serving_shed_total",
    "Predict requests shed by admission control",
    labelnames=("reason",))
DEADLINE_MISSES = REGISTRY.counter(
    "serving_deadline_misses_total",
    "Predict requests whose deadline expired before a result was produced")
ADMITTED_IN_FLIGHT = REGISTRY.gauge(
    "serving_admitted_in_flight",
    "Predict requests currently admitted (queued or executing)")

# cached label children — labels() validates + locks per call, and these
# run on the per-request hot path
_SHED_QUEUE_FULL = SHED.labels(reason="queue_full")
_SHED_DEADLINE = SHED.labels(reason="deadline")
_DEADLINE_MISS = DEADLINE_MISSES.labels()
_IN_FLIGHT = ADMITTED_IN_FLIGHT.labels()


class ShedLoad(Exception):
    """Raised when admission rejects a request under saturation.

    Maps to HTTP 429 with a `Retry-After` header."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class DeadlineExceeded(Exception):
    """Raised when a request's deadline expired before a result existed.

    Maps to HTTP 503 with a `Retry-After` header — the work was never
    (or no longer usefully) done."""


@dataclasses.dataclass
class AdmissionConfig:
    # bounded admitted-request budget: queued in the batcher + executing.
    # Past it new requests shed with 429 instead of queueing into collapse.
    max_queue: int = 256
    # deadline applied when the client sends no X-PIO-Deadline-Ms (0 = none)
    default_deadline_ms: float = 0.0
    # ceiling clamped onto client-supplied deadlines (a client asking for
    # an hour must not pin a queue slot for an hour)
    max_deadline_ms: float = 60_000.0
    # advisory backoff answered on 429/503
    retry_after_s: float = 1.0


def deadline_from_headers(headers,
                          config: AdmissionConfig) -> Optional[float]:
    """Absolute monotonic deadline from the request's X-PIO-Deadline-Ms
    header (falling back to the configured default), or None for no
    deadline. Unparseable values are ignored rather than 400'd — a
    malformed latency hint must not break a correct query."""
    raw = headers.get(DEADLINE_HEADER) if headers is not None else None
    if raw is None:
        ms = config.default_deadline_ms
        if ms <= 0:
            return None
    else:
        try:
            ms = float(raw)
        except (TypeError, ValueError):
            ms = config.default_deadline_ms
        if ms <= 0:
            return None
    ms = min(ms, config.max_deadline_ms)
    return time.monotonic() + ms / 1000.0


class AdmissionController:
    """Bounded concurrent-request budget with deadline awareness."""

    def __init__(self, config: Optional[AdmissionConfig] = None):
        self.config = config or AdmissionConfig()
        self._lock = threading.Lock()
        self._admitted = 0

    @property
    def admitted(self) -> int:
        return self._admitted

    def admit(self, deadline: Optional[float] = None) -> None:
        """Take one admission slot or raise. Callers MUST pair a
        successful admit with `release()` (ServingPlane does this in a
        finally)."""
        if deadline is not None and time.monotonic() >= deadline:
            _SHED_DEADLINE.inc()
            _DEADLINE_MISS.inc()
            raise DeadlineExceeded("deadline expired before admission")
        with self._lock:
            if self._admitted >= self.config.max_queue:
                _SHED_QUEUE_FULL.inc()
                raise ShedLoad(
                    f"serving queue saturated "
                    f"({self._admitted}/{self.config.max_queue} admitted)",
                    retry_after_s=self.config.retry_after_s)
            self._admitted += 1
        _IN_FLIGHT.set(self._admitted)

    def release(self) -> None:
        with self._lock:
            self._admitted -= 1
        _IN_FLIGHT.set(self._admitted)
