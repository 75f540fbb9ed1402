"""ServingPlane: admission control + micro-batching + graceful degradation
— own copy of the reference's ``predictionio_tpu/serving/plane.py``.

This is the single object the HTTP layer talks to. Per request:

    result, degraded = plane.handle_query(query, headers)

which is result cache → admit → (batched or direct) dispatch → release,
with the degraded-mode hook tried when admission sheds. The HTTP handler
maps the two exceptions that can escape — ShedLoad → 429,
DeadlineExceeded → 503, both with Retry-After — and everything else stays
the 400 it always was (500 for an injected fault).

Degradation fires ONLY on saturation (ShedLoad): a cheap fallback answer
(e.g. the popularity model, which needs no per-user work) beats a 429
when the engine offers one. Deadline misses do NOT degrade — the client
declared the answer worthless after the deadline — and neither does a
dispatch that raises: an error of the scoring path (a CUDA error among
them) is never answered from the fallback.

Configuration resolves from PIO_SERVING_* environment variables
(`ServingConfig.from_env`). The reference's per-tenant binding and
metering and its span calls are left out: they come with the port's
request telemetry.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable, List, Optional, Tuple

from predictionio_torch.ingest.invalidation import BUS
from predictionio_torch.serving.admission import (
    AdmissionConfig,
    AdmissionController,
    ShedLoad,
    deadline_from_headers,
)
from predictionio_torch.serving.batcher import BatcherConfig, MicroBatcher
from predictionio_torch.serving.result_cache import MISS, ResultCache, cache_from_env
from predictionio_torch.telemetry.registry import REGISTRY
from predictionio_torch.utils import faults

log = logging.getLogger(__name__)

DEGRADED = REGISTRY.counter(
    "serving_degraded_total",
    "Predict requests answered by the degraded-mode fallback under shed")

_TRUTHY = {"1", "true", "yes", "on"}


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        log.warning("ignoring unparseable %s=%r", name, raw)
        return default


@dataclasses.dataclass
class ServingConfig:
    # micro-batching on/off; admission control is NOT optional — with
    # batching off, requests still admit/release around a direct dispatch
    batching: bool = True
    admission: AdmissionConfig = dataclasses.field(default_factory=AdmissionConfig)
    batcher: BatcherConfig = dataclasses.field(default_factory=BatcherConfig)

    @classmethod
    def from_env(cls) -> "ServingConfig":
        """Resolve from PIO_SERVING_* (every knob optional):

        PIO_SERVING_BATCHING=0|1, PIO_SERVING_MAX_BATCH,
        PIO_SERVING_MAX_WAIT_MS, PIO_SERVING_MAX_QUEUE,
        PIO_SERVING_DEFAULT_DEADLINE_MS, PIO_SERVING_RETRY_AFTER_S."""
        cfg = cls()
        raw = os.environ.get("PIO_SERVING_BATCHING")
        if raw is not None:
            cfg.batching = raw.strip().lower() in _TRUTHY
        cfg.batcher.max_batch = int(
            _env_float("PIO_SERVING_MAX_BATCH", cfg.batcher.max_batch))
        cfg.batcher.max_wait_ms = _env_float(
            "PIO_SERVING_MAX_WAIT_MS", cfg.batcher.max_wait_ms)
        cfg.admission.max_queue = int(
            _env_float("PIO_SERVING_MAX_QUEUE", cfg.admission.max_queue))
        cfg.admission.default_deadline_ms = _env_float(
            "PIO_SERVING_DEFAULT_DEADLINE_MS",
            cfg.admission.default_deadline_ms)
        cfg.admission.retry_after_s = _env_float(
            "PIO_SERVING_RETRY_AFTER_S", cfg.admission.retry_after_s)
        return cfg


class ServingPlane:
    """Admission-gated (optionally batched) dispatch for one engine
    instance.

    `dispatch_fn(queries: list) -> list[results]` — the batched predict
    path (Engine.predict_batch bound to the served state).
    `degraded_fn(query) -> result` — optional cheap fallback used when
    admission sheds; raise/return None to decline.
    `variant` — the engine variant this plane serves; scopes the result
    cache's keys and the invalidation messages it acts on."""

    def __init__(self,
                 dispatch_fn: Callable[[List], List],
                 degraded_fn: Optional[Callable] = None,
                 config: Optional[ServingConfig] = None,
                 result_cache: Optional[ResultCache] = None,
                 variant: str = ""):
        self.config = config or ServingConfig()
        self.variant = variant

        # Optional per-user result cache (OFF unless PIO_HTTP_RESULT_CACHE
        # opts in, or one is passed explicitly). Kept read-your-writes by
        # the invalidation bus: every fold the online plane swaps in
        # publishes the touched users and this cache drops their entries
        # (serving/result_cache.py has the full posture).
        self.result_cache = (result_cache if result_cache is not None
                             else cache_from_env())
        if self.result_cache is not None:
            cache, own_variant = self.result_cache, variant

            def _invalidate(entity_ids, msg_variant=None):
                # a variant-scoped message (a fold swapped into one
                # variant) can only stale this plane's entries if it
                # names this variant
                if msg_variant is None or msg_variant == own_variant:
                    cache.invalidate_entities(entity_ids,
                                              variant=msg_variant)

            self._invalidate = _invalidate
            BUS.subscribe(self._invalidate)

        # `serving.pre_dispatch` fault site: after admission, before the
        # model runs — a drill arms delay:/error modes here to turn a
        # live server slow or erroring without killing it. One site in
        # the plane covers batched and direct dispatch alike.
        def _faultable_dispatch(queries: List) -> List:
            faults.inject("serving.pre_dispatch")
            return dispatch_fn(queries)

        self.dispatch_fn = _faultable_dispatch
        self.degraded_fn = degraded_fn
        self.admission = AdmissionController(self.config.admission)
        self.batcher: Optional[MicroBatcher] = None
        if self.config.batching:
            # the admitted count is the batcher's fill signal: a forming
            # batch stops waiting the moment it holds every admitted
            # request (see batcher module docstring)
            self.batcher = MicroBatcher(
                self.dispatch_fn, config=self.config.batcher,
                pending_fn=lambda: self.admission.admitted)

    def handle_query(self, query, headers=None) -> Tuple[object, bool]:
        """Cache, admit, dispatch, release. Returns (result,
        degraded_flag).

        Raises ShedLoad (→ 429) when saturated and no degraded answer
        exists; DeadlineExceeded (→ 503) when the request's deadline
        expired before a result was produced."""
        cache = self.result_cache
        if cache is not None:
            hit = cache.get(query, self.variant)
            if hit is not MISS:
                return hit, False
            # taken before the dispatch reads the served state: a fold or
            # reload invalidated after this point keeps its result out
            token = cache.token()
        deadline = deadline_from_headers(headers, self.config.admission)
        try:
            self.admission.admit(deadline)
        except ShedLoad:
            degraded = self._try_degraded(query)
            if degraded is not None:
                return degraded, True
            raise
        try:
            if self.batcher is not None:
                result = self.batcher.submit(query, deadline)
            else:
                result = self.dispatch_fn([query])[0]
        finally:
            self.admission.release()
        if cache is not None:
            # full-quality results only: a degraded answer must never
            # outlive the saturation that produced it
            cache.put(query, result, self.variant, token)
        return result, False

    def _try_degraded(self, query):
        if self.degraded_fn is None:
            return None
        try:
            result = self.degraded_fn(query)
        except Exception:  # noqa: BLE001 — degraded path must never mask the shed
            log.exception("degraded-mode fallback failed; shedding instead")
            return None
        if result is not None:
            DEGRADED.inc()
        return result

    def close(self) -> None:
        """Stop the dispatcher thread and leave the bus. Idempotent."""
        if self.batcher is not None:
            self.batcher.close()
        if self.result_cache is not None:
            BUS.unsubscribe(self._invalidate)
            self.result_cache.clear()
