"""Micro-batching queue: concurrent predict requests → one batched
dispatch — own copy of the reference's
``predictionio_tpu/serving/batcher.py``.

One `MicroBatcher` serves one engine instance. Handler threads `submit()`
a query and block; a single dispatcher thread drains the queue and issues
ONE batched dispatch for everything that arrived together, then wakes the
waiters with their per-query results.

Coalescing is ADMITTED-AWARE by default: the admission controller tells
the batcher how many requests are in flight (`pending_fn`), and the
dispatcher holds a forming batch open only while admitted requests are
still missing from the queue — the moment the queue holds every admitted
request, waiting longer is pure idle (nobody else can arrive until
someone is answered) and the batch dispatches. `max_wait_ms` is the cap
on that hold, not a fixed stall: a lone request (admitted == 1)
dispatches INLINE on the calling thread — no enqueue, no thread handoff,
no queue-wait observation — while under concurrency batches fill to the
offered parallelism within a fraction of the cap.

Without a `pending_fn` (standalone batcher), `max_wait_ms > 0` degrades
to plain fill — hold up to the cap for a full `max_batch` — and
`max_wait_ms = 0` is purely opportunistic: dispatches are mutually
exclusive, so arrivals during a running dispatch queue up and leave as
one batch, but nothing is ever held back.

Batches are padded up to a fixed bucket ladder (powers of two capped at
`max_batch`) before dispatch, so a scorer sees at most
`log2(max_batch) + 1` distinct batch sizes. Padding rows duplicate the
batch's last query and their results are dropped before distribution, so
padding is invisible to callers (tests/test_torch_serving.py holds this
bitwise).

Failure isolation: when a batched dispatch raises and the batch held more
than one query, the batcher retries each query alone — one malformed
query answers its own 400 instead of failing innocent co-batched
requests. Each retry keeps the ORIGINAL bucket size (the query is
repeated to fill it, mirror of the padding idiom above), so no new batch
tier is minted mid-incident. This per-item fallback also carries engines
whose algorithms have no vectorized `batch_predict`: the base
`Algorithm.batch_predict` loops `predict`.

A request whose deadline expires while queued is answered 503 by the
dispatcher WITHOUT being dispatched — expired work never reaches the
scoring path (`serving_deadline_misses_total`).

Session engines (templates/sessionrec) pad a second ragged axis, the
history length, onto the sequence-tier ladder below (`seq_tier_ladder`,
`seq_tiers_from_env`, `pad_to_seq_tier`). The reference's span and
device-attribution calls are left out: they come with the device
telemetry.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

from predictionio_torch.serving.admission import DEADLINE_MISSES, DeadlineExceeded
from predictionio_torch.telemetry.registry import REGISTRY

log = logging.getLogger(__name__)

BATCH_SIZE = REGISTRY.histogram(
    "serving_batch_size",
    "Queries per batched dispatch (before padding)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
QUEUE_DEPTH = REGISTRY.gauge(
    "serving_queue_depth", "Predict requests waiting in the batch queue")
QUEUE_WAIT = REGISTRY.histogram(
    "serving_queue_wait_seconds",
    "Time a predict request spent queued before its batch dispatched "
    "(queued requests only; inline batch-of-1 dispatches never queue)")
BATCHES = REGISTRY.counter(
    "serving_batches_total", "Batched dispatches issued")
PADDED_ROWS = REGISTRY.counter(
    "serving_padded_rows_total",
    "Padding rows added to reach a fixed batch bucket")

# cached unlabelled children: labels() re-validates and re-locks per call,
# and these run on the per-request hot path
_BATCH_SIZE = BATCH_SIZE.labels()
_QUEUE_DEPTH = QUEUE_DEPTH.labels()
_QUEUE_WAIT = QUEUE_WAIT.labels()
_BATCHES = BATCHES.labels()
_PADDED_ROWS = PADDED_ROWS.labels()
_DEADLINE_MISS = DEADLINE_MISSES.labels()

# submit() must never hang forever on a lost dispatcher; requests without
# a deadline still time out after this long
_NO_DEADLINE_TIMEOUT_S = 300.0
# a request WITH a deadline waits this much past it for the dispatcher to
# deliver the miss verdict before declaring the miss itself
_DEADLINE_GRACE_S = 0.05


def bucket_ladder(max_batch: int) -> tuple:
    """Fixed dispatch sizes: powers of two up to (and including) max_batch."""
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b <<= 1
    out.append(max_batch)
    return tuple(out)


# -- sequence-length ladder ---------------------------------------------------
# The batch ladder above bounds the BATCH dimension of a scorer; sequence
# engines (templates/sessionrec) have a second ragged axis, the per-user
# history length. Histories pad up to these fixed tiers with masked pad
# positions (causal masking and the last-real-position readout make the
# pads exact no-ops, so a history scores bitwise the same at every tier
# that fits it), so a scorer sees tier-many lengths, not one per history.

_SEQ_TIER_BASE = 8


def seq_tier_ladder(max_len: int, base: int = _SEQ_TIER_BASE) -> tuple:
    """Power-of-two sequence tiers from `base` up to (and including) the
    smallest power of two ≥ max_len."""
    out = []
    t = max(1, base)
    while t < max_len:
        out.append(t)
        t <<= 1
    out.append(t)
    return tuple(out)


def seq_tiers_from_env(max_len: int) -> tuple:
    """The sequence-tier ladder: PIO_SERVING_SEQ_TIERS (comma-separated
    lengths, e.g. "8,32") when set, else the power-of-two ladder. Tiers
    are sorted, deduped, and always cover max_len: a ladder whose top
    tier undercuts the model's window length would silently truncate
    histories, so one is appended if needed."""
    raw = os.environ.get("PIO_SERVING_SEQ_TIERS", "").strip()
    if raw:
        try:
            tiers = sorted({int(p) for p in raw.split(",") if p.strip()})
            tiers = [t for t in tiers if t > 0]
        except ValueError:
            log.warning("ignoring unparseable PIO_SERVING_SEQ_TIERS=%r", raw)
            tiers = []
        if tiers:
            if tiers[-1] < max_len:
                tiers.append(max_len)
            return tuple(tiers)
    return seq_tier_ladder(max_len)


def pad_to_seq_tier(n: int, tiers: Sequence[int]) -> int:
    """Smallest tier ≥ n (the top tier for longer histories: callers
    truncate to it, keeping the newest items)."""
    for t in tiers:
        if n <= t:
            return int(t)
    return int(tiers[-1])


@dataclasses.dataclass
class BatcherConfig:
    # largest number of real queries per dispatch. Default stays at or
    # under ops/ranking.SERVE_HOST_MAX_BATCH so serving never wanders
    # onto the (possibly busy) device.
    max_batch: int = 32
    # cap on how long a forming batch is held open for admitted requests
    # that are not yet queued (see module docstring); with a pending_fn
    # the hold usually ends far earlier, the moment the queue holds every
    # admitted request. 0 disables holding entirely (opportunistic only).
    max_wait_ms: float = 5.0


class _Pending:
    __slots__ = ("query", "deadline", "enqueued_at", "done", "result",
                 "error")

    def __init__(self, query, deadline: Optional[float]):
        self.query = query
        self.deadline = deadline
        self.enqueued_at = time.monotonic()
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None

    def finish(self, result=None, error: Optional[BaseException] = None):
        self.result = result
        self.error = error
        self.done.set()


class MicroBatcher:
    """Coalesces `submit()` calls into batched `dispatch_fn` calls.

    `dispatch_fn(queries: list) -> list[results]` must return one result
    per query, in order (Engine.predict_batch's contract)."""

    def __init__(self, dispatch_fn: Callable[[List], List],
                 config: Optional[BatcherConfig] = None,
                 pending_fn: Optional[Callable[[], int]] = None):
        self.dispatch_fn = dispatch_fn
        self.config = config or BatcherConfig()
        self._buckets = bucket_ladder(self.config.max_batch)
        # upstream in-flight count (AdmissionController.admitted via the
        # ServingPlane): the signal that makes the fill hold adaptive
        self._pending_fn = pending_fn
        self._queue: deque[_Pending] = deque()
        self._cond = threading.Condition()
        self._closed = False
        # True while ANY dispatch runs (inline or dispatcher-thread).
        # Dispatch exclusivity is what makes batches form: arrivals
        # during a running dispatch queue up and leave as one batch.
        self._busy = False
        self._thread = threading.Thread(
            target=self._run, name="predictionserver-batcher", daemon=True)
        self._thread.start()

    # -- request side ------------------------------------------------------
    def submit(self, query, deadline: Optional[float] = None):
        """Enqueue one query, block until its batch ran, return its result
        (or re-raise the error its dispatch produced). Uncontended calls
        skip the queue and dispatch inline on this thread."""
        with self._cond:
            if self._closed:
                raise RuntimeError("serving batcher is shut down")
            if (not self._busy and not self._queue
                    and (self.config.max_wait_ms <= 0
                         or (self._pending_fn is not None
                             and self._pending_fn() <= 1))):
                # nothing running, nothing queued, and (admitted-aware
                # case) this request is the only one in flight: dispatch
                # on this thread, skip the queue handoff entirely
                self._busy = True
                inline = True
            else:
                p = _Pending(query, deadline)
                self._queue.append(p)
                _QUEUE_DEPTH.set(len(self._queue))
                self._cond.notify_all()
                inline = False
        if inline:
            try:
                if deadline is not None and time.monotonic() >= deadline:
                    _DEADLINE_MISS.inc()
                    raise DeadlineExceeded("deadline expired before dispatch")
                # no QUEUE_WAIT observation: inline dispatches never queue,
                # and a stream of zeros would only flatten the histogram
                _BATCH_SIZE.observe(1)
                _BATCHES.inc()
                results = self.dispatch_fn([query])
                if len(results) != 1:
                    raise RuntimeError(
                        f"batched dispatch returned {len(results)} results "
                        f"for 1 queries")
                return results[0]
            finally:
                with self._cond:
                    self._busy = False
                    # the dispatcher waits only for queued work: a lone
                    # request's dispatch leaves it asleep
                    if self._queue:
                        self._cond.notify_all()
        if deadline is None:
            timeout = _NO_DEADLINE_TIMEOUT_S
        else:
            timeout = max(0.0, deadline - time.monotonic()) + _DEADLINE_GRACE_S
        if not p.done.wait(timeout):
            # dispatcher wedged past the deadline (e.g. a long dispatch in
            # front of us): declare the miss here; the late result, if one
            # ever arrives, is discarded with the pending entry
            if deadline is not None:
                _DEADLINE_MISS.inc()
                raise DeadlineExceeded("deadline expired while queued")
            raise RuntimeError(
                f"batched dispatch produced no result within "
                f"{_NO_DEADLINE_TIMEOUT_S:.0f}s")
        if p.error is not None:
            raise p.error
        return p.result

    # -- dispatcher side ---------------------------------------------------
    def _take_batch(self) -> Optional[List[_Pending]]:
        """Block until work exists and no dispatch is running (or
        shutdown), then take ≤max_batch and mark the batcher busy."""
        cfg = self.config
        with self._cond:
            while (not self._queue or self._busy) and not self._closed:
                self._cond.wait()
            if not self._queue:
                return None  # closed and drained
            if cfg.max_wait_ms > 0:
                # hold the forming batch open — up to max_wait_ms — for
                # admitted requests that have not reached the queue yet.
                # With a pending_fn the hold is adaptive: once the queue
                # holds every admitted request, nobody else can arrive
                # until someone is answered, so waiting longer is pure
                # idle and the batch goes out immediately.
                barrier = self._queue[0].enqueued_at + cfg.max_wait_ms / 1e3
                pending = self._pending_fn
                while len(self._queue) < cfg.max_batch and not self._closed:
                    if pending is not None and len(self._queue) >= pending():
                        break
                    remaining = barrier - time.monotonic()
                    if remaining <= 0:
                        break
                    # short wait slices: the admitted count moves under
                    # the admission lock, which never notifies this
                    # condition — re-poll rather than sleep the full cap
                    self._cond.wait(remaining if pending is None
                                    else min(remaining, 0.0005))
            batch = []
            while self._queue and len(batch) < cfg.max_batch:
                batch.append(self._queue.popleft())
            _QUEUE_DEPTH.set(len(self._queue))
            self._busy = True
            return batch

    def _split_expired(self, batch: Sequence[_Pending]) -> List[_Pending]:
        now = time.monotonic()
        live, expired = [], []
        for p in batch:
            (expired if p.deadline is not None and now >= p.deadline
             else live).append(p)
        for p in expired:
            _DEADLINE_MISS.inc()
            p.finish(error=DeadlineExceeded("deadline expired while queued"))
        return live

    def _pad(self, queries: List) -> List:
        n = len(queries)
        for b in self._buckets:
            if n <= b:
                if b > n:
                    _PADDED_ROWS.inc(b - n)
                    return queries + [queries[-1]] * (b - n)
                return queries
        return queries  # n == max_batch (largest bucket)

    def _dispatch(self, live: List[_Pending]) -> None:
        queries = [p.query for p in live]
        padded = self._pad(queries)
        try:
            results = self.dispatch_fn(padded)[:len(queries)]
            if len(results) != len(queries):
                raise RuntimeError(
                    f"batched dispatch returned {len(results)} results "
                    f"for {len(queries)} queries")
        except BaseException as e:  # noqa: BLE001 — isolate, then re-raise per item
            if len(live) == 1:
                live[0].finish(error=e)
                return
            # per-item fallback: one poisoned query must not fail the
            # batch it happened to share. Each retry re-pads the lone
            # query back up to the ORIGINAL bucket size (the _pad idiom:
            # duplicate rows, surplus results dropped) instead of
            # dispatching a bare batch of one.
            log.debug("batched dispatch failed (%s); retrying per item", e)
            for p in live:
                try:
                    p.finish(result=self.dispatch_fn(
                        [p.query] * len(padded))[0])
                except BaseException as item_e:  # noqa: BLE001
                    p.finish(error=item_e)
            return
        for p, r in zip(live, results):
            p.finish(result=r)

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                live = self._split_expired(batch)
                if not live:
                    continue
                now = time.monotonic()
                for p in live:
                    _QUEUE_WAIT.observe(now - p.enqueued_at)
                _BATCH_SIZE.observe(len(live))
                _BATCHES.inc()
                self._dispatch(live)
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    # -- lifecycle ---------------------------------------------------------
    def close(self, timeout: float = 5.0) -> None:
        """Stop accepting work, fail anything still queued, join the
        dispatcher. Idempotent."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            while self._queue:
                self._queue.popleft().finish(
                    error=RuntimeError("serving batcher shut down"))
            _QUEUE_DEPTH.set(0)
            self._cond.notify_all()
        self._thread.join(timeout=timeout)
