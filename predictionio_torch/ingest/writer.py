"""Group-commit writer: concurrent single-event inserts → one durable
transaction. Own copy of the reference's
``predictionio_tpu/ingest/writer.py``.

Handler threads `submit()` one event and block; a single committer
thread drains the queue and commits everything that arrived together
under ONE storage transaction (`LEvents.insert_grouped`), then wakes the
waiters with their event ids. A 201 is therefore never sent for a row
that has not committed: `submit()` returns only after the shared commit
(or the caller's individual fallback insert) is done.

Coalescing is admission-aware: the writer's own admission count tells
the committer how many requests are in flight, and a forming group is
held open only while admitted requests are still missing from the
queue. `max_wait_ms` caps that hold. A lone request (admitted ≤ 1)
commits inline on the calling thread: no enqueue, no thread handoff.

Failure isolation: when a grouped commit raises and the group held more
than one event, the transaction rolled back (nothing from the group is
stored) and the writer redoes each event on its own, so one poisoned
event (a duplicate caller-set eventId) answers its own 400 instead of
failing the requests committed beside it.

Backpressure: admission is a bounded in-flight budget (`max_queue`).
Past it, `submit()` raises `IngestOverload`, which the event server maps
to 429 + Retry-After (`ingest_shed_total`).

Configuration resolves from PIO_INGEST_* (`IngestConfig.from_env`). The
reference's per-request spans and tenant metering are not ported
(ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Tuple

from predictionio_torch.ingest.invalidation import BUS
from predictionio_torch.telemetry.lineage import LINEAGE, context_of
from predictionio_torch.telemetry.registry import REGISTRY

log = logging.getLogger(__name__)

GROUP_SIZE = REGISTRY.histogram(
    "ingest_group_size",
    "Events per grouped commit (1 = inline/lone insert)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128))
FILL_WAIT = REGISTRY.histogram(
    "ingest_fill_wait_seconds",
    "Time an event waited queued before its group committed "
    "(queued events only; inline lone inserts never queue)")
COMMIT_SECONDS = REGISTRY.histogram(
    "ingest_commit_seconds",
    "Durable-commit latency of one grouped (or inline) insert")
COMMITS = REGISTRY.counter(
    "ingest_commits_total", "Durable commits issued by the write plane")
SHED = REGISTRY.counter(
    "ingest_shed_total",
    "Ingest requests shed by the write plane's bounded queue (HTTP 429)")
FALLBACKS = REGISTRY.counter(
    "ingest_fallbacks_total",
    "Grouped commits that failed and were redone per event")
IN_FLIGHT = REGISTRY.gauge(
    "ingest_in_flight",
    "Ingest requests currently inside the write plane (queued or "
    "committing)")
QUEUE_DEPTH = REGISTRY.gauge(
    "ingest_queue_depth", "Events waiting in the group-commit queue")

# cached unlabelled children: labels() re-validates and re-locks per call
_GROUP_SIZE = GROUP_SIZE.labels()
_FILL_WAIT = FILL_WAIT.labels()
_COMMIT_SECONDS = COMMIT_SECONDS.labels()
_COMMITS = COMMITS.labels()
_SHED = SHED.labels()
_FALLBACKS = FALLBACKS.labels()
_IN_FLIGHT = IN_FLIGHT.labels()
_QUEUE_DEPTH = QUEUE_DEPTH.labels()

# submit() must never hang forever on a lost committer thread
_NO_RESULT_TIMEOUT_S = 300.0

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


class IngestOverload(Exception):
    """Raised when the write plane's bounded queue rejects an event
    under saturation. Maps to HTTP 429 with a `Retry-After` header."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class IngestConfig:
    # group commit on/off; backpressure is NOT optional — with grouping
    # off, single inserts still run under the bounded in-flight budget
    grouping: bool = True
    # largest number of events per shared transaction
    max_group: int = 64
    # cap on how long a forming group is held open for admitted requests
    # that have not reached the queue yet; 0 disables holding
    max_wait_ms: float = 2.0
    # bounded in-flight budget: queued + committing. Past it new events
    # shed with 429 instead of queueing into collapse.
    max_queue: int = 256
    # advisory backoff answered on 429
    retry_after_s: float = 1.0

    @classmethod
    def from_env(cls) -> "IngestConfig":
        """Resolve from PIO_INGEST_* (every knob optional):

        PIO_INGEST_GROUPING=0|1, PIO_INGEST_MAX_GROUP,
        PIO_INGEST_MAX_WAIT_MS, PIO_INGEST_MAX_QUEUE,
        PIO_INGEST_RETRY_AFTER_S."""
        cfg = cls()
        raw = os.environ.get("PIO_INGEST_GROUPING")
        if raw is not None:
            cfg.grouping = raw.strip().lower() in _TRUTHY
        cfg.max_group = int(
            _env_float("PIO_INGEST_MAX_GROUP", cfg.max_group))
        cfg.max_wait_ms = _env_float(
            "PIO_INGEST_MAX_WAIT_MS", cfg.max_wait_ms)
        cfg.max_queue = int(
            _env_float("PIO_INGEST_MAX_QUEUE", cfg.max_queue))
        cfg.retry_after_s = _env_float(
            "PIO_INGEST_RETRY_AFTER_S", cfg.retry_after_s)
        return cfg


class _PendingWrite:
    __slots__ = ("item", "enqueued_at", "done", "result", "error")

    def __init__(self, item: Tuple):
        self.item = item  # (event, app_id, channel_id)
        self.enqueued_at = time.monotonic()
        self.done = threading.Event()
        self.result: Optional[str] = None
        self.error: Optional[BaseException] = None

    def finish(self, result=None, error: Optional[BaseException] = None):
        self.result = result
        self.error = error
        self.done.set()


class GroupCommitWriter:
    """Coalesces `submit()` calls into `grouped_fn` transactions.

    `insert_fn(event, app_id, channel_id) -> event_id` — one durable
    single-event insert (LEvents.insert).
    `grouped_fn(items) -> list[event_id]` — one durable transaction for
    heterogeneous (event, app_id, channel_id) tuples
    (LEvents.insert_grouped); returning implies the commit happened.

    Both are plain attributes so a test can wrap them to slow the
    storage layer down."""

    def __init__(self,
                 insert_fn: Callable[..., str],
                 grouped_fn: Callable[[List[Tuple]], List[str]],
                 config: Optional[IngestConfig] = None,
                 name: str = "eventserver"):
        self.insert_fn = insert_fn
        self.grouped_fn = grouped_fn
        self.config = config or IngestConfig()
        self.name = name
        self._queue: deque[_PendingWrite] = deque()
        self._cond = threading.Condition()
        self._closed = False
        # True while ANY commit runs (inline or committer-thread).
        # Commit exclusivity is what makes groups form: arrivals during
        # a running commit queue up and leave as one transaction.
        self._busy = False
        # bounded in-flight budget (admission): one lock, one counter
        self._admit_lock = threading.Lock()
        self._admitted = 0
        self._thread: Optional[threading.Thread] = None
        if self.config.grouping:
            self._thread = threading.Thread(
                target=self._run, name=f"{name}-groupcommit", daemon=True)
            self._thread.start()

    # -- admission ---------------------------------------------------------
    def _admit(self) -> None:
        with self._admit_lock:
            if self._admitted >= self.config.max_queue:
                _SHED.inc()
                raise IngestOverload(
                    f"ingest queue saturated "
                    f"({self._admitted}/{self.config.max_queue} in flight)",
                    retry_after_s=self.config.retry_after_s)
            self._admitted += 1
        _IN_FLIGHT.set(self._admitted)

    def _release(self) -> None:
        with self._admit_lock:
            self._admitted -= 1
        _IN_FLIGHT.set(self._admitted)

    # -- request side ------------------------------------------------------
    def submit(self, event, app_id: int, channel_id=None) -> str:
        """Commit one event and return its id (or re-raise the error its
        commit produced — e.g. the backend's IntegrityError for a
        duplicate caller-set eventId). Blocks until the shared commit
        (or the individual fallback insert) completed; raises
        IngestOverload past the bounded in-flight budget."""
        self._admit()
        try:
            return self._submit_admitted(event, app_id, channel_id)
        finally:
            self._release()

    def _submit_admitted(self, event, app_id: int, channel_id) -> str:
        if not self.config.grouping:
            # grouping off: still admission-bounded, but every insert is
            # its own transaction
            return self._commit_inline(event, app_id, channel_id)
        with self._cond:
            if self._closed:
                raise RuntimeError("ingest write plane is shut down")
            if (not self._busy and not self._queue
                    and (self.config.max_wait_ms <= 0
                         or self._admitted <= 1)):
                # nothing committing, nothing queued, and this request is
                # the only one in flight: commit on this thread, skip the
                # queue handoff entirely
                self._busy = True
                inline = True
            else:
                p = _PendingWrite((event, app_id, channel_id))
                self._queue.append(p)
                _QUEUE_DEPTH.set(len(self._queue))
                self._cond.notify_all()
                inline = False
        if inline:
            try:
                return self._commit_inline(event, app_id, channel_id)
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()
        if not p.done.wait(_NO_RESULT_TIMEOUT_S):
            raise RuntimeError(
                f"grouped commit produced no result within "
                f"{_NO_RESULT_TIMEOUT_S:.0f}s")
        if p.error is not None:
            raise p.error
        return p.result

    def _commit_inline(self, event, app_id: int, channel_id) -> str:
        _GROUP_SIZE.observe(1)
        _COMMITS.inc()
        t0 = time.perf_counter()
        eid = self.insert_fn(event, app_id, channel_id)
        commit_s = time.perf_counter() - t0
        _COMMIT_SECONDS.observe(commit_s)
        LINEAGE.record_stage(context_of(event), "commit",
                             duration_s=commit_s)
        self.notify_committed((event,))
        return eid

    def notify_committed(self, events) -> None:
        """Publish committed events' entity ids on the invalidation bus
        (the serving result cache drops those users' entries). Called
        after every commit path here, and by the batch route whose
        insert_batch bypasses this writer. Free when nothing subscribes.

        `$reward` events publish variant-scoped: the reward credits one
        engine variant and cannot stale another variant's cached
        answers. Everything else publishes unscoped."""
        if not BUS.has_subscribers:
            return
        ids = []
        by_variant: dict = {}
        for e in events:
            eid = getattr(e, "entity_id", None)
            if not eid:
                continue
            if getattr(e, "event", None) == "$reward":
                try:
                    variant = e.properties.to_dict().get("variant")
                except Exception:  # noqa: BLE001 — malformed props: unscoped
                    variant = None
                if isinstance(variant, str) and variant:
                    by_variant.setdefault(variant, []).append(eid)
                    continue
            ids.append(eid)
        if ids:
            BUS.publish(ids)
        for variant, vids in by_variant.items():
            BUS.publish(vids, variant=variant)

    # -- committer side ----------------------------------------------------
    def _take_group(self) -> Optional[List[_PendingWrite]]:
        """Block until work exists and no commit is running (or
        shutdown), then take ≤max_group and mark the writer busy."""
        cfg = self.config
        with self._cond:
            while (not self._queue or self._busy) and not self._closed:
                self._cond.wait()
            if not self._queue:
                return None  # closed and drained
            if cfg.max_wait_ms > 0:
                # hold the forming group open — up to max_wait_ms — for
                # admitted requests that have not reached the queue yet.
                # Once the queue holds every admitted request, nobody
                # else can arrive until someone is acknowledged, so the
                # group commits now.
                barrier = self._queue[0].enqueued_at + cfg.max_wait_ms / 1e3
                while len(self._queue) < cfg.max_group and not self._closed:
                    if len(self._queue) >= self._admitted:
                        break
                    remaining = barrier - time.monotonic()
                    if remaining <= 0:
                        break
                    # short wait slices: the admitted count moves under
                    # the admission lock, which never notifies this
                    # condition — re-poll rather than sleep the full cap
                    self._cond.wait(min(remaining, 0.0005))
            group = []
            while self._queue and len(group) < cfg.max_group:
                group.append(self._queue.popleft())
            _QUEUE_DEPTH.set(len(self._queue))
            self._busy = True
            return group

    def _commit(self, group: List[_PendingWrite]) -> None:
        items = [p.item for p in group]
        t0 = time.perf_counter()
        try:
            ids = self.grouped_fn(items)
            if len(ids) != len(items):
                raise RuntimeError(
                    f"grouped commit returned {len(ids)} ids for "
                    f"{len(items)} events")
        except BaseException as e:  # noqa: BLE001 — isolate, then redo
            if len(group) == 1:
                LINEAGE.record_stage(context_of(group[0].item[0]), "commit",
                                     duration_s=time.perf_counter() - t0,
                                     error=True)
                group[0].finish(error=e)
                return
            # per-item fallback: the shared transaction rolled back
            # (nothing from the group is stored), so redo each event on
            # its own — one poisoned event answers its own error
            _FALLBACKS.inc()
            log.debug("grouped commit failed (%s); redoing per event", e)
            for p in group:
                t_item = time.perf_counter()
                try:
                    r = self.insert_fn(*p.item)
                    LINEAGE.record_stage(
                        context_of(p.item[0]), "commit",
                        duration_s=time.perf_counter() - t_item)
                    # invalidate BEFORE acknowledging: the waiter's 201
                    # must imply the cache no longer serves stale answers
                    self.notify_committed((p.item[0],))
                    p.finish(result=r)
                except BaseException as item_e:  # noqa: BLE001
                    LINEAGE.record_stage(
                        context_of(p.item[0]), "commit",
                        duration_s=time.perf_counter() - t_item, error=True)
                    p.finish(error=item_e)
            return
        commit_s = time.perf_counter() - t0
        _COMMIT_SECONDS.observe(commit_s)
        now = time.time()
        for p in group:
            LINEAGE.record_stage(context_of(p.item[0]), "commit",
                                 duration_s=commit_s, now=now)
        self.notify_committed([p.item[0] for p in group])
        for p, eid in zip(group, ids):
            p.finish(result=eid)

    def _run(self) -> None:
        while True:
            group = self._take_group()
            if group is None:
                return
            try:
                now = time.monotonic()
                for p in group:
                    _FILL_WAIT.observe(now - p.enqueued_at)
                _GROUP_SIZE.observe(len(group))
                _COMMITS.inc()
                self._commit(group)
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    # -- lifecycle ---------------------------------------------------------
    def close(self, timeout: float = 5.0) -> None:
        """Stop accepting work, fail anything still queued, join the
        committer. Idempotent."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            while self._queue:
                self._queue.popleft().finish(
                    error=RuntimeError("ingest write plane shut down"))
            _QUEUE_DEPTH.set(0)
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
