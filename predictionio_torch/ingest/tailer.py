"""StoreTailer: the crash-safe watermark+overlap+dedup tail loop — own
copy of the reference's ``predictionio_tpu/ingest/tailer.py``.

Any plane can turn the durable event store into a push feed with it.
The contract:

- **watermark + overlap** — each poll asks the store for events from
  slightly before the newest event time already seen. The overlap
  re-reads a few duplicate rows, because group-commit batches can land
  with event times that interleave with an in-flight poll; the `_seen`
  id map makes re-applying them impossible.
- **restart recovery** — a fresh tailer has no watermark, so its first
  poll replays history (optionally from an explicit `since`). Consumers
  must therefore be idempotent under replay, as ALS fold-in is: it
  re-solves a row against the row's full history (same inputs → same
  factors).
- **two delivery modes** —
  * *streaming* (default): each event is marked seen and the watermark advanced **before**
    `_apply(e)` runs, so a consumer that throws mid-batch does not
    re-deliver the events it already consumed (at-most-once per event).
  * *batch* (`_process` overridden, as the online plane does): the
    whole fresh batch is handed over first and the watermark/seen state
    advances only after `_process` returns. A crash between fold-in and
    watermark advance replays the batch on the next poll
    (at-least-once; safe because fold-in is idempotent).
"""

from __future__ import annotations

import logging
import threading
from datetime import timedelta
from typing import List, Optional

from predictionio_torch.telemetry.lineage import LINEAGE, context_of

log = logging.getLogger(__name__)

# how far behind the watermark each poll re-reads; must exceed the gap
# between a commit's event_time and its visibility in the store
OVERLAP = timedelta(seconds=2.0)

# prune the seen-id map once it grows past this many entries; only keys
# inside the overlap window can recur in a future poll
_SEEN_PRUNE_AT = 4096


class StoreTailer:
    """Poll the durable event store and deliver fresh events exactly once
    (streaming mode) or at-least-once (batch mode, see module doc)."""

    def __init__(self, storage, app_id: int = 1,
                 channel_id: Optional[int] = None,
                 interval_s: float = 0.5,
                 event_names: Optional[List[str]] = None,
                 overlap: timedelta = OVERLAP,
                 name: str = "store-tailer",
                 since=None,
                 max_batch: Optional[int] = None):
        self.storage = storage
        self.app_id = app_id
        self.channel_id = channel_id
        self.interval_s = interval_s
        self.event_names = event_names
        self.overlap = overlap
        self.name = name
        self.max_batch = max_batch
        self._since = since  # event-time watermark; None → full replay
        self._seen: dict = {}  # applied-event key → event_time
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _event_key(e) -> object:
        if e.event_id:
            return e.event_id
        return (e.entity_id, e.event_time, repr(e.properties.to_dict()))

    # -- one pass -----------------------------------------------------------
    def poll_once(self) -> int:
        """One tail pass. Returns the number of events newly applied."""
        fresh = self._collect()
        for e in fresh:
            # re-attached by the storage read path; the pickup lag IS the
            # watermark lag (origin → this poll) for that event
            LINEAGE.record_stage(context_of(e), "tailer_pickup",
                                 detail=self.name)
        applied = self._process(fresh)
        self._prune_seen()
        return applied

    def _collect(self) -> list:
        """Fetch events past the watermark, drop duplicates, cap batch."""
        start = self._since - self.overlap if self._since is not None else None
        events = self.storage.l_events().find(
            self.app_id, channel_id=self.channel_id,
            start_time=start, event_names=self.event_names)
        fresh, keys = [], set()
        for e in events:
            key = self._event_key(e)
            if key in self._seen or key in keys:
                continue
            keys.add(key)
            fresh.append(e)
        fresh.sort(key=lambda e: e.event_time)
        if self.max_batch is not None:
            fresh = fresh[:self.max_batch]
        return fresh

    def _process(self, fresh: list) -> int:
        """Streaming delivery: mark each event consumed, then apply it.
        Subclasses that need the whole batch before any durability state
        advances (fold-in) override this; they must call `_mark(e)` for
        every event only once the batch is fully consumed."""
        applied = 0
        for e in fresh:
            self._mark(e)
            if self._apply(e):
                applied += 1
        return applied

    def _apply(self, e) -> bool:
        """Consume one event. Subclass hook for streaming mode."""
        raise NotImplementedError

    def _mark(self, e) -> None:
        """Advance the dedup map and watermark past one event."""
        self._seen[self._event_key(e)] = e.event_time
        if self._since is None or e.event_time > self._since:
            self._since = e.event_time

    def _prune_seen(self) -> None:
        if self._since is None or len(self._seen) < _SEEN_PRUNE_AT:
            return
        cutoff = self._since - 2 * self.overlap
        # single-writer: poll_once() is the synchronous alternative to the
        # background thread (tests, catch-up), never run concurrently with
        # it — and the rebuild publishes atomically by rebinding
        self._seen = {k: t for k, t in self._seen.items() if t >= cutoff}

    # -- background loop ----------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=self.name, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the tail loop must survive
                log.exception("%s tail pass failed; retrying", self.name)
            self._stop.wait(self.interval_s)
