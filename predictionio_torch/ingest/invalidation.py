"""Commit-notification bus — own copy of the reference's
``predictionio_tpu/ingest/invalidation.py``.

A per-user result cache answers /queries.json from memory; this bus is
what keeps it read-your-writes. A publisher sends the entity ids whose
answers changed once the change is durable (in the reference, every
commit path of the ingest write plane; in the port, today, the online
plane's `online.swap.DeltaSwapper` after each fold), and subscribers
(`serving.plane.ServingPlane`'s result cache) drop whatever they hold
for those entities.

Messages optionally carry an **engine variant id**. A plain data commit
(`variant=None`) may change any variant's answer, so every subscriber
acts on it; a variant-scoped message (a fold swapped into one variant)
only concerns that variant's cache. Subscribers that predate variants —
one-argument callables — keep working: the bus detects at subscribe time
whether the callable can take the variant and calls it accordingly.

Deliberately minimal:

- process-local: the cache and its publishers live in one process.
- zero hot-path cost when unused: publishers can check
  `has_subscribers` (one attribute read) before building the id list.
- subscriber errors are contained: a broken subscriber cannot fail a
  change that is already durable.
"""

from __future__ import annotations

import inspect
import logging
import threading
from typing import Callable, Iterable, List, Optional, Tuple

log = logging.getLogger(__name__)


def _accepts_variant(fn: Callable) -> bool:
    """True when `fn(entity_ids, variant)` is callable: a second
    positional slot (or *args) exists. Builtin callables that refuse
    introspection (list.append) are treated as single-argument."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    positional = 0
    for p in sig.parameters.values():
        if p.kind == p.VAR_POSITIONAL:
            return True
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            positional += 1
    return positional >= 2


class InvalidationBus:
    __slots__ = ("_subs", "_lock")

    def __init__(self):
        self._subs: List[Tuple[Callable, bool]] = []
        self._lock = threading.Lock()

    @property
    def has_subscribers(self) -> bool:
        return bool(self._subs)

    def subscribe(self, fn: Callable) -> None:
        with self._lock:
            if all(s != fn for s, _ in self._subs):
                # replace the list instead of mutating it so publish()
                # iterates a stable snapshot without taking the lock
                self._subs = self._subs + [(fn, _accepts_variant(fn))]

    def unsubscribe(self, fn: Callable) -> None:
        # equality, not identity: bound methods (cache.invalidate_entities,
        # list.append) are fresh objects on every attribute access, and
        # subscribe's dedup (`s != fn`) already compares by equality
        with self._lock:
            self._subs = [(s, w) for s, w in self._subs if s != fn]

    def publish(self, entity_ids: Iterable[str],
                variant: Optional[str] = None) -> None:
        """Fan changed entity ids out to every subscriber. Called AFTER
        the change is durable — a subscriber that invalidates on this
        signal can never cache ahead of storage. `variant=None` means the
        change may affect every variant; a named variant scopes the
        message to that variant's caches."""
        for fn, wants_variant in self._subs:
            try:
                if wants_variant:
                    fn(entity_ids, variant)
                else:
                    fn(entity_ids)
            except Exception:
                log.exception("invalidation subscriber failed")


# One bus per process: publishers publish here unconditionally, whichever
# server object owns them; caches subscribe at construction.
BUS = InvalidationBus()
