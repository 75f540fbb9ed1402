"""Optional per-user result cache for the serving plane — own copy of the
reference's ``predictionio_tpu/serving/result_cache.py``.

A recommender's query stream is heavily repeated — the same user (or the
same anonymous popularity query) asks for the same slate many times
between events that would change the answer. The remaining per-request
cost on a repeated query is the dispatch itself; this cache removes it
when the operator opts in.

Correctness posture:

- OFF by default (`PIO_HTTP_RESULT_CACHE=1` enables).
- read-your-writes within a process: the cache subscribes to the
  invalidation bus (ingest/invalidation.py); every publisher (in the
  port, the online plane's `DeltaSwapper` after each fold) sends the
  entity ids whose answers changed, and the cache drops those users'
  entries.
- a short TTL (`PIO_HTTP_RESULT_CACHE_TTL_S`, default 5 s) covers changes
  no in-process publisher announces.
- queries that carry no user key are indexed under "" and still
  invalidated by ANY notification — an anonymous/popularity query can
  depend on any event, so correctness beats retention.
- no stale put: a miss takes the cache's invalidation epoch (`token`)
  before it reads the served state, and `put` stores nothing when an
  invalidation of that user or variant ran since — the fold or reload
  that published it may have landed after the dispatch read the state,
  and nothing was cached yet for it to drop.
- keys are **variant-scoped**: the serving plane passes its engine
  variant into get/put and the variant becomes part of the cache key,
  so two variants answering the same query can never serve each other's
  results, and a variant hot swap (`/reload`) drops exactly its own
  entries via `invalidate_variant`. Notifications that name a variant
  (a fold swapped into one variant) only touch that variant's entries.

Capacity is LRU-bounded (`PIO_HTTP_RESULT_CACHE_SIZE`, default 1024
entries); hits/misses/invalidations are observable as
`http_result_cache_*` on /metrics.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Iterable, Optional

from predictionio_torch.telemetry.registry import REGISTRY
from predictionio_torch.utils import fastjson

RESULT_HITS = REGISTRY.counter(
    "http_result_cache_hits_total",
    "Serving queries answered from the per-user result cache")
RESULT_MISSES = REGISTRY.counter(
    "http_result_cache_misses_total",
    "Serving queries that missed the result cache and dispatched")
RESULT_INVALIDATIONS = REGISTRY.counter(
    "http_result_cache_invalidations_total",
    "Result-cache entries dropped by invalidation notifications")

_HITS = RESULT_HITS.labels()
_MISSES = RESULT_MISSES.labels()
_INVALIDATIONS = RESULT_INVALIDATIONS.labels()

_TRUTHY = {"1", "true", "yes", "on"}

# sentinel distinguishing "miss" from a cached None result
MISS = object()


def cache_from_env() -> Optional["ResultCache"]:
    """Build a cache when PIO_HTTP_RESULT_CACHE opts in; None otherwise."""
    if os.environ.get("PIO_HTTP_RESULT_CACHE", "").strip().lower() \
            not in _TRUTHY:
        return None
    size = int(float(os.environ.get("PIO_HTTP_RESULT_CACHE_SIZE") or 1024))
    ttl = float(os.environ.get("PIO_HTTP_RESULT_CACHE_TTL_S") or 5.0)
    return ResultCache(max_entries=size, ttl_s=ttl)


class ResultCache:
    """LRU + TTL map of (variant, canonical query) → result,
    user-indexed so one notification drops exactly that user's
    entries and variant-indexed so a hot swap drops exactly one
    variant's entries."""

    def __init__(self, max_entries: int = 1024, ttl_s: float = 5.0):
        self.max_entries = max_entries
        self.ttl_s = ttl_s
        self._lock = threading.Lock()
        # key → (result, expires_at_monotonic, user, variant)
        self._entries: "OrderedDict[str, tuple]" = OrderedDict()
        # user → set of live keys (the invalidation index)
        self._by_user: dict = {}
        # variant → set of live keys (the hot-swap index)
        self._by_variant: dict = {}
        # invalidation epochs: every invalidation bumps `_epoch` and
        # stamps the users or variant it named; a put whose token is older
        # than its user's or variant's stamp (or than `_floor`, raised when
        # the stamps are pruned or the cache cleared) is stale
        self._epoch = 0
        self._floor = 0
        self._user_epoch: dict = {}
        self._variant_epoch: dict = {}

    @staticmethod
    def _key(query, variant: str) -> Optional[str]:
        try:
            # \x1f separator: cannot appear in a variant id that came
            # from engine.json / PIO_EXPERIMENT_VARIANTS, so the key
            # space of one variant is disjoint from every other's
            return variant + "\x1f" + fastjson.dumps(query)
        except (TypeError, ValueError):
            return None  # unhashable/unencodable query: never cached

    @staticmethod
    def _user(query) -> str:
        if isinstance(query, dict):
            user = query.get("user")
            if user is not None:
                return str(user)
        return ""

    def get(self, query, variant: str = ""):
        """Return the cached result for this variant or the MISS
        sentinel (a hit under another variant's key is a miss here)."""
        key = self._key(query, variant)
        if key is None:
            _MISSES.inc()
            return MISS
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry[1] <= now:
                if entry is not None:
                    self._drop(key, entry)
                _MISSES.inc()
                return MISS
            self._entries.move_to_end(key)
            _HITS.inc()
            return entry[0]

    def token(self) -> int:
        """The invalidation epoch now. Take it on a miss, before the
        served state is read, and hand it to `put`."""
        with self._lock:
            return self._epoch

    def _stale(self, user: str, variant: str, token: int) -> bool:
        # lock held by caller
        return (token < self._floor
                or self._user_epoch.get(user, -1) > token
                or self._variant_epoch.get(variant, -1) > token)

    def _bump(self) -> int:
        # lock held by caller; the stamps stay bounded: past the bound
        # they collapse into `_floor`, which only refuses more puts
        self._epoch += 1
        if len(self._user_epoch) > 4 * self.max_entries:
            self._user_epoch.clear()
            self._floor = self._epoch
        return self._epoch

    def put(self, query, result, variant: str = "",
            token: Optional[int] = None) -> None:
        """Store a result. With `token` (from `token()`), store nothing if
        an invalidation of this user or variant ran since: the result may
        have been computed on the state it replaced."""
        key = self._key(query, variant)
        if key is None:
            return
        user = self._user(query)
        with self._lock:
            if token is not None and self._stale(user, variant, token):
                return
            old = self._entries.get(key)
            if old is not None:
                self._drop(key, old)
            self._entries[key] = (result, time.monotonic() + self.ttl_s,
                                  user, variant)
            self._by_user.setdefault(user, set()).add(key)
            self._by_variant.setdefault(variant, set()).add(key)
            while len(self._entries) > self.max_entries:
                evict_key, evict_entry = next(iter(self._entries.items()))
                self._drop(evict_key, evict_entry)

    def _drop(self, key: str, entry: tuple) -> None:
        # lock held by caller
        self._entries.pop(key, None)
        for index, slot in ((self._by_user, entry[2]),
                            (self._by_variant, entry[3])):
            keys = index.get(slot)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    index.pop(slot, None)

    def invalidate_entities(self, entity_ids: Iterable[str],
                            variant: Optional[str] = None) -> None:
        """InvalidationBus subscriber: drop every entry for the
        notified entities, plus all user-less entries —
        an anonymous query may depend on any event. A variant-scoped
        message (`variant` not None) only drops that variant's entries;
        other variants' cached answers were not affected by it."""
        dropped = 0
        with self._lock:
            users = set(str(e) for e in entity_ids)
            users.add("")
            epoch = self._bump()
            for user in users:
                self._user_epoch[user] = epoch
                keys = self._by_user.get(user)
                if not keys:
                    continue
                for key in list(keys):
                    entry = self._entries.get(key)
                    if entry is None:
                        keys.discard(key)
                        continue
                    if variant is not None and entry[3] != variant:
                        continue
                    self._drop(key, entry)
                    dropped += 1
        if dropped:
            _INVALIDATIONS.inc(dropped)

    def invalidate_variant(self, variant: str) -> None:
        """Drop every entry cached under one variant — the hot-swap
        hook: a reloaded variant must not serve pre-swap answers for
        the TTL tail."""
        dropped = 0
        with self._lock:
            self._variant_epoch[variant] = self._bump()
            keys = self._by_variant.get(variant)
            for key in list(keys or ()):
                entry = self._entries.get(key)
                if entry is not None:
                    self._drop(key, entry)
                    dropped += 1
        if dropped:
            _INVALIDATIONS.inc(dropped)

    def clear(self) -> None:
        with self._lock:
            self._floor = self._bump()
            self._entries.clear()
            self._by_user.clear()
            self._by_variant.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
