"""DeltaSwapper: publish folded models into the served-state table — own
copy of the reference's ``predictionio_tpu/online/swap.py``.

The prediction server reads `server._states[variant]` once per query
(workflow/create_server.py), so publishing a fold is one dict-entry
replacement under the state lock — the same atomic-swap contract as
`/reload`, minus the storage round trip. Two deliberate differences from
the full-reload path:

- **per-user invalidation** — a fold changes a handful of users'
  answers, so the swapper publishes exactly the touched user ids on the
  `ingest.invalidation.BUS`, scoped to the variant; a per-user result
  cache subscribed there drops only those users' entries.
- **stale-state detection** — a fold computed against state S must not
  clobber a full reload that landed mid-solve. The caller passes the
  state it folded from; on mismatch the swap is refused and the fold
  batch replays against the new state on the next poll (`StaleState`
  propagates through the tailer, which then does not advance its
  watermark — fold-in's idempotence makes the replay free).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

from predictionio_torch.ingest.invalidation import BUS
from predictionio_torch.online.metrics import ONLINE_STALE_SWAPS, ONLINE_SWAPS


class StaleState(RuntimeError):
    """A full /reload replaced the state this fold was computed from."""


class DeltaSwapper:
    def __init__(self, states: Dict[str, object], lock, bus=None):
        self._states = states
        self._lock = lock
        self._bus = bus if bus is not None else BUS

    def swap(self, variant: str, expected_state, models: List[object],
             touched_users: Optional[List[str]] = None) -> object:
        """Atomically replace `variant`'s models; returns the new state."""
        with self._lock:
            current = self._states.get(variant)
            if current is not expected_state:
                ONLINE_STALE_SWAPS.inc()
                raise StaleState(
                    f"served state for variant {variant!r} changed mid-fold")
            new_state = copy.copy(current)
            new_state.models = models
            self._states[variant] = new_state
        ONLINE_SWAPS.labels(variant=variant).inc()
        if touched_users:
            self._bus.publish(sorted(touched_users), variant=variant)
        return new_state
