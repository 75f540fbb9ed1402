"""Session-state fold handle: the online plane's second model family —
own copy of the reference's ``predictionio_tpu/online/session.py``.

Where `foldin.ALSFold` re-solves factor rows, `SessionFold` rebuilds
per-user session state for the sessionrec template: each dirty user's
recent-item window is recomputed from their FULL keep-last history
(`models.session_model.recent_window`, the same canonical rule the
training DataSource applies) and the user's pooled session embedding is
recomputed from the new window. The plane then delta-swaps the new
model and invalidates exactly the touched users' cache entries, the
same publish path ALS folds take.

Replay vs idempotence for append-only windows: the tailer is
at-least-once, so a crash between fold and watermark replays the batch.
A naive "append the new events to the window" fold would double-append
on replay; rebuilding from the full keep-last history instead makes the
fold a pure function of (item → latest event time), so re-applying the
same events lands on a bit-identical window and session embedding.

Cold items (ids the last retrain never embedded) are dropped from
windows and counted in `session_cold_items_total`; they start scoring
after the next retrain, as a cold opposing row in ALS fold-in
contributes nothing until its own side solves.

The fold is host numpy (a window and a row mean); the scorer's device
copy of the weights (`SessionRecModel.device_params`) does not change
under it, so the folded model starts from a shallow copy of the old
model's copies: its own dict, the same tensors.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Tuple

from predictionio_torch.models.session_model import (
    SessionRecModel,
    recent_window,
)
from predictionio_torch.online.foldin import FoldModel, FoldStats
from predictionio_torch.online.metrics import (
    SESSION_COLD_ITEMS,
    SESSION_WINDOWS_FOLDED,
)

log = logging.getLogger(__name__)

SESSION_FAMILY = "sessionrec"


class SessionFold(FoldModel):
    """Fold handle for `SessionRecModel` (see module docstring)."""

    family = SESSION_FAMILY

    def __init__(self, max_seq_len: int):
        self.max_seq_len = int(max_seq_len)

    def fold(self, model: SessionRecModel,
             user_hist: Dict[str, List[Tuple[str, float, object]]],
             item_hist=None) -> Tuple[SessionRecModel, FoldStats]:
        """Rebuild the dirty users' windows + session embeddings into a
        NEW model (input never mutated). `user_hist[user]` is the full
        keep-last [(item, value, event_time)] history; values are
        ignored — a session window is a pure function of (item, time).
        `item_hist` is accepted for protocol symmetry and unused: items
        have no per-item session state."""
        stats = FoldStats()
        if not user_hist:
            return model, stats
        windows = dict(model.user_windows)
        vecs = dict(model.session_vecs)
        cold_items = set()
        for user, triples in sorted(user_hist.items()):
            known = []
            for item, _value, t in triples:
                if model.item_ids.contains(str(item)):
                    known.append((str(item), t))
                else:
                    cold_items.add(str(item))
            window = tuple(recent_window(known, self.max_seq_len))
            windows[user] = window
            vecs[user] = model.session_vec_of(window)
            stats.folded_users += 1
        stats.new_items = len(cold_items)
        folded = dataclasses.replace(
            model, user_windows=windows, session_vecs=vecs,
            _on_device=dict(model._on_device))
        SESSION_WINDOWS_FOLDED.inc(stats.folded_users)
        if cold_items:
            SESSION_COLD_ITEMS.inc(len(cold_items))
        return folded, stats
