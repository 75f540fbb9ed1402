"""SessionRecModel: the session-based next-item model's served state — the
port of ``predictionio_tpu/models/session_model.py``.

Everything here is id bookkeeping plus the ONE rule the training path
and the online fold share: what "a user's recent-item window" means. The
attention forward pass lives in `ops/session.py`, and the DASE components
in `templates/sessionrec/engine.py`.

The canonical window rule (`recent_window`): keep-last dedup per item
(an item's position is its LATEST event), order by (event time, item
id), keep the most recent `max_len` items. The (time, item) sort key,
not raw event order, makes the window a pure function of the keep-last
history, so replaying a batch of events rebuilds a bit-identical window.

The per-user `session_vecs` entry is the user's pooled session
embedding, the mean of the window's item-embedding rows. Serving's
attention scorer derives everything from the window itself; the pooled
vector lets drills and parity checks compare session state bitwise
without running the attention stack.

`params` stays a dict of numpy arrays, so a model file holds no device
tensor and loads on a machine without a card. The scorer's copy of the
params on a device is made once per loaded model and device
(`device_params`), never pickled; a model folded from it
(`online/session.py`) gets its own dict of the same copies.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from predictionio_torch.data.bimap import BiMap


def recent_window(pairs: Iterable[Tuple[str, object]],
                  max_len: int) -> List[str]:
    """Canonical session window over `(item_id, event_time)` pairs.

    Keep-last per item, sorted by (last event time, item id), most
    recent `max_len` items (all when `max_len` ≤ 0), oldest → newest.
    Re-applying the same events, or receiving them in another arrival
    order, gives the same window: only the latest time per item survives
    and the sort key breaks time ties by item id.
    """
    last: Dict[str, object] = {}
    for item, t in pairs:
        prev = last.get(item)
        if prev is None or not (t < prev):  # keep-last; ties keep newest
            last[item] = t
    ordered = sorted(last.items(), key=lambda kv: (kv[1], kv[0]))
    if max_len > 0:
        ordered = ordered[-max_len:]
    return [item for item, _ in ordered]


@dataclasses.dataclass
class SessionRecModel:
    """Served state of the sessionrec template.

    `params` is a dict of numpy arrays:

        emb    [V+1, D]  item embeddings; row V is the sequence pad row
        pos    [Lmax, D] learned positional embeddings (Lmax = top tier)
        blocks [{wq, wk, wv, wo, w1, b1, w2, b2}]  attention blocks

    `user_windows[user]` is the user's canonical recent-item window as
    item-id strings (oldest → newest, ≤ max_seq_len); `session_vecs` the
    matching pooled embedding per user. `device` is where the scorer
    runs (None: `device.resolve_device`'s default); the prediction server
    sets it.
    """

    params: dict
    item_ids: BiMap
    user_windows: Dict[str, Tuple[str, ...]]
    session_vecs: Dict[str, np.ndarray]
    max_seq_len: int
    n_heads: int
    device: Optional[str] = None
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    def __getstate__(self) -> dict:
        state = dict(self.__dict__)
        state["_on_device"] = {}
        return state

    @property
    def n_items(self) -> int:
        return int(self.params["emb"].shape[0]) - 1

    def window_rows(self, items: Iterable[str]) -> List[int]:
        """Embedding rows of the known items of a window, order kept.
        Cold items (ids the last train never saw) are left out."""
        out = []
        for i in items:
            row = self.item_ids.get(str(i))
            if row is not None:
                out.append(int(row))
        return out

    def session_vec_of(self, items: Iterable[str]) -> np.ndarray:
        """Pooled session embedding of an item window: the mean of the
        known items' embedding rows (zeros when none is known)."""
        rows = self.window_rows(items)
        emb = np.asarray(self.params["emb"])
        if not rows:
            return np.zeros(emb.shape[1], dtype=emb.dtype)
        return emb[np.asarray(rows, np.int32)].mean(axis=0)

    def device_params(self, device: torch.device) -> dict:
        """The scorer's params on `device` (`ops.session.params_on`):
        made on the first call for that device and kept with the model
        (not pickled)."""
        from predictionio_torch.ops.session import params_on

        key = str(device)
        cached = self._on_device.get(key)
        if cached is None:
            cached = self._on_device[key] = params_on(self.params, device)
        return cached
