"""ALSModel — trained factor matrices + id mappings, with serving helpers:
the port of ``predictionio_tpu/models/als_model.py``.

Factors are numpy arrays on the host, so single queries score without
touching the device; bulk scoring goes through
`ops.ranking.recommend_topk`'s device branch on `device`. Models of the
grid evaluation hold their factors as tensors on the device instead
(`ops.als_grid.als_train_grid(host_factors=False)`), and so does a model
folded from one (`online.foldin.fold_model`): every read path scores them
where they lie. A model always pickles with host factors, so a model blob
loads on a machine without a card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from predictionio_torch.data.bimap import BiMap
from predictionio_torch.ops import ranking


class SeenItems:
    """CSR map of user row → seen item rows, with the dict-ish `.get`
    surface `recommend_products` uses."""

    def __init__(self, user_idx: np.ndarray, item_idx: np.ndarray,
                 n_users: int):
        order = np.argsort(user_idx, kind="stable")
        self._items = np.ascontiguousarray(
            np.asarray(item_idx)[order], dtype=np.int32)
        su = np.asarray(user_idx)[order]
        self._indptr = np.searchsorted(
            su, np.arange(n_users + 1)).astype(np.int64)

    def get(self, user_row: int, default=None) -> Optional[np.ndarray]:
        if not 0 <= user_row < len(self._indptr) - 1:
            return default
        lo, hi = self._indptr[user_row], self._indptr[user_row + 1]
        if hi <= lo:
            return default
        return self._items[lo:hi]

    def __len__(self) -> int:
        return int(self._items.shape[0])


@dataclasses.dataclass
class ALSModel:
    user_factors: ranking.Factors  # [n_users, K]
    item_factors: ranking.Factors  # [n_items, K]
    user_ids: BiMap  # user id string → row
    item_ids: BiMap  # item id string → row
    # user row → seen item rows (a SeenItems, or a fold's SeenOverlay)
    seen: Optional[SeenItems] = None
    rmse_history: list = dataclasses.field(default_factory=list)
    # where batches past ranking.SERVE_HOST_MAX_BATCH users score (None:
    # device.resolve_device's default); the prediction server sets it
    device: Optional[str] = None

    def __getstate__(self) -> dict:
        state = dict(self.__dict__)
        for name in ("user_factors", "item_factors"):
            if isinstance(state[name], torch.Tensor):
                state[name] = state[name].cpu().numpy()
        return state

    def recommend_products(
        self, user: str, num: int, exclude_seen: bool = True
    ) -> list[tuple[str, float]]:
        """Top-num (item id, score) for a user; unknown user → []."""
        return self.recommend_products_batch([user], num, exclude_seen)[0]

    def recommend_products_batch(
        self, users: list, num: int, exclude_seen: bool = True
    ) -> list[list[tuple[str, float]]]:
        """Top-num recommendations for many users in one scoring call;
        unknown users get []."""
        out: list[list[tuple[str, float]]] = [[] for _ in users]
        known = [(pos, row) for pos, row in
                 ((pos, self.user_ids.get(str(u))) for pos, u in
                  enumerate(users)) if row is not None]
        if not known or num <= 0:
            return out
        ids = np.asarray([row for _, row in known], dtype=np.int32)
        exclude = None
        if exclude_seen and self.seen:
            exclude = {int(row): self.seen.get(int(row),
                                               np.empty(0, np.int32))
                       for row in set(ids.tolist())}
        scores, idx = ranking.recommend_topk(
            self.user_factors, self.item_factors, ids, num, exclude,
            device=self.device)
        inv = self.item_ids.inverse()
        for (pos, _), s_row, i_row in zip(known, scores, idx):
            out[pos] = [(inv[int(i)], float(s))
                        for s, i in zip(s_row, i_row) if np.isfinite(s)]
        return out
