"""Top-k scoring + ranking metrics — the port of
``predictionio_tpu/ops/ranking.py``.

score = U Vᵀ with seen-item exclusion, then top-k. Batches of up to
`SERVE_HOST_MAX_BATCH` users with numpy factors score on the host, one
numpy gemv per user, so a user's scores do not depend on the batch it
arrived in (the serving contract: batched ≡ single, bitwise). Larger
batches, and every batch of factors that are already tensors (the grid
eval keeps its factors on the device), score on the device in chunks
sized so the [chunk, n_items] score tile stays near 1 GiB.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from predictionio_torch.device import DeviceLike, resolve_device

# batches up to this size score on the host (serving path); larger ones on
# the device (eval/bulk path)
SERVE_HOST_MAX_BATCH = 64

# numpy factors live on the host; tensor factors on their device
Factors = Union[np.ndarray, torch.Tensor]


def _exclusion_coo(ids, exclude):
    """Per-chunk COO exclusion indices: (ex_rows [E], ex_cols [E]) int32,
    one entry per seen item of each row in `ids`."""
    rows, cols = [], []
    for i, uid in enumerate(ids):
        ex = exclude.get(int(uid))
        if ex is not None and len(ex):
            cols.append(np.asarray(ex, dtype=np.int32))
            rows.append(np.full(len(ex), i, dtype=np.int32))
    if not rows:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    return np.concatenate(rows), np.concatenate(cols)


def topk_host(user_factors: np.ndarray, item_factors: np.ndarray,
              user_ids: np.ndarray, k: int,
              exclude: Optional[dict] = None) -> tuple[np.ndarray, np.ndarray]:
    """Host branch: per-row gemv (batch-size-invariant), in-place -inf
    masking, argpartition + sort. `k` ≤ n_items."""
    n_items = item_factors.shape[0]
    it_t = item_factors.T
    scores = np.empty((len(user_ids), n_items),
                      dtype=np.result_type(user_factors, item_factors))
    for i, uid in enumerate(user_ids):
        scores[i] = user_factors[uid] @ it_t
    if exclude:
        for i, uid in enumerate(user_ids):
            ex = exclude.get(int(uid))
            if ex is not None and len(ex):
                scores[i, ex] = -np.inf
    idx = np.argpartition(-scores, k - 1, axis=1)[:, :k]
    part = np.take_along_axis(scores, idx, axis=1)
    order = np.argsort(-part, axis=1)
    return (np.take_along_axis(part, order, axis=1).astype(np.float32),
            np.take_along_axis(idx, order, axis=1).astype(np.int32))


def topk_device(user_factors: Factors, item_factors: Factors,
                user_ids: np.ndarray, k: int,
                exclude: Optional[dict] = None,
                chunk: Optional[int] = None,
                device: DeviceLike = None) -> tuple[np.ndarray, np.ndarray]:
    """Device branch: per chunk of users, `mm` + `index_put_(-inf)` at
    the seen items + `torch.topk`. `k` ≤ n_items. Tensor factors score
    where they lie and are not copied; numpy factors go to `device`."""
    if isinstance(item_factors, torch.Tensor):
        dev = item_factors.device
    elif isinstance(user_factors, torch.Tensor):
        dev = user_factors.device
    else:
        dev = resolve_device(device)
    n_items = item_factors.shape[0]
    # ship the item table once, not per chunk
    item_dev = torch.as_tensor(item_factors, device=dev)
    user_dev = (user_factors.to(dev) if isinstance(user_factors, torch.Tensor)
                else None)
    if chunk is None:
        chunk = max(1, (1 << 28) // max(n_items, 1))
    chunk = min(chunk, len(user_ids))
    all_scores, all_idx = [], []
    for s in range(0, len(user_ids), chunk):
        ids = user_ids[s : s + chunk]
        if user_dev is None:
            u = torch.as_tensor(user_factors[ids], device=dev)
        else:
            u = user_dev.index_select(0, torch.as_tensor(
                ids, dtype=torch.int64, device=dev))
        scores = u @ item_dev.T
        if exclude:
            ex_rows, ex_cols = _exclusion_coo(ids, exclude)
            rows_t = torch.as_tensor(ex_rows, dtype=torch.int64, device=dev)
            cols_t = torch.as_tensor(ex_cols, dtype=torch.int64, device=dev)
            scores.index_put_((rows_t, cols_t),
                              torch.tensor(-np.inf, dtype=scores.dtype,
                                           device=dev))
        ts, ti = torch.topk(scores, k, dim=1)
        all_scores.append(ts.float().cpu().numpy())
        all_idx.append(ti.to(torch.int32).cpu().numpy())
    return np.concatenate(all_scores), np.concatenate(all_idx)


def recommend_topk(
    user_factors: Factors,
    item_factors: Factors,
    user_ids: np.ndarray,
    k: int,
    exclude: Optional[dict[int, np.ndarray]] = None,
    chunk: Optional[int] = None,
    device: DeviceLike = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Top-k items for each user id. `exclude` maps user id → item-id
    array to hide. Batches of ≤ SERVE_HOST_MAX_BATCH users with numpy
    factors score on the host; larger ones on `device`, and tensor
    factors always where they lie, never uploaded again (chunk: users per
    device chunk; None sizes a ~1 GiB score tile)."""
    n_items = item_factors.shape[0]
    k = min(k, n_items)
    if k <= 0 or len(user_ids) == 0:
        return (np.zeros((len(user_ids), 0), np.float32),
                np.zeros((len(user_ids), 0), np.int32))
    on_device = (isinstance(user_factors, torch.Tensor)
                 or isinstance(item_factors, torch.Tensor))
    if len(user_ids) <= SERVE_HOST_MAX_BATCH and not on_device:
        return topk_host(user_factors, item_factors, user_ids, k, exclude)
    return topk_device(user_factors, item_factors, user_ids, k, exclude,
                       chunk, device)


def average_precision_at_k(predicted, actual: set, k: int) -> float:
    """AP@k for one user; elements are compared as-is against `actual`."""
    if not actual:
        return 0.0
    hits = 0
    score = 0.0
    for i, p in enumerate(predicted[:k]):
        p = p.item() if isinstance(p, np.generic) else p
        if p in actual:
            hits += 1
            score += hits / (i + 1.0)
    return score / min(len(actual), k)


def map_at_k(
    user_factors: Factors,
    item_factors: Factors,
    test_user_items: dict[int, set],
    k: int = 10,
    exclude: Optional[dict[int, np.ndarray]] = None,
    device: DeviceLike = None,
) -> float:
    """Mean AP@k over users with test items."""
    user_ids = np.asarray(sorted(test_user_items), dtype=np.int32)
    if len(user_ids) == 0:
        return float("nan")
    _, top_idx = recommend_topk(user_factors, item_factors, user_ids, k,
                                exclude, device=device)
    aps = [
        average_precision_at_k(top_idx[i], test_user_items[int(uid)], k)
        for i, uid in enumerate(user_ids)
    ]
    return float(np.mean(aps))
