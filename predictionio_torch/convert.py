"""Carry trained weights into the port's models from plain arrays.

The reference's `ALSModel` holds numpy factors, two id→row maps and a CSR
of seen items; pull those out as numpy arrays and dicts and
`als_model_from_arrays` builds the port's `ALSModel` from them, so a model
the reference trained serves through the port unchanged. Its
`PopularityModel` (the Recommendation template's second algorithm, the
serving plane's degraded answer) holds item counts, their order and the
same maps and seen items: `popularity_model_from_arrays` carries it.
The Similar Product template's model (unit item factors, the item map,
the categories) and the E-Commerce template's (both factor matrices, the
unit item factors, both maps, the categories and the app name) carry over
through `similar_product_model_from_arrays` and `ecomm_model_from_arrays`;
the Product Ranking template's model is an `ALSModel`. The sessionrec
template's model (the attention params, the item map, the users' windows)
carries over through `session_model_from_arrays`.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from predictionio_torch.data.bimap import BiMap
from predictionio_torch.models.als_model import ALSModel, SeenItems
from predictionio_torch.models.session_model import SessionRecModel
from predictionio_torch.templates.ecommerce.engine import ECommModelData
from predictionio_torch.templates.recommendation.engine import PopularityModel
from predictionio_torch.templates.similarproduct.engine import (
    SimilarProductModel,
)


def als_model_from_arrays(
    user_factors: np.ndarray,
    item_factors: np.ndarray,
    user_ids: Mapping[str, int],
    item_ids: Mapping[str, int],
    seen_user_idx: Optional[np.ndarray] = None,
    seen_item_idx: Optional[np.ndarray] = None,
) -> ALSModel:
    """The port's ALSModel from [n_users, K] / [n_items, K] factors, the
    id string → row maps, and the (user row, item row) pairs of seen items
    (None: no seen-item exclusion)."""
    user_factors = np.asarray(user_factors)
    item_factors = np.asarray(item_factors)
    if len(user_ids) != user_factors.shape[0] or \
            len(item_ids) != item_factors.shape[0]:
        raise ValueError(
            f"id maps ({len(user_ids)} users, {len(item_ids)} items) do not "
            f"match the factors {user_factors.shape} / {item_factors.shape}")
    seen = None
    if seen_user_idx is not None:
        seen = SeenItems(np.asarray(seen_user_idx), np.asarray(seen_item_idx),
                         user_factors.shape[0])
    return ALSModel(
        user_factors=user_factors,
        item_factors=item_factors,
        user_ids=BiMap(dict(user_ids)),
        item_ids=BiMap(dict(item_ids)),
        seen=seen,
    )


def popularity_model_from_arrays(
    counts: np.ndarray,
    order: np.ndarray,
    user_ids: Mapping[str, int],
    item_ids: Mapping[str, int],
    seen_user_idx: np.ndarray,
    seen_item_idx: np.ndarray,
) -> PopularityModel:
    """The port's PopularityModel from the [n_items] popularity mass, the
    item rows in serving order, the id string → row maps, and the (user
    row, item row) pairs of seen items."""
    counts = np.asarray(counts, dtype=np.float32)
    order = np.asarray(order, dtype=np.int32)
    if len(item_ids) != counts.shape[0] or order.shape != counts.shape:
        raise ValueError(
            f"{len(item_ids)} items do not match counts {counts.shape} / "
            f"order {order.shape}")
    return PopularityModel(
        user_ids=BiMap(dict(user_ids)),
        item_ids=BiMap(dict(item_ids)),
        counts=counts,
        order=order,
        seen=SeenItems(np.asarray(seen_user_idx), np.asarray(seen_item_idx),
                       len(user_ids)),
    )


def similar_product_model_from_arrays(
    item_factors_unit: np.ndarray,
    item_ids: Mapping[str, int],
    item_categories: Mapping[str, list],
) -> SimilarProductModel:
    """The port's SimilarProductModel from the [n_items, K] L2-normalised
    item factors, the item id string → row map and item id → categories."""
    unit = np.asarray(item_factors_unit, dtype=np.float32)
    if unit.ndim != 2 or len(item_ids) != unit.shape[0]:
        raise ValueError(f"{len(item_ids)} items do not match the unit "
                         f"factors {unit.shape}")
    return SimilarProductModel(
        item_factors_unit=unit,
        item_ids=BiMap(dict(item_ids)),
        item_categories={k: list(v) for k, v in item_categories.items()},
    )


def ecomm_model_from_arrays(
    user_factors: np.ndarray,
    item_factors: np.ndarray,
    item_factors_unit: np.ndarray,
    user_ids: Mapping[str, int],
    item_ids: Mapping[str, int],
    item_categories: Mapping[str, list],
    app_name: str,
) -> ECommModelData:
    """The port's ECommModelData from the [n_users, K] / [n_items, K]
    factors, the [n_items, K] unit item factors, the id string → row maps,
    item id → categories and the app of the serve-time lookups."""
    user_factors = np.asarray(user_factors)
    item_factors = np.asarray(item_factors)
    unit = np.asarray(item_factors_unit, dtype=np.float32)
    if len(user_ids) != user_factors.shape[0] or \
            len(item_ids) != item_factors.shape[0] or \
            unit.shape != item_factors.shape:
        raise ValueError(
            f"id maps ({len(user_ids)} users, {len(item_ids)} items) do not "
            f"match the factors {user_factors.shape} / {item_factors.shape}"
            f" / unit {unit.shape}")
    return ECommModelData(
        user_factors=user_factors,
        item_factors=item_factors,
        item_factors_unit=unit,
        user_ids=BiMap(dict(user_ids)),
        item_ids=BiMap(dict(item_ids)),
        item_categories={k: list(v) for k, v in item_categories.items()},
        app_name=app_name,
    )


def session_model_from_arrays(
    params: Mapping,
    item_ids: Mapping[str, int],
    user_windows: Mapping[str, Sequence[str]],
    max_seq_len: int,
    n_heads: int,
) -> SessionRecModel:
    """The port's SessionRecModel from the attention params (emb [V+1, D],
    pos [Lpos, D], blocks of wq, wk, wv, wo, w1, b1, w2, b2; numpy
    arrays), the item id string → row map, user → window of item ids, the
    window length and the head count. `session_vecs` are recomputed by
    `session_vec_of`."""
    def host(a):
        return np.asarray(a, dtype=np.float32)

    emb = host(params["emb"])
    if emb.ndim != 2 or len(item_ids) != emb.shape[0] - 1:
        raise ValueError(f"{len(item_ids)} items do not match the embedding "
                         f"{emb.shape} (V + 1 rows, the last the pad row)")
    if emb.shape[1] % n_heads:
        raise ValueError(f"embedding width {emb.shape[1]} is not a multiple "
                         f"of {n_heads} heads")
    model = SessionRecModel(
        params={"emb": emb, "pos": host(params["pos"]),
                "blocks": [{k: host(v) for k, v in blk.items()}
                           for blk in params["blocks"]]},
        item_ids=BiMap(dict(item_ids)),
        user_windows={str(u): tuple(w) for u, w in user_windows.items()},
        session_vecs={},
        max_seq_len=int(max_seq_len),
        n_heads=int(n_heads),
    )
    model.session_vecs.update({u: model.session_vec_of(w)
                               for u, w in model.user_windows.items()})
    return model
