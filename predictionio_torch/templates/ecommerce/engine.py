"""E-Commerce Recommendation engine template (DASE components) — the port
of ``predictionio_tpu/templates/ecommerce/engine.py``.

Implicit ALS (`ops.als.als_train`, on the context's device) on view and
buy events, plus business rules applied at query time: exclude the items
the user has seen (`seenEvents`), exclude the items the latest `$set` on
the "constraint" entity `unavailableItems` names, optional category /
whiteList / blackList filters, and a cold-start path that scores through
the user's recent views when the model has no factor for the user.

The seen, recent and unavailable lookups go through `LEventStore` over the
process's storage (`Storage.get()`) on every query, behind a small TTL
cache (`_TTLCache`, `cacheTTLSeconds`).

Wire shapes (kept from the reference):
    query:  {"user": "u1", "num": 4, "categories": [...]?,
             "whiteList": [...]?, "blackList": [...]?}
    result: {"itemScores": [{"item": "i5", "score": 1.2}, ...]}
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Optional

import numpy as np

from predictionio_torch.controller import (
    Algorithm,
    DataSource as BaseDataSource,
    Engine,
    EngineFactory,
    FirstServing,
    Params,
    Preparator as BasePreparator,
    SanityCheck,
    WorkflowContext,
)
from predictionio_torch.data.bimap import BiMap, compress_codes
from predictionio_torch.data.store import LEventStore
from predictionio_torch.ops.als import ALSConfig, als_train
from predictionio_torch.storage.registry import Storage
from predictionio_torch.templates.similarproduct.engine import (
    item_categories_of,
    store_of,
    unit_rows,
)

log = logging.getLogger(__name__)

Query = dict
PredictedResult = dict


class _TTLCache:
    """Thread-safe TTL cache for the serve-time event lookups."""

    def __init__(self, ttl_seconds: float):
        self.ttl = ttl_seconds
        self._lock = threading.Lock()
        self._data: dict = {}

    def get(self, key, compute):
        now = time.monotonic()
        with self._lock:
            hit = self._data.get(key)
            if hit is not None and now - hit[0] < self.ttl:
                return hit[1]
        value = compute()
        with self._lock:
            self._data[key] = (now, value)
        return value


@dataclasses.dataclass
class DataSourceParams(Params):
    appName: str = ""
    eventNames: list = dataclasses.field(
        default_factory=lambda: ["view", "buy"]
    )


@dataclasses.dataclass
class TrainingData(SanityCheck):
    """Columnar view / buy events (integer-coded COO + the BiMaps), their
    weights, and each item's categories."""

    user_idx: np.ndarray  # [n] int32 codes into user_ids
    item_idx: np.ndarray  # [n] int32 codes into item_ids
    weights: np.ndarray  # [n] float32 — a buy counts more than a view
    user_ids: BiMap
    item_ids: BiMap
    item_categories: dict  # item id → [category]

    def sanity_check(self):
        if not len(self.user_idx):
            raise ValueError(
                "TrainingData has no view/buy events; ingest events first."
            )


class DataSource(BaseDataSource):
    params_class = DataSourceParams

    #: implicit confidence per event name (a buy is the stronger signal)
    EVENT_WEIGHTS = {"view": 1.0, "buy": 4.0}

    def __init__(self, params: DataSourceParams):
        self.params = params

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        store = store_of(ctx)
        cols = store.find_columnar(
            app_name=self.params.appName,
            entity_type="user",
            target_entity_type="item",
            event_names=list(self.params.eventNames),
            ordered=False,  # summed per-pair confidence is order-invariant
        )
        valid = cols.target_ids >= 0
        weight_of = np.asarray(
            [self.EVENT_WEIGHTS.get(name, 1.0) for name in cols.event_names],
            dtype=np.float32,
        )
        weights = (weight_of[cols.event_codes[valid]]
                   if len(cols.event_names)
                   else np.empty(0, np.float32))
        item_categories = item_categories_of(store, self.params.appName)
        log.info(
            "DataSource: %d view/buy events, %d items with properties, app %r",
            int(valid.sum()), len(item_categories), self.params.appName,
        )
        return TrainingData(
            user_idx=cols.entity_ids[valid],
            item_idx=cols.target_ids[valid],
            weights=weights,
            user_ids=cols.entity_bimap,
            item_ids=cols.target_bimap,
            item_categories=item_categories,
        )


@dataclasses.dataclass
class PreparedData:
    user_ids: BiMap
    item_ids: BiMap
    user_idx: np.ndarray  # [n] int32 (distinct pairs)
    item_idx: np.ndarray
    confidence: np.ndarray  # [n] float32 — the pair's summed weights
    item_categories: dict


class Preparator(BasePreparator):
    """Dense re-coding of the ids; a pair's repeated events sum into its
    confidence."""

    def prepare(self, ctx: WorkflowContext, td: TrainingData) -> PreparedData:
        u, user_ids = compress_codes(td.user_idx, td.user_ids)
        i, item_ids = compress_codes(td.item_idx, td.item_ids)
        n_items = max(len(item_ids), 1)
        pair = u.astype(np.int64) * n_items + i
        uniq, inverse = np.unique(pair, return_inverse=True)
        conf = np.zeros(len(uniq), dtype=np.float32)
        np.add.at(conf, inverse, td.weights)
        return PreparedData(
            user_ids=user_ids,
            item_ids=item_ids,
            user_idx=(uniq // n_items).astype(np.int32),
            item_idx=(uniq % n_items).astype(np.int32),
            confidence=conf,
            item_categories=td.item_categories,
        )


@dataclasses.dataclass
class ECommModelData:
    """The model blob: host factors, the id maps, the categories and the
    app the serve-time lookups read."""

    user_factors: np.ndarray  # [n_users, K]
    item_factors: np.ndarray  # [n_items, K]
    item_factors_unit: np.ndarray  # [n_items, K] — for the cold-start path
    user_ids: BiMap
    item_ids: BiMap
    item_categories: dict
    app_name: str


@dataclasses.dataclass
class ECommAlgorithmParams(Params):
    appName: str = ""  # the app of the serve-time LEventStore lookups
    rank: int = 10
    numIterations: int = 20
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: Optional[int] = None
    seenEvents: list = dataclasses.field(
        default_factory=lambda: ["view", "buy"]
    )
    similarEvents: list = dataclasses.field(default_factory=lambda: ["view"])
    unseenOnly: bool = True
    recentNum: int = 10  # cold start: score through this many recent views
    cacheTTLSeconds: float = 3.0

    _ALIASES = {"lambda": "lambda_"}


class ECommAlgorithm(Algorithm):
    """Implicit ALS on the context's device; the business rules live in
    `predict`, as in the reference. It has no `batch_predict` of its own:
    each query's lookups are its user's."""

    params_class = ECommAlgorithmParams
    checkpoint_tags = ("als",)

    def __init__(self, params: ECommAlgorithmParams):
        self.params = params
        self._cache = _TTLCache(params.cacheTTLSeconds)

    # -- train -------------------------------------------------------------
    def train(self, ctx: WorkflowContext, pd: PreparedData) -> ECommModelData:
        p = self.params
        cfg = ALSConfig(
            rank=p.rank,
            iterations=p.numIterations,
            reg=p.lambda_,
            implicit=True,
            alpha=p.alpha,
            seed=ctx.seed if p.seed is None else p.seed,
        )
        result = als_train(
            pd.user_idx, pd.item_idx, pd.confidence,
            n_users=len(pd.user_ids), n_items=len(pd.item_ids),
            cfg=cfg, device=ctx.device,
            bucket_cache_dir=ctx.algorithm_cache_dir("als"),
            checkpoint_dir=ctx.algorithm_checkpoint_dir("als"),
            checkpoint_every=ctx.checkpoint_every,
        )
        return ECommModelData(
            user_factors=result.user_factors,
            item_factors=result.item_factors,
            item_factors_unit=unit_rows(result.item_factors),
            user_ids=pd.user_ids,
            item_ids=pd.item_ids,
            item_categories=pd.item_categories,
            app_name=self.params.appName,
        )

    # -- serve-time lookups (cached) ---------------------------------------
    def _store(self) -> LEventStore:
        return LEventStore(Storage.get())

    def _unavailable_items(self, app_name: str) -> set:
        """The items of the latest `$set` on constraint/unavailableItems."""

        def compute():
            try:
                events = self._store().find_by_entity(
                    app_name=app_name,
                    entity_type="constraint",
                    entity_id="unavailableItems",
                    event_names=["$set"],
                    limit=1,
                    latest=True,
                )
            except Exception as e:  # storage down ≠ serving down
                log.warning("unavailableItems lookup failed: %s", e)
                return set()
            if not events:
                return set()
            return set(events[0].properties.get("items", []) or [])

        return self._cache.get(("unavailable", app_name), compute)

    def _seen_items(self, app_name: str, user: str) -> set:
        def compute():
            try:
                events = self._store().find_by_entity(
                    app_name=app_name,
                    entity_type="user",
                    entity_id=user,
                    event_names=list(self.params.seenEvents),
                    target_entity_type="item",
                )
            except Exception as e:
                log.warning("seen-items lookup failed: %s", e)
                return set()
            return {
                e.target_entity_id for e in events if e.target_entity_id
            }

        return self._cache.get(("seen", app_name, user), compute)

    def _recent_items(self, app_name: str, user: str) -> list:
        def compute():
            try:
                events = self._store().find_by_entity(
                    app_name=app_name,
                    entity_type="user",
                    entity_id=user,
                    event_names=list(self.params.similarEvents),
                    target_entity_type="item",
                    limit=self.params.recentNum,
                    latest=True,
                )
            except Exception as e:
                log.warning("recent-items lookup failed: %s", e)
                return []
            return [e.target_entity_id for e in events if e.target_entity_id]

        return self._cache.get(("recent", app_name, user), compute)

    # -- predict -----------------------------------------------------------
    def predict(self, model: ECommModelData, query: Query) -> PredictedResult:
        p = self.params
        app_name = model.app_name or p.appName
        user = str(query["user"])
        num = int(query.get("num", 10))

        if model.user_ids.contains(user):
            uvec = model.user_factors[int(model.user_ids[user])]
            scores = model.item_factors @ uvec
        else:
            # cold start: mean similarity to the recently viewed items
            recent = [
                i for i in self._recent_items(app_name, user)
                if model.item_ids.contains(i)
            ]
            if not recent:
                return {"itemScores": []}
            q = model.item_factors_unit[model.item_ids.to_index(recent)]
            scores = (q @ model.item_factors_unit.T).mean(axis=0)

        mask = np.ones(scores.shape[0], dtype=bool)
        if p.unseenOnly:
            seen = [
                i for i in self._seen_items(app_name, user)
                if model.item_ids.contains(i)
            ]
            if seen:
                mask[model.item_ids.to_index(seen)] = False
        unavailable = [
            i for i in self._unavailable_items(app_name)
            if model.item_ids.contains(i)
        ]
        if unavailable:
            mask[model.item_ids.to_index(unavailable)] = False
        white_list = query.get("whiteList")
        if white_list:
            wl = np.zeros_like(mask)
            have = [i for i in white_list if model.item_ids.contains(i)]
            if have:
                wl[model.item_ids.to_index(have)] = True
            mask &= wl
        black_list = query.get("blackList")
        if black_list:
            have = [i for i in black_list if model.item_ids.contains(i)]
            if have:
                mask[model.item_ids.to_index(have)] = False
        categories = query.get("categories")
        if categories:
            cats = set(categories)
            idxs = np.nonzero(mask)[0]
            for idx, item in zip(idxs, model.item_ids.from_index(idxs)):
                if not cats & set(model.item_categories.get(item, [])):
                    mask[idx] = False

        scores = np.where(mask, scores, -np.inf)
        k = min(num, int(mask.sum()))
        if k <= 0:
            return {"itemScores": []}
        top = np.argpartition(-scores, k - 1)[:k]
        top = top[np.argsort(-scores[top])]
        items = model.item_ids.from_index(top)
        return {
            "itemScores": [
                {"item": item, "score": float(scores[idx])}
                for item, idx in zip(items, top)
            ]
        }


class ECommerceEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            data_source_class_map=DataSource,
            preparator_class_map=Preparator,
            algorithm_class_map={"ecomm": ECommAlgorithm},
            serving_class_map=FirstServing,
        )
