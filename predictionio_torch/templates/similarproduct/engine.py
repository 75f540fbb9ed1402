"""Similar Product engine template (DASE components) — the port of
``predictionio_tpu/templates/similarproduct/engine.py``.

Users `view` items and `$set` item entities carry `categories`. Implicit
ALS (`ops.als.als_train`, on the context's device) trains on the per-pair
view counts; the item factors, L2-normalised on the host, make a
cosine-similarity model. Queries name a basket of items and get back the
most similar other items, with whiteList / blackList / categories
filters. `DataSource.read_eval` (pair-level k folds) and
`ALSAlgorithm.train_grid` (`ops.als_grid`) serve `evaluation.py`.

Wire shapes (kept from the reference):
    query:  {"items": ["i1"], "num": 4,
             "categories": [...]?, "whiteList": [...]?, "blackList": [...]?}
    result: {"itemScores": [{"item": "i5", "score": 0.93}, ...]}
"""

from __future__ import annotations

import dataclasses
import logging
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
from predictionio_torch.data.store import PEventStore
from predictionio_torch.ops.als import ALSConfig, als_train

log = logging.getLogger(__name__)

Query = dict
PredictedResult = dict


def store_of(ctx: WorkflowContext) -> PEventStore:
    """The context's event store. The templates that read properties
    (item or user `$set`s, a view's session fields), which an events file
    does not carry, refuse a context that names one."""
    if ctx.events_path:
        raise ValueError("this template reads the event store (entity and "
                         "event properties included); train it from an "
                         "app, not an events file")
    return PEventStore(ctx.storage)


def item_categories_of(store: PEventStore, app_name: str) -> dict:
    """Item id → its `categories` property, from the `$set`-folded item
    entities."""
    item_props = store.aggregate_properties(app_name=app_name,
                                            entity_type="item")
    return {eid: list(p.get("categories", []) or [])
            for eid, p in item_props.items()}


def unit_rows(f: np.ndarray) -> np.ndarray:
    """Rows of `f` scaled to unit L2 norm (all-zero rows stay zero), f32."""
    norms = np.linalg.norm(f, axis=1, keepdims=True)
    unit = np.where(norms > 0, f / np.maximum(norms, 1e-12), 0.0)
    return unit.astype(np.float32)


@dataclasses.dataclass
class DataSourceParams(Params):
    appName: str = ""
    similarEvents: list = dataclasses.field(default_factory=lambda: ["view"])
    evalK: int = 0  # >1 enables read_eval with k folds


@dataclasses.dataclass
class TrainingData(SanityCheck):
    """Columnar view events (integer-coded COO + the BiMaps decoding the
    codes) and each item's categories."""

    user_idx: np.ndarray  # [n] int32 codes into user_ids
    item_idx: np.ndarray  # [n] int32 codes into item_ids
    user_ids: BiMap
    item_ids: BiMap
    item_categories: dict  # item id string → list of category strings

    def sanity_check(self):
        if not len(self.user_idx):
            raise ValueError(
                "TrainingData has no view events; ingest view events first."
            )


class DataSource(BaseDataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.params = params

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        store = store_of(ctx)
        cols = store.find_columnar(
            app_name=self.params.appName,
            entity_type="user",
            target_entity_type="item",
            event_names=list(self.params.similarEvents),
            ordered=False,  # per-pair counts are order-invariant
        )
        valid = cols.target_ids >= 0
        item_categories = item_categories_of(store, self.params.appName)
        log.info(
            "DataSource: %d view events, %d items with properties, app %r",
            int(valid.sum()), len(item_categories), self.params.appName,
        )
        return TrainingData(
            user_idx=cols.entity_ids[valid],
            item_idx=cols.target_ids[valid],
            user_ids=cols.entity_bimap,
            item_ids=cols.target_bimap,
            item_categories=item_categories,
        )

    def read_eval(self, ctx: WorkflowContext):
        """k folds over distinct (user, item) PAIRS, not raw events: a
        pair with repeat views on both sides of the split would score a
        memorised pair as a hit. Per fold, each held-out pair (u, Y) whose
        user keeps a training pair with another item X becomes the query
        {"items": [X], "num": 10} with actual {"items": [Y]}; X is the
        user's first kept item. The folds are the reference's exactly."""
        k = self.params.evalK
        if k <= 1:
            raise ValueError("DataSourceParams.evalK must be >= 2 for "
                             "evaluation")
        td = self.read_training(ctx)
        n_items = max(len(td.item_ids), 1)
        pair = td.user_idx.astype(np.int64) * n_items + td.item_idx
        uniq = np.unique(pair)  # sorted → pu is sorted too
        pu = (uniq // n_items).astype(np.int32)
        pi = (uniq % n_items).astype(np.int32)
        rank_in_user = np.arange(len(uniq)) - np.searchsorted(pu, pu)
        assign = rank_in_user % k
        ev_pair_pos = np.searchsorted(uniq, pair)  # event → its pair row
        inv_items = td.item_ids.inverse()
        folds = []
        for fold in range(k):
            tr = assign != fold
            # every raw event of a kept pair: repeats are the confidence
            keep_ev = tr[ev_pair_pos]
            fold_td = TrainingData(
                user_idx=td.user_idx[keep_ev], item_idx=td.item_idx[keep_ev],
                user_ids=td.user_ids, item_ids=td.item_ids,
                item_categories=td.item_categories)
            # pairs are distinct per user, so a kept anchor never equals
            # a held-out item
            tr_u, tr_i = pu[tr], pi[tr]
            users_with, first = np.unique(tr_u, return_index=True)
            anchor1 = dict(zip(users_with.tolist(), tr_i[first].tolist()))
            qa = []
            for u, i in zip(pu[~tr].tolist(), pi[~tr].tolist()):
                anchor = anchor1.get(u)
                if anchor is None:
                    continue
                qa.append((
                    {"items": [inv_items[anchor]], "num": 10},
                    {"items": [inv_items[i]]},
                ))
            folds.append((fold_td, qa))
        return folds


@dataclasses.dataclass
class PreparedData:
    user_ids: BiMap
    item_ids: BiMap
    user_idx: np.ndarray  # [n] int32
    item_idx: np.ndarray
    counts: np.ndarray  # [n] float32 — view counts per (user, item)
    item_categories: dict


class Preparator(BasePreparator):
    """Dense re-coding of the ids; repeat views become per-pair counts
    (the implicit confidence)."""

    def prepare(self, ctx: WorkflowContext, td: TrainingData) -> PreparedData:
        # items seen only through $set get no factor row: they can never
        # score anyway
        u, user_ids = compress_codes(td.user_idx, td.user_ids)
        i, item_ids = compress_codes(td.item_idx, td.item_ids)
        n_items = max(len(item_ids), 1)
        pair = u.astype(np.int64) * n_items + i
        uniq, counts = np.unique(pair, return_counts=True)
        return PreparedData(
            user_ids=user_ids,
            item_ids=item_ids,
            user_idx=(uniq // n_items).astype(np.int32),
            item_idx=(uniq % n_items).astype(np.int32),
            counts=counts.astype(np.float32),
            item_categories=td.item_categories,
        )


@dataclasses.dataclass
class SimilarProductModel:
    """L2-normalised item factors + the id and category maps; a query's
    scores are one [Q, K] @ [K, N] product on the host."""

    item_factors_unit: np.ndarray  # [n_items, K], rows L2-normalised
    item_ids: BiMap
    item_categories: dict

    def similar(
        self,
        query_items: list,
        num: int,
        categories: Optional[list] = None,
        white_list: Optional[list] = None,
        black_list: Optional[list] = None,
    ) -> list[tuple[str, float]]:
        known = [i for i in query_items if self.item_ids.contains(i)]
        if not known:
            return []
        q = self.item_factors_unit[self.item_ids.to_index(known)]  # [Q, K]
        scores = (q @ self.item_factors_unit.T).mean(axis=0)  # [n_items]

        mask = np.ones(scores.shape[0], dtype=bool)
        mask[self.item_ids.to_index(known)] = False  # the basket itself
        if white_list:
            wl = np.zeros_like(mask)
            have = [i for i in white_list if self.item_ids.contains(i)]
            if have:
                wl[self.item_ids.to_index(have)] = True
            mask &= wl
        if black_list:
            have = [i for i in black_list if self.item_ids.contains(i)]
            if have:
                mask[self.item_ids.to_index(have)] = False
        if categories:
            cats = set(categories)
            idxs = np.nonzero(mask)[0]
            for idx, item in zip(idxs, self.item_ids.from_index(idxs)):
                if not cats & set(self.item_categories.get(item, [])):
                    mask[idx] = False

        scores = np.where(mask, scores, -np.inf)
        k = min(num, int(mask.sum()))
        if k <= 0:
            return []
        top = np.argpartition(-scores, k - 1)[:k]
        top = top[np.argsort(-scores[top])]
        items = self.item_ids.from_index(top)
        return [(item, float(scores[idx])) for item, idx in zip(items, top)]


@dataclasses.dataclass
class ALSAlgorithmParams(Params):
    rank: int = 10
    numIterations: int = 20
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: Optional[int] = None

    _ALIASES = {"lambda": "lambda_"}


class ALSAlgorithm(Algorithm):
    """Implicit ALS on the context's device → the cosine item-item
    model."""

    params_class = ALSAlgorithmParams
    checkpoint_tags = ("als",)

    def __init__(self, params: ALSAlgorithmParams):
        self.params = params

    def _als_config(self, ctx: WorkflowContext) -> ALSConfig:
        p = self.params
        return ALSConfig(
            rank=p.rank,
            iterations=p.numIterations,
            reg=p.lambda_,
            implicit=True,
            alpha=p.alpha,
            seed=ctx.seed if p.seed is None else p.seed,
        )

    @staticmethod
    def _model_from_item_factors(f: np.ndarray,
                                 pd: PreparedData) -> SimilarProductModel:
        return SimilarProductModel(
            item_factors_unit=unit_rows(f),
            item_ids=pd.item_ids,
            item_categories=pd.item_categories,
        )

    def train(self, ctx: WorkflowContext,
              pd: PreparedData) -> SimilarProductModel:
        result = als_train(
            pd.user_idx, pd.item_idx, pd.counts,
            n_users=len(pd.user_ids), n_items=len(pd.item_ids),
            cfg=self._als_config(ctx), device=ctx.device,
            bucket_cache_dir=ctx.algorithm_cache_dir("als"),
            checkpoint_dir=ctx.algorithm_checkpoint_dir("als"),
            checkpoint_every=ctx.checkpoint_every,
        )
        return self._model_from_item_factors(result.item_factors, pd)

    @classmethod
    def train_grid(cls, ctx: WorkflowContext, pd: PreparedData,
                   algos) -> Optional[list]:
        """The eval grid's cells trained together (`ops/als_grid.py`):
        cells that differ only in (λ, α, seed, iterations) share one
        batched train, singleton cells take the ordinary `train`. The
        factors come back to the host (host_factors, the default): the
        model normalises them with numpy."""
        from predictionio_torch.ops.als_grid import grid_dispatch

        return grid_dispatch(
            ctx, [a._als_config(ctx) for a in algos],
            pd.user_idx, pd.item_idx, pd.counts,
            n_users=len(pd.user_ids), n_items=len(pd.item_ids),
            train_one=lambda i: algos[i].train(ctx, pd),
            build_model=lambda i, r: cls._model_from_item_factors(
                r.item_factors, pd),
            log_prefix="SimilarProduct train_grid",
            cache_dir=ctx.algorithm_cache_dir("als"),
        )

    def predict(self, model: SimilarProductModel,
                query: Query) -> PredictedResult:
        sims = model.similar(
            [str(i) for i in query.get("items", [])],
            num=int(query.get("num", 10)),
            categories=query.get("categories"),
            white_list=query.get("whiteList"),
            black_list=query.get("blackList"),
        )
        return {"itemScores": [{"item": i, "score": s} for i, s in sims]}

    def batch_predict(self, model: SimilarProductModel,
                      queries) -> list[PredictedResult]:
        """Filterless queries of one `num` share one mask / top-k pass over
        a stacked [B, n_items] score matrix; a query with a filter or no
        known item takes `predict`. Each score row is the expression
        `similar()` computes, and argpartition / argsort along axis 1
        match their 1-D forms row for row, so batched answers equal
        sequential ones bit for bit."""
        unit = model.item_factors_unit
        n_items = unit.shape[0]
        out: list[PredictedResult] = [None] * len(queries)  # type: ignore
        groups: dict[int, list[tuple[int, np.ndarray]]] = {}
        for pos, q in enumerate(queries):
            known = [str(i) for i in (q.get("items") or [])
                     if model.item_ids.contains(str(i))]
            num = int(q.get("num", 10))
            if (not known or num <= 0 or q.get("categories")
                    or q.get("whiteList") or q.get("blackList")):
                out[pos] = self.predict(model, q)
                continue
            groups.setdefault(num, []).append(
                (pos, model.item_ids.to_index(known)))
        for num, entries in groups.items():
            scores = np.empty((len(entries), n_items), dtype=unit.dtype)
            mask = np.ones((len(entries), n_items), dtype=bool)
            for r, (_, ki) in enumerate(entries):
                scores[r] = (unit[ki] @ unit.T).mean(axis=0)
                mask[r, ki] = False
            # a row with fewer candidates than num (a basket about the
            # catalogue's size) takes predict, so the rest share one k
            avail = mask.sum(axis=1)
            k = min(num, n_items)
            live = []
            for r, (pos, _) in enumerate(entries):
                if avail[r] < k:
                    out[pos] = self.predict(model, queries[pos])
                else:
                    live.append(r)
            if not live:
                continue
            s = np.where(mask[live], scores[live], -np.inf)
            idx = np.argpartition(-s, k - 1, axis=1)[:, :k]
            part = np.take_along_axis(s, idx, axis=1)
            order = np.argsort(-part, axis=1)
            top = np.take_along_axis(idx, order, axis=1)
            top_scores = np.take_along_axis(part, order, axis=1)
            names = model.item_ids.from_index(top.ravel())
            for j, r in enumerate(live):
                pos = entries[r][0]
                base = j * k
                out[pos] = {"itemScores": [
                    {"item": names[base + c], "score": float(top_scores[j, c])}
                    for c in range(k)]}
        return out


class SimilarProductEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            data_source_class_map=DataSource,
            preparator_class_map=Preparator,
            algorithm_class_map={"als": ALSAlgorithm},
            serving_class_map=FirstServing,
        )
