"""Recommendation engine template (DASE components) — the port of
``predictionio_tpu/templates/recommendation/engine.py``: ALS trained by
`ops.als.als_train` on the context's device, blended with an
item-popularity baseline. `DataSource.read_eval` (k folds) and
`ALSAlgorithm.train_grid` (`ops.als_grid`) serve `evaluation.py`.

Wire shapes (kept from the reference):
    query:  {"user": "1", "num": 4}
    result: {"itemScores": [{"item": "i5", "score": 3.2}, ...]}
"""

from __future__ import annotations

import dataclasses
import logging
import math
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
    Serving,
    WorkflowContext,
)
from predictionio_torch.data.bimap import BiMap, compress_codes
from predictionio_torch.data.store import EventFileStore, PEventStore
from predictionio_torch.models.als_model import ALSModel, SeenItems
from predictionio_torch.ops.als import ALSConfig, als_train

log = logging.getLogger(__name__)

Query = dict  # {"user": str, "num": int}
PredictedResult = dict  # {"itemScores": [{"item": str, "score": float}]}


@dataclasses.dataclass
class DataSourceParams(Params):
    appName: str = ""
    eventNames: list = dataclasses.field(default_factory=lambda: ["rate", "buy"])
    buyRating: float = 4.0  # implicit rating assigned to "buy"
    evalK: int = 0  # >1 enables read_eval with k folds


@dataclasses.dataclass
class TrainingData(SanityCheck):
    """Columnar rating events: integer-coded COO + the BiMaps decoding
    the codes."""

    user_idx: np.ndarray  # [n] int32 codes into user_ids
    item_idx: np.ndarray  # [n] int32 codes into item_ids
    ratings: np.ndarray  # [n] float32, aligned
    user_ids: BiMap
    item_ids: BiMap

    def sanity_check(self):
        if len(self.ratings) == 0:
            raise ValueError("TrainingData has no rating events; ingest "
                             "events first.")


class DataSource(BaseDataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.params = params

    def _read_events(self, ctx: WorkflowContext) -> TrainingData:
        """Columnar read of rate/buy events, from the context's events
        file when it has one, else from the event store. Rows come in
        event-time order: the Preparator's re-rating dedup keeps the LAST
        occurrence, which must mean the latest event."""
        store = (EventFileStore(ctx.events_path) if ctx.events_path
                 else PEventStore(ctx.storage))
        cols = store.find_columnar(
            app_name=self.params.appName,
            entity_type="user",
            target_entity_type="item",
            event_names=list(self.params.eventNames),
            value_key="rating",
        )
        try:
            rate_code = cols.event_names.index("rate")
        except ValueError:
            rate_code = -1
        values = np.where(cols.event_codes == rate_code, cols.values,
                          np.float32(self.params.buyRating))
        valid = (cols.target_ids >= 0) & ~np.isnan(values)
        return TrainingData(
            user_idx=cols.entity_ids[valid],
            item_idx=cols.target_ids[valid],
            ratings=values[valid].astype(np.float32),
            user_ids=cols.entity_bimap,
            item_ids=cols.target_bimap,
        )

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        td = self._read_events(ctx)
        log.info("DataSource: %d rating events from app %r",
                 len(td.ratings), self.params.appName)
        return td

    def read_eval(self, ctx: WorkflowContext):
        """k folds by event index: fold i tests on every k-th event and
        trains on the rest. Each test user asks for its top 10; actual =
        that user's held-out items."""
        k = self.params.evalK
        if k <= 1:
            raise ValueError("DataSourceParams.evalK must be >= 2 for "
                             "evaluation")
        td = self._read_events(ctx)
        assign = np.arange(len(td.ratings)) % k
        folds = []
        for fold in range(k):
            train_sel = assign != fold
            fold_td = TrainingData(
                user_idx=td.user_idx[train_sel],
                item_idx=td.item_idx[train_sel],
                ratings=td.ratings[train_sel],
                user_ids=td.user_ids,
                item_ids=td.item_ids,
            )
            test_users = td.user_ids.from_index(td.user_idx[~train_sel])
            test_items = td.item_ids.from_index(td.item_idx[~train_sel])
            actual_by_user: dict[str, set] = {}
            for u, i in zip(test_users, test_items):
                actual_by_user.setdefault(u, set()).add(i)
            qa = [({"user": u, "num": 10}, {"items": sorted(items)})
                  for u, items in sorted(actual_by_user.items())]
            folds.append((fold_td, qa))
        return folds


@dataclasses.dataclass
class PreparedData:
    user_ids: BiMap
    item_ids: BiMap
    user_idx: np.ndarray  # [n] int32
    item_idx: np.ndarray
    ratings: np.ndarray  # [n] float32


class Preparator(BasePreparator):
    """Dense re-coding of the ids; duplicate (user, item) pairs keep the
    last value (re-rating overwrites)."""

    def prepare(self, ctx: WorkflowContext, td: TrainingData) -> PreparedData:
        u, user_ids = compress_codes(td.user_idx, td.user_ids)
        i, item_ids = compress_codes(td.item_idx, td.item_ids)
        pair = u.astype(np.int64) * max(len(item_ids), 1) + i
        _, last_pos = np.unique(pair[::-1], return_index=True)
        keep = len(pair) - 1 - last_pos
        keep.sort()
        return PreparedData(
            user_ids=user_ids,
            item_ids=item_ids,
            user_idx=u[keep],
            item_idx=i[keep],
            ratings=td.ratings[keep],
        )


@dataclasses.dataclass
class ALSAlgorithmParams(Params):
    rank: int = 10
    numIterations: int = 10
    lambda_: float = 0.01  # engine.json key "lambda" (see _ALIASES)
    implicitPrefs: bool = False
    alpha: float = 1.0
    seed: Optional[int] = None
    computeRMSE: bool = False
    # hot rows with more ratings than this train as summed segments; 0
    # disables
    splitCap: int = 32768

    _ALIASES = {"lambda": "lambda_"}


class ALSAlgorithm(Algorithm):
    """ALS on the context's device; the model keeps factors + bimaps +
    seen items for serve-time exclusion."""

    params_class = ALSAlgorithmParams
    checkpoint_tags = ("als",)

    def __init__(self, params: ALSAlgorithmParams):
        self.params = params

    def train(self, ctx: WorkflowContext, pd: PreparedData) -> ALSModel:
        p = self.params
        result = als_train(
            pd.user_idx, pd.item_idx, pd.ratings,
            n_users=len(pd.user_ids), n_items=len(pd.item_ids),
            cfg=self._als_config(ctx), device=ctx.device,
            compute_rmse=p.computeRMSE,
            checkpoint_dir=ctx.algorithm_checkpoint_dir("als"),
            checkpoint_every=ctx.checkpoint_every,
            bucket_cache_dir=ctx.algorithm_cache_dir("als"),
        )
        # epoch_times covers the epochs run in this call (a resumed run
        # skips its first start_epoch); rmse_history covers them all
        for off, t in enumerate(result.epoch_times):
            step = result.start_epoch + off + 1
            rec = {"epoch_time_s": t}
            if result.rmse_history and step <= len(result.rmse_history):
                rmse = result.rmse_history[step - 1]
                if not math.isnan(rmse):  # NaN: an epoch without RMSE
                    rec["rmse"] = rmse
            ctx.metrics.emit("train/als", step=step, **rec)
        return ALSModel(
            user_factors=result.user_factors,
            item_factors=result.item_factors,
            user_ids=pd.user_ids,
            item_ids=pd.item_ids,
            seen=SeenItems(pd.user_idx, pd.item_idx, len(pd.user_ids)),
            rmse_history=result.rmse_history,
            device=str(ctx.device),
        )

    def _als_config(self, ctx: WorkflowContext) -> ALSConfig:
        p = self.params
        return ALSConfig(
            rank=p.rank,
            iterations=p.numIterations,
            reg=p.lambda_,
            implicit=p.implicitPrefs,
            alpha=p.alpha,
            seed=ctx.seed if p.seed is None else p.seed,
            split_cap=p.splitCap,
        )

    @classmethod
    def train_grid(cls, ctx: WorkflowContext, pd: PreparedData,
                   algos) -> Optional[list[ALSModel]]:
        """The eval grid's cells, trained together (`ops/als_grid.py`):
        cells that differ only in (λ, α, seed, iterations) share one
        batched train; the stock rank × λ grid becomes one per rank, and
        singleton cells take the ordinary `train`. The models keep their
        factors on `ctx.device` (host_factors=False): the evaluation
        scores them there, and they are never written to a model file."""
        from predictionio_torch.ops.als_grid import grid_dispatch

        cfgs = [a._als_config(ctx) for a in algos]
        # built on first use: no O(n_events) pass when every cell falls
        # back to sequential trains
        seen_box: list[SeenItems] = []

        def build_model(i, r):
            if not seen_box:
                seen_box.append(
                    SeenItems(pd.user_idx, pd.item_idx, len(pd.user_ids)))
            return ALSModel(
                user_factors=r.user_factors,
                item_factors=r.item_factors,
                user_ids=pd.user_ids,
                item_ids=pd.item_ids,
                seen=seen_box[0],
                # a computeRMSE=False cell comes out empty, as its
                # sequential train would
                rmse_history=(r.rmse_history
                              if algos[i].params.computeRMSE else []),
                device=str(ctx.device),
            )

        return grid_dispatch(
            ctx, cfgs, pd.user_idx, pd.item_idx, pd.ratings,
            n_users=len(pd.user_ids), n_items=len(pd.item_ids),
            train_one=lambda i: algos[i].train(ctx, pd),
            build_model=build_model,
            log_prefix="ALSAlgorithm.train_grid",
            rmse_flags=[a.params.computeRMSE for a in algos],
            host_factors=False,
            cache_dir=ctx.algorithm_cache_dir("als"),
        )

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        num = int(query.get("num", 10))
        recs = model.recommend_products(str(query["user"]), num)
        return {"itemScores": [{"item": i, "score": s} for i, s in recs]}

    def batch_predict(self, model: ALSModel, queries) -> list[PredictedResult]:
        """One vectorized top-k per distinct `num` over every query's
        user; batches past ranking.SERVE_HOST_MAX_BATCH score on the
        model's device."""
        by_num: dict[int, list[int]] = {}
        for pos, q in enumerate(queries):
            by_num.setdefault(int(q.get("num", 10)), []).append(pos)
        out: list[PredictedResult] = [None] * len(queries)  # type: ignore
        for num, idxs in by_num.items():
            recs = model.recommend_products_batch(
                [queries[i]["user"] for i in idxs], num)
            for i, r in zip(idxs, recs):
                out[i] = {"itemScores": [{"item": item, "score": s}
                                         for item, s in r]}
        return out


@dataclasses.dataclass
class PopularityParams(Params):
    weightByRating: bool = False  # sum rating mass instead of counting


@dataclasses.dataclass
class PopularityModel:
    """Global item-popularity ranks with per-user seen-item exclusion."""

    user_ids: BiMap
    item_ids: BiMap
    counts: np.ndarray  # [n_items] float32 popularity mass
    order: np.ndarray  # [n_items] int32, counts descending
    seen: SeenItems

    def recommend(self, user: str, num: int) -> list[tuple[str, float]]:
        if num <= 0:
            return []
        seen_rows: frozenset = frozenset()
        row = self.user_ids.get(str(user))
        if row is not None:
            s = self.seen.get(int(row))
            if s is not None:
                seen_rows = frozenset(int(x) for x in s)
        inv = self.item_ids.inverse()
        out: list[tuple[str, float]] = []
        for i in self.order:
            i = int(i)
            if i in seen_rows:
                continue
            out.append((inv[i], float(self.counts[i])))
            if len(out) >= num:
                break
        return out


class PopularityAlgorithm(Algorithm):
    """Item-popularity baseline: non-personalized global ranks, the
    cold-start backstop in the served blend."""

    params_class = PopularityParams
    # no per-user device work and O(num) serve cost: this is the serving
    # plane's degraded-mode answer when admission sheds under saturation
    degraded_capable = True

    def __init__(self, params: PopularityParams):
        self.params = params

    def train(self, ctx: WorkflowContext, pd: PreparedData) -> PopularityModel:
        n_items = len(pd.item_ids)
        weights = (pd.ratings.astype(np.float32)
                   if self.params.weightByRating
                   else np.ones(len(pd.item_idx), dtype=np.float32))
        counts = np.zeros(n_items, dtype=np.float32)
        np.add.at(counts, pd.item_idx, weights)
        order = np.argsort(-counts, kind="stable").astype(np.int32)
        return PopularityModel(
            user_ids=pd.user_ids,
            item_ids=pd.item_ids,
            counts=counts,
            order=order,
            seen=SeenItems(pd.user_idx, pd.item_idx, len(pd.user_ids)),
        )

    def predict(self, model: PopularityModel, query: Query) -> PredictedResult:
        num = int(query.get("num", 10))
        return {"itemScores": [{"item": i, "score": s}
                               for i, s in model.recommend(
                                   str(query["user"]), num)]}


@dataclasses.dataclass
class WeightedServingParams(Params):
    weights: list = dataclasses.field(default_factory=list)  # per algo; [] = equal


class WeightedServing(Serving):
    """Blend every algorithm's ranked list: min-max normalise each
    prediction's scores to [0, 1], weight-sum per item, re-rank."""

    params_class = WeightedServingParams

    def __init__(self, params: WeightedServingParams):
        self.params = params

    def check_against_algorithms(self, algo_names: list) -> None:
        if self.params.weights and len(self.params.weights) != len(algo_names):
            raise ValueError(
                f"WeightedServing: {len(self.params.weights)} weights "
                f"configured for {len(algo_names)} algorithms "
                f"({algo_names}); fix serving.params.weights in "
                "engine.json")

    def serve(self, query, predictions):
        if not predictions:
            raise ValueError("No predictions to serve.")
        num = int(query.get("num", 10))
        weights = list(self.params.weights) or [1.0] * len(predictions)
        if len(weights) != len(predictions):
            raise ValueError(
                f"WeightedServing: {len(weights)} weights for "
                f"{len(predictions)} algorithm predictions")
        blended: dict[str, float] = {}
        for w, pred in zip(weights, predictions):
            scores = pred.get("itemScores") or []
            if not scores:
                continue
            vals = [float(s["score"]) for s in scores]
            lo, hi = min(vals), max(vals)
            span = hi - lo
            for s, v in zip(scores, vals):
                norm = (v - lo) / span if span > 0 else 1.0
                blended[s["item"]] = blended.get(s["item"], 0.0) + w * norm
        ranked = sorted(blended.items(), key=lambda kv: (-kv[1], kv[0]))
        return {"itemScores": [{"item": i, "score": s}
                               for i, s in ranked[:num]]}


class RecommendationEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            data_source_class_map=DataSource,
            preparator_class_map=Preparator,
            algorithm_class_map={"als": ALSAlgorithm,
                                 "popular": PopularityAlgorithm},
            serving_class_map={
                "": FirstServing,
                "first": FirstServing,
                "weighted": WeightedServing,
            },
        )
