"""Complementary Purchase engine template (DASE components) — the port of
``predictionio_tpu/templates/complementarypurchase/engine.py``.

Parity with the upstream gallery template
«template-scala-parallel-complementarypurchase» [U]: users `buy` items;
purchases by one user within `basketWindow` seconds form a basket; the
algorithm mines pairwise association rules "bought i → also buys j" with
support/confidence/lift thresholds, and a query listing cart items
returns, per condition item, the top complementary items.

The Spark original self-joins basket RDDs to count itemset
co-occurrence; here the count is a Gram matrix of the 0/1 basket-item
incidence on the context's device (`ops/basket.py`), with a sparse host
fallback for catalogs past the dense budget.

Wire shapes (kept from the reference):
    query:  {"items": ["i1", "i2"], "num": 3}
    result: {"rules": [{"cond": ["i1"],
                        "itemScores": [{"item": "i9", "score": 1.8,
                                        "support": 0.02,
                                        "confidence": 0.41,
                                        "lift": 1.8}, ...]}, ...]}
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
from predictionio_torch.ops import basket as basket_ops
from predictionio_torch.templates.similarproduct.engine import store_of

log = logging.getLogger(__name__)

Query = dict
PredictedResult = dict


@dataclasses.dataclass
class DataSourceParams(Params):
    appName: str = ""
    buyEvents: list = dataclasses.field(default_factory=lambda: ["buy"])


@dataclasses.dataclass
class TrainingData(SanityCheck):
    """Columnar buy events with event times (basket windows need them)."""

    user_idx: np.ndarray  # [n] int32
    item_idx: np.ndarray  # [n] int32
    times: np.ndarray  # [n] float64 unix seconds
    user_ids: BiMap
    item_ids: BiMap

    def sanity_check(self):
        if not len(self.user_idx):
            raise ValueError(
                "TrainingData has no buy events; ingest buy events first.")


class DataSource(BaseDataSource):
    params_class = DataSourceParams

    def __init__(self, params: DataSourceParams):
        self.params = params

    def read_training(self, ctx: WorkflowContext) -> TrainingData:
        cols = store_of(ctx).find_columnar(
            app_name=self.params.appName,
            entity_type="user",
            target_entity_type="item",
            event_names=list(self.params.buyEvents),
            ordered=False,  # sessionize sorts by (user, time) itself
        )
        valid = cols.target_ids >= 0
        log.info("DataSource: %d buy events, app %r",
                 int(valid.sum()), self.params.appName)
        return TrainingData(
            user_idx=cols.entity_ids[valid],
            item_idx=cols.target_ids[valid],
            times=cols.times[valid],
            user_ids=cols.entity_bimap,
            item_ids=cols.target_bimap,
        )


@dataclasses.dataclass
class PreparedData:
    basket_idx: np.ndarray  # [n] int32
    item_idx: np.ndarray  # [n] int32
    n_baskets: int
    item_ids: BiMap


@dataclasses.dataclass
class PreparatorParams(Params):
    basketWindow: float = 3600.0  # seconds between purchases in one basket


class Preparator(BasePreparator):
    """Sessionize purchases into baskets («basketWindow» [U]) and compress
    item codes over purchased items."""

    params_class = PreparatorParams

    def __init__(self, params: Optional[PreparatorParams] = None):
        self.params = params or PreparatorParams()

    def prepare(self, ctx: WorkflowContext, td: TrainingData) -> PreparedData:
        i, item_ids = compress_codes(td.item_idx, td.item_ids)
        b, items, n_baskets = basket_ops.sessionize(
            td.user_idx, i, td.times, self.params.basketWindow)
        log.info("Preparator: %d baskets over %d purchases (%d items)",
                 n_baskets, len(items), len(item_ids))
        return PreparedData(basket_idx=b, item_idx=items,
                            n_baskets=n_baskets, item_ids=item_ids)


@dataclasses.dataclass
class CPModel:
    rules: basket_ops.BasketRules
    item_ids: BiMap

    def complements(self, cond_item: str, num: int) -> list[dict]:
        if not self.item_ids.contains(cond_item):
            return []
        row = self.rules.lookup(int(self.item_ids.to_index([cond_item])[0]))
        if row is None:
            return []
        out = []
        for k in range(self.rules.cons_items.shape[1]):
            j = int(self.rules.cons_items[row, k])
            if j < 0 or len(out) >= num:
                break
            out.append({
                "item": self.item_ids.from_index([j])[0],
                "score": float(self.rules.scores[row, k]),
                "support": float(self.rules.support[row, k]),
                "confidence": float(self.rules.confidence[row, k]),
                "lift": float(self.rules.lift[row, k]),
            })
        return out


@dataclasses.dataclass
class AssociationParams(Params):
    minSupport: float = 0.001
    minConfidence: float = 0.05
    minLift: float = 1.0
    numRulesPerCond: int = 10  # top-k consequents kept per condition item
    score: str = "lift"  # "lift" | "confidence" ranking
    maxDenseItems: int = 8192  # catalog bound for the on-device Gram
    maxBasketItems: int = 512  # distinct items kept per basket (bot guard)


class AssociationAlgorithm(Algorithm):
    """Pairwise rule mining over the basket incidence Gram (ops/basket),
    on the context's device."""

    params_class = AssociationParams

    def __init__(self, params: AssociationParams):
        self.params = params

    def train(self, ctx: WorkflowContext, pd: PreparedData) -> CPModel:
        # No checkpoint here, as in the reference: rule mining is one
        # counting pass with no iterative state to snapshot, so a crashed
        # train resumes by running again.
        p = self.params
        rules = basket_ops.mine_rules(
            pd.basket_idx, pd.item_idx, pd.n_baskets, len(pd.item_ids),
            min_support=p.minSupport, min_confidence=p.minConfidence,
            min_lift=p.minLift, top_k=p.numRulesPerCond, score=p.score,
            max_dense_items=p.maxDenseItems,
            max_basket_items=p.maxBasketItems, device=ctx.device)
        n_rules = int((rules.cons_items >= 0).sum())
        log.info("AssociationAlgorithm: %d rules over %d condition items "
                 "(%d baskets)", n_rules, len(rules.cond_items),
                 rules.n_baskets)
        ctx.metrics.emit("train/association", rules=n_rules,
                         cond_items=len(rules.cond_items),
                         baskets=rules.n_baskets)
        return CPModel(rules=rules, item_ids=pd.item_ids)

    def predict(self, model: CPModel, query: Query) -> PredictedResult:
        items = query.get("items") or []
        num = int(query.get("num", 10))
        rules = []
        for it in items:
            scores = model.complements(str(it), num)
            if scores:
                rules.append({"cond": [str(it)], "itemScores": scores})
        return {"rules": rules}


class ComplementaryPurchaseEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            data_source_class_map=DataSource,
            preparator_class_map=Preparator,
            algorithm_class_map={"association": AssociationAlgorithm},
            serving_class_map=FirstServing,
        )
