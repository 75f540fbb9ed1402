"""Product Ranking engine template (DASE components) — the port of
``predictionio_tpu/templates/productranking/engine.py``.

Ranks a GIVEN list of items for a user (re-order a landing page or a
search result) by the user's predicted preference. The Recommendation
template's data path and ALS train are reused whole; only serving
differs: the query names the candidates, each score is one host dot
product, and when the model cannot rank (an unknown user) the original
order comes back with `"isOriginal": true`. An item unknown to the model
is ranked at score 0.

Wire shapes (kept from the reference):
    query:  {"user": "u1", "items": ["i3", "i1", "i9"]}
    result: {"itemScores": [{"item": "i1", "score": 3.2}, ...],
             "isOriginal": false}
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from predictionio_torch.controller import Engine, EngineFactory, FirstServing
from predictionio_torch.models.als_model import ALSModel
from predictionio_torch.templates.recommendation.engine import (
    ALSAlgorithm as _RecommendationALS,
    DataSource,
    DataSourceParams,
    Preparator,
    PreparedData,
    TrainingData,
)

Query = dict
PredictedResult = dict


class RankingALSAlgorithm(_RecommendationALS):
    """The Recommendation template's ALS train + ranking's serving."""

    @staticmethod
    def _rank(model: ALSModel, uvec: np.ndarray, items: list) -> list:
        # an unknown item enters the ranking at score 0 rather than after
        # the known ones: an explicit model can score a disliked item
        # below 0, and the answer stays score-descending (ties keep the
        # incoming order)
        scored = []
        for pos, item in enumerate(items):
            row = model.item_ids.get(item)
            score = (0.0 if row is None
                     else float(uvec @ model.item_factors[int(row)]))
            scored.append((score, pos, item))
        scored.sort(key=lambda t: (-t[0], t[1]))
        return [{"item": item, "score": s} for s, _, item in scored]

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        items = [str(i) for i in (query.get("items") or [])]
        user = str(query.get("user", ""))
        urow = model.user_ids.get(user)
        if urow is None or not items:
            return {"itemScores": [{"item": i, "score": 0.0}
                                   for i in items],
                    "isOriginal": True}
        return {"itemScores": self._rank(model, model.user_factors[int(urow)],
                                         items),
                "isOriginal": False}

    def batch_predict(self, model: ALSModel, queries) -> list[PredictedResult]:
        """The serving micro-batcher's path (the Recommendation template's
        user-grouped top-k answers another query shape). Each query is
        scored by the same `_rank`, so batched answers equal sequential
        ones bit for bit; a batch looks each user's factor row up once."""
        uvecs: dict[str, Optional[np.ndarray]] = {}
        out = []
        for q in queries:
            items = [str(i) for i in (q.get("items") or [])]
            user = str(q.get("user", ""))
            if user not in uvecs:
                urow = model.user_ids.get(user)
                uvecs[user] = (None if urow is None
                               else model.user_factors[int(urow)])
            uvec = uvecs[user]
            if uvec is None or not items:
                out.append({"itemScores": [{"item": i, "score": 0.0}
                                           for i in items],
                            "isOriginal": True})
            else:
                out.append({"itemScores": self._rank(model, uvec, items),
                            "isOriginal": False})
        return out


class ProductRankingEngine(EngineFactory):
    def apply(self) -> Engine:
        return Engine(
            data_source_class_map=DataSource,
            preparator_class_map=Preparator,
            algorithm_class_map={"als": RankingALSAlgorithm},
            serving_class_map=FirstServing,
        )


__all__ = [
    "ProductRankingEngine",
    "RankingALSAlgorithm",
    "DataSource",
    "DataSourceParams",
    "Preparator",
    "PreparedData",
    "TrainingData",
    "Query",
]
