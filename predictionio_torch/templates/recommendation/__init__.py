"""Recommendation template — ALS on rate/buy events (the port of
``predictionio_tpu/templates/recommendation``): `DataSource` reads "rate"
and "buy" events (`buy` ⇒ rating 4.0), `ALSAlgorithm.train` runs ALS on
the context's device, `predict` answers {"user": ..., "num": ...} with
{"itemScores": [{"item": ..., "score": ...}]}.
"""

from predictionio_torch.templates.recommendation.engine import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    DataSource,
    DataSourceParams,
    PopularityAlgorithm,
    PopularityParams,
    Preparator,
    PreparedData,
    Query,
    RecommendationEngine,
    TrainingData,
    WeightedServing,
    WeightedServingParams,
)

__all__ = [
    "RecommendationEngine",
    "DataSource",
    "DataSourceParams",
    "Preparator",
    "PreparedData",
    "TrainingData",
    "ALSAlgorithm",
    "ALSAlgorithmParams",
    "PopularityAlgorithm",
    "PopularityParams",
    "WeightedServing",
    "WeightedServingParams",
    "Query",
]
