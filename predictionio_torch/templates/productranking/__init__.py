"""Product Ranking template — rank a given item list for a user: the port
of ``predictionio_tpu/templates/productranking``. The Recommendation
template's data path and ALS train; serving re-orders the query's
candidates by the user's predicted preference, and answers the original
order with `isOriginal: true` for an unknown user.
"""

from predictionio_torch.templates.productranking.engine import (
    DataSource,
    DataSourceParams,
    Preparator,
    PreparedData,
    ProductRankingEngine,
    Query,
    RankingALSAlgorithm,
    TrainingData,
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
