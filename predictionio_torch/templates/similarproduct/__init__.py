"""Similar Product template — item-item cosine from implicit-ALS factors
(the port of ``predictionio_tpu/templates/similarproduct``): `DataSource`
reads `view` events and the items' `categories`, `ALSAlgorithm.train`
runs implicit ALS on the context's device, `predict` answers
{"items": [...], "num": ...} with category / whiteList / blackList
filters.
"""

from predictionio_torch.templates.similarproduct.engine import (
    ALSAlgorithm,
    ALSAlgorithmParams,
    DataSource,
    DataSourceParams,
    Preparator,
    PreparedData,
    Query,
    SimilarProductEngine,
    SimilarProductModel,
    TrainingData,
)

__all__ = [
    "SimilarProductEngine",
    "SimilarProductModel",
    "DataSource",
    "DataSourceParams",
    "Preparator",
    "PreparedData",
    "TrainingData",
    "ALSAlgorithm",
    "ALSAlgorithmParams",
    "Query",
]
