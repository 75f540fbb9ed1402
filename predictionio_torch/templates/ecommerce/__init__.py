"""E-Commerce Recommendation template — implicit ALS + serve-time business
rules (seen / unavailable / category filters, cold start through recent
views): the port of ``predictionio_tpu/templates/ecommerce``. The
serve-time `LEventStore` lookups sit behind a TTL cache.
"""

from predictionio_torch.templates.ecommerce.engine import (
    DataSource,
    DataSourceParams,
    ECommAlgorithm,
    ECommAlgorithmParams,
    ECommerceEngine,
    ECommModelData,
    Preparator,
    PreparedData,
    Query,
    TrainingData,
)

__all__ = [
    "ECommerceEngine",
    "ECommAlgorithm",
    "ECommAlgorithmParams",
    "ECommModelData",
    "DataSource",
    "DataSourceParams",
    "Preparator",
    "PreparedData",
    "TrainingData",
    "Query",
]
