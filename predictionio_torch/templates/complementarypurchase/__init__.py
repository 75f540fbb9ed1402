"""Complementary Purchase template — market-basket association rules
(the port of ``predictionio_tpu/templates/complementarypurchase``): `buy`
events are sessionized into baskets, pairwise "bought i → also buys j"
rules are mined with support/confidence/lift thresholds (co-occurrence
counted as an incidence Gram on the context's device — ops/basket.py),
and cart queries return top complements per condition item.
"""

from predictionio_torch.templates.complementarypurchase.engine import (
    AssociationAlgorithm,
    AssociationParams,
    ComplementaryPurchaseEngine,
    CPModel,
    DataSource,
    DataSourceParams,
    Preparator,
    PreparatorParams,
    PreparedData,
    Query,
    TrainingData,
)

__all__ = [
    "ComplementaryPurchaseEngine",
    "CPModel",
    "DataSource",
    "DataSourceParams",
    "Preparator",
    "PreparatorParams",
    "PreparedData",
    "TrainingData",
    "AssociationAlgorithm",
    "AssociationParams",
    "Query",
]
