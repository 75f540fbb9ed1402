"""Classification template — NaiveBayes / LogisticRegression on entity
properties (the port of ``predictionio_tpu/templates/classification``):
`$set` events carry attr0/attr1/attr2 + "plan" per user; queries send the
attributes and get {"label": ...}.
"""

from predictionio_torch.templates.classification.engine import (
    ClassificationEngine,
    DataSource,
    DataSourceParams,
    LogisticRegressionAlgorithm,
    LogisticRegressionParams,
    NaiveBayesAlgorithm,
    NaiveBayesParams,
    Preparator,
    PreparedData,
    Query,
    TrainingData,
)

__all__ = [
    "ClassificationEngine",
    "DataSource",
    "DataSourceParams",
    "Preparator",
    "PreparedData",
    "TrainingData",
    "NaiveBayesAlgorithm",
    "NaiveBayesParams",
    "LogisticRegressionAlgorithm",
    "LogisticRegressionParams",
    "Query",
]
