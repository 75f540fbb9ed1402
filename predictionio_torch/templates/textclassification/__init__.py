"""Text Classification template — hashing tf-idf + NaiveBayes /
LogisticRegression, and a Word2Vec variant (the port of
``predictionio_tpu/templates/textclassification``): `$set` content
entities carry text + category; queries send text and get
{"category", "confidence"}.
"""

from predictionio_torch.templates.textclassification.engine import (
    DataSource,
    DataSourceParams,
    LRAlgorithm,
    LRParams,
    NBAlgorithm,
    NBParams,
    Preparator,
    PreparedData,
    Query,
    TextClassificationEngine,
    TrainingData,
    Word2VecAlgorithm,
    Word2VecParams,
)

__all__ = [
    "TextClassificationEngine",
    "DataSource",
    "DataSourceParams",
    "Preparator",
    "PreparedData",
    "TrainingData",
    "NBAlgorithm",
    "NBParams",
    "LRAlgorithm",
    "LRParams",
    "Word2VecAlgorithm",
    "Word2VecParams",
    "Query",
]
