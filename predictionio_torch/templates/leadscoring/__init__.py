"""Lead Scoring template — conversion probability from session features
(the port of ``predictionio_tpu/templates/leadscoring``): a visit's
first-view attributes (landing page, referrer, browser) predict whether
the session converts, through softmax regression in the role of the
upstream gallery template's RandomForest.
"""

from predictionio_torch.templates.leadscoring.engine import (
    DataSource,
    DataSourceParams,
    LeadScoringAlgorithm,
    LeadScoringEngine,
    LeadScoringModel,
    LeadScoringParams,
    Preparator,
    PreparedData,
    Query,
    Session,
    TrainingData,
)

__all__ = [
    "LeadScoringEngine",
    "LeadScoringModel",
    "LeadScoringAlgorithm",
    "LeadScoringParams",
    "DataSource",
    "DataSourceParams",
    "Preparator",
    "PreparedData",
    "TrainingData",
    "Session",
    "Query",
]
