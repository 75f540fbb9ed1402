"""SessionRec template — causal self-attention next-item model (the port
of ``predictionio_tpu/templates/sessionrec``).

Users `view`/`buy` items; the model learns next-item transitions over
each user's canonical recent-item window and serves
{"user": ..., "num": ...} or {"items": [...], "num": ...} queries with
{"itemScores": [...]}. On the card it scores through the hand-written
kernels of ``csrc/session.cu`` (`ops/session.py`).
"""

from predictionio_torch.templates.sessionrec.engine import (
    DataSource,
    DataSourceParams,
    PreparedData,
    Preparator,
    Query,
    SessionRecAlgorithm,
    SessionRecEngine,
    SessionRecParams,
    TrainingData,
)

__all__ = [
    "SessionRecEngine",
    "DataSource",
    "DataSourceParams",
    "Preparator",
    "PreparedData",
    "TrainingData",
    "SessionRecAlgorithm",
    "SessionRecParams",
    "Query",
]
