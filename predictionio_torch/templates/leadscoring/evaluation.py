"""Lead Scoring evaluation — the port of
``predictionio_tpu/templates/leadscoring/evaluation.py``: AUC over k
session folds across a small regularization grid (the upstream template
scores its forest with MLlib's BinaryClassificationMetrics; here AUC is
`controller.metrics.AUC`)."""

from __future__ import annotations

import os

from predictionio_torch.controller import (
    AUC,
    EngineParams,
    EngineParamsGenerator as BaseGenerator,
    Evaluation,
)
from predictionio_torch.templates.leadscoring.engine import (
    DataSourceParams,
    LeadScoringEngine,
    LeadScoringParams,
)


class RegGridGenerator(BaseGenerator):
    """A grid over regParam; subclass it or pass your own values."""

    def __init__(self, app_name: str, eval_k: int = 3,
                 reg_params=(0.001, 0.01, 0.1)):
        self.engine_params_list = [
            EngineParams(
                data_source_params=DataSourceParams(appName=app_name,
                                                    evalK=eval_k),
                algorithm_params_list=[
                    ("leadscoring", LeadScoringParams(regParam=r))],
            )
            for r in reg_params
        ]


class LeadScoringEvaluation(Evaluation, RegGridGenerator):
    """`console eval predictionio_torch.templates.leadscoring.evaluation.
    LeadScoringEvaluation`: the app from PIO_EVAL_APP_NAME (default
    "MyApp1") and PIO_EVAL_K folds (default 3), as the Recommendation
    evaluation."""

    engine = LeadScoringEngine().apply()

    def __init__(self):
        self.metric = AUC()
        RegGridGenerator.__init__(
            self, os.environ.get("PIO_EVAL_APP_NAME", "MyApp1"),
            eval_k=int(os.environ.get("PIO_EVAL_K", "3")))
