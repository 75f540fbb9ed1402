"""Recommendation template evaluation: MAP@10 over a rank × λ grid — the
port of ``predictionio_tpu/templates/recommendation/evaluation.py``.

    python -m predictionio_torch.tools.console eval \
        predictionio_torch.templates.recommendation.evaluation.RecommendationEvaluation \
        --events events.jsonl

``PIO_EVAL_K`` sets the number of folds (default 3), ``PIO_EVAL_APP_NAME``
the app name the DataSource logs (default "MyApp1").
"""

from __future__ import annotations

import os

from predictionio_torch.controller import MAPatK
from predictionio_torch.controller.engine import EngineParams
from predictionio_torch.controller.evaluation import (
    EngineParamsGenerator,
    Evaluation,
)
from predictionio_torch.templates.recommendation.engine import (
    ALSAlgorithmParams,
    DataSourceParams,
    RecommendationEngine,
)


def _engine_params(rank: int, iters: int, lam: float, app_name: str,
                   eval_k: int) -> EngineParams:
    return EngineParams(
        data_source_params=DataSourceParams(appName=app_name, evalK=eval_k),
        algorithm_params_list=[
            ("als", ALSAlgorithmParams(rank=rank, numIterations=iters,
                                       lambda_=lam))],
    )


class RecommendationEvaluation(Evaluation, EngineParamsGenerator):
    """Grid over rank {8, 16} × λ {0.01, 0.1} at 20 iterations; primary
    metric MAP@10."""

    def __init__(self):
        app_name = os.environ.get("PIO_EVAL_APP_NAME", "MyApp1")
        eval_k = int(os.environ.get("PIO_EVAL_K", "3"))
        self.engine = RecommendationEngine().apply()
        self.metric = MAPatK(10)
        self.engine_params_list = [
            _engine_params(rank, 20, lam, app_name, eval_k)
            for rank in (8, 16)
            for lam in (0.01, 0.1)
        ]
