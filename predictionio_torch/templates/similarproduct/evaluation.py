"""Similar Product evaluation: MAP@10 over a λ × iterations grid — the
port of ``predictionio_tpu/templates/similarproduct/evaluation.py``, over
the leave-views-out folds of `DataSource.read_eval`. Its cells differ in
λ and in the iteration count, so they train as one batched grid with
mixed horizons (`ops/als_grid.py`).

    python -m predictionio_torch.tools.console eval \\
        predictionio_torch.templates.similarproduct.evaluation.SimilarProductEvaluation

``PIO_EVAL_APP_NAME`` names the app (default "MyApp1"), ``PIO_EVAL_K``
the number of folds (default 3).
"""

from __future__ import annotations

import os

from predictionio_torch.controller import MAPatK
from predictionio_torch.controller.engine import EngineParams
from predictionio_torch.controller.evaluation import (
    EngineParamsGenerator,
    Evaluation,
)
from predictionio_torch.templates.similarproduct.engine import (
    ALSAlgorithmParams,
    DataSourceParams,
    SimilarProductEngine,
)


def _engine_params(rank: int, iters: int, lam: float, app_name: str,
                   eval_k: int) -> EngineParams:
    return EngineParams(
        data_source_params=DataSourceParams(appName=app_name, evalK=eval_k),
        algorithm_params_list=[
            ("als", ALSAlgorithmParams(rank=rank, numIterations=iters,
                                       lambda_=lam))],
    )


class SimilarProductEvaluation(Evaluation, EngineParamsGenerator):
    """Grid over λ {0.01, 0.1} × iterations {10, 20} at rank 8; primary
    metric MAP@10."""

    def __init__(self):
        app_name = os.environ.get("PIO_EVAL_APP_NAME", "MyApp1")
        eval_k = int(os.environ.get("PIO_EVAL_K", "3"))
        self.engine = SimilarProductEngine().apply()
        self.metric = MAPatK(10)
        self.engine_params_list = [
            _engine_params(8, iters, lam, app_name, eval_k)
            for lam in (0.01, 0.1)
            for iters in (10, 20)
        ]
