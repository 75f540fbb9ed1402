"""DASE controller: components, Engine, params, the workflow context and
offline evaluation — the port of ``predictionio_tpu/controller``."""

from predictionio_torch.controller.base import (
    Algorithm,
    DataSource,
    Doer,
    FirstServing,
    IdentityPreparator,
    Preparator,
    SanityCheck,
    Serving,
)
from predictionio_torch.controller.context import WorkflowContext
from predictionio_torch.controller.engine import Engine, EngineFactory, EngineParams
from predictionio_torch.controller.evaluation import (
    EngineParamsGenerator,
    Evaluation,
    EvaluationResult,
    MetricEvaluator,
)
from predictionio_torch.controller.metrics import (
    AUC,
    AverageMetric,
    MAPatK,
    Metric,
    OptionAverageMetric,
    StdevMetric,
    SumMetric,
    ZeroMetric,
)
from predictionio_torch.controller.params import EmptyParams, Params, ParamsError

__all__ = [
    "AUC", "Algorithm", "AverageMetric", "DataSource", "Doer", "EmptyParams",
    "Engine", "EngineFactory", "EngineParams", "EngineParamsGenerator",
    "Evaluation", "EvaluationResult", "FirstServing", "IdentityPreparator",
    "MAPatK", "Metric", "MetricEvaluator", "OptionAverageMetric", "Params",
    "ParamsError", "Preparator", "SanityCheck", "Serving", "StdevMetric",
    "SumMetric", "WorkflowContext", "ZeroMetric",
]
