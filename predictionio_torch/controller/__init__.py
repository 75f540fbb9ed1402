"""DASE controller: components, Engine, params and the workflow context —
the port of ``predictionio_tpu/controller``."""

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
from predictionio_torch.controller.params import EmptyParams, Params, ParamsError

__all__ = [
    "Algorithm", "DataSource", "Doer", "EmptyParams", "Engine",
    "EngineFactory", "EngineParams", "FirstServing", "IdentityPreparator",
    "Params", "ParamsError", "Preparator", "SanityCheck", "Serving",
    "WorkflowContext",
]
