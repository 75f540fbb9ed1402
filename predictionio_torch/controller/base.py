"""DASE component base classes — the port of
``predictionio_tpu/controller/base.py``, reduced to what the train,
predict, evaluate and batch-predict paths need.
"""

from __future__ import annotations

import abc
import inspect
import logging
from typing import Any, Generic, Optional, Sequence, Type, TypeVar

from predictionio_torch.controller.context import WorkflowContext
from predictionio_torch.controller.params import Params

log = logging.getLogger(__name__)

TD = TypeVar("TD")  # training data
PD = TypeVar("PD")  # prepared data
M = TypeVar("M")  # model
Q = TypeVar("Q")  # query
R = TypeVar("R")  # predicted result


class Doer:
    """Constructs a DASE component class with its Params (components take
    their params object as the single constructor argument)."""

    @staticmethod
    def apply(cls: Type, params: Optional[Params] = None):
        if params is None:
            return cls()
        try:
            takes_params = len(inspect.signature(cls).parameters) >= 1
        except (TypeError, ValueError):
            takes_params = True
        if not takes_params:
            raise TypeError(
                f"{cls.__name__} declares params but its constructor takes "
                "no arguments; accept the params object in __init__.")
        return cls(params)


class DataSource(abc.ABC, Generic[TD]):
    """Reads training data from the event source; `read_eval` returns the
    k evaluation folds, each (training data, [(query, actual), ...])."""

    @abc.abstractmethod
    def read_training(self, ctx: WorkflowContext) -> TD: ...

    def read_eval(self, ctx: WorkflowContext) -> list[tuple[TD, Sequence]]:
        raise NotImplementedError(
            f"{type(self).__name__} does not implement read_eval; "
            "evaluation is unavailable for this engine.")


class Preparator(abc.ABC, Generic[TD, PD]):
    """TrainingData → PreparedData."""

    @abc.abstractmethod
    def prepare(self, ctx: WorkflowContext, training_data: TD) -> PD: ...


class IdentityPreparator(Preparator):
    def prepare(self, ctx: WorkflowContext, training_data):
        return training_data


class Algorithm(abc.ABC, Generic[PD, M, Q, R]):
    """`train` builds a model on `ctx.device`; `predict` serves one query
    from an in-memory model; `batch_predict` scores many (the default
    loops `predict`)."""

    # the checkpoint subdir tags this class passes to
    # ctx.algorithm_checkpoint_dir; Engine._ckpt_suffixes tells duplicates
    # apart by them, so two classes that share a tag get distinct
    # suffixes. () means no checkpoints (keyed by class).
    checkpoint_tags: tuple = ()

    # True for algorithms whose predict is cheap enough (and needs no
    # per-user state) to answer under saturation — the serving plane's
    # degraded-mode fallback (e.g. a popularity model).
    degraded_capable: bool = False

    @abc.abstractmethod
    def train(self, ctx: WorkflowContext, prepared_data: PD) -> M: ...

    @abc.abstractmethod
    def predict(self, model: M, query: Q) -> R: ...

    def batch_predict(self, model: M, queries: Sequence[Q]) -> list[R]:
        return [self.predict(model, q) for q in queries]

    @classmethod
    def train_grid(cls, ctx: WorkflowContext, prepared_data: PD,
                   algos: Sequence["Algorithm"]) -> Optional[list[M]]:
        """Train the param variants `algos` (instances of `cls`) together:
        one model per entry, or None when the grid is not batchable and
        the evaluator should train them one by one (the default)."""
        return None


class Serving(abc.ABC, Generic[Q, R]):
    """Combine per-algorithm predictions into one."""

    @abc.abstractmethod
    def serve(self, query: Q, predictions: Sequence[R]) -> R: ...


class FirstServing(Serving):
    def serve(self, query, predictions):
        if not predictions:
            raise ValueError("No predictions to serve.")
        return predictions[0]


class SanityCheck(abc.ABC):
    """Optional self-check of training/prepared data and models after each
    DASE stage."""

    @abc.abstractmethod
    def sanity_check(self) -> None: ...


def run_sanity_check(obj: Any, stage: str) -> None:
    if isinstance(obj, SanityCheck):
        log.info("SanityCheck %s (%s)", stage, type(obj).__name__)
        obj.sanity_check()
