"""Engine: binds DASE component classes + params into a trainable,
deployable unit — the port of ``predictionio_tpu/controller/engine.py``,
reduced to train, model (de)serialization and predict.
"""

from __future__ import annotations

import dataclasses
import logging
import pickle
from typing import Any, Optional, Sequence, Type

from predictionio_torch.controller.base import (
    Algorithm,
    DataSource,
    Doer,
    FirstServing,
    IdentityPreparator,
    Preparator,
    Serving,
    run_sanity_check,
)
from predictionio_torch.controller.context import WorkflowContext
from predictionio_torch.controller.params import Params

log = logging.getLogger(__name__)


def resolve_component(class_map: dict, name: str, role: str) -> Type:
    """An empty name falls back to a single-entry map's only class; a
    non-empty name must match exactly."""
    if name in class_map:
        return class_map[name]
    if name == "" and len(class_map) == 1:
        return next(iter(class_map.values()))
    raise KeyError(f"Unknown {role} name {name!r} (have {sorted(class_map)})")


@dataclasses.dataclass
class EngineParams:
    """Per-component (name, params) selections."""

    data_source_name: str = ""
    data_source_params: Optional[Params] = None
    preparator_name: str = ""
    preparator_params: Optional[Params] = None
    algorithm_params_list: list[tuple[str, Optional[Params]]] = dataclasses.field(
        default_factory=lambda: [("", None)])
    serving_name: str = ""
    serving_params: Optional[Params] = None


class Engine:
    def __init__(
        self,
        data_source_class_map,
        preparator_class_map=None,
        algorithm_class_map=None,
        serving_class_map=None,
    ):
        if data_source_class_map is None or algorithm_class_map is None:
            raise ValueError("Engine requires data_source_class_map and "
                             "algorithm_class_map")

        def as_map(x, default_cls=None):
            if x is None:
                return {"": default_cls}
            return x if isinstance(x, dict) else {"": x}

        self.data_source_class_map: dict[str, Type[DataSource]] = as_map(
            data_source_class_map)
        self.preparator_class_map: dict[str, Type[Preparator]] = as_map(
            preparator_class_map, IdentityPreparator)
        self.algorithm_class_map: dict[str, Type[Algorithm]] = as_map(
            algorithm_class_map)
        self.serving_class_map: dict[str, Type[Serving]] = as_map(
            serving_class_map, FirstServing)

    def components(self, engine_params: EngineParams):
        ds = Doer.apply(
            resolve_component(self.data_source_class_map,
                              engine_params.data_source_name, "data source"),
            engine_params.data_source_params)
        prep = Doer.apply(
            resolve_component(self.preparator_class_map,
                              engine_params.preparator_name, "preparator"),
            engine_params.preparator_params)
        algos = [
            (name, Doer.apply(
                resolve_component(self.algorithm_class_map, name,
                                  "algorithm"), params))
            for name, params in engine_params.algorithm_params_list
        ]
        serving = Doer.apply(
            resolve_component(self.serving_class_map,
                              engine_params.serving_name, "serving"),
            engine_params.serving_params)
        check = getattr(serving, "check_against_algorithms", None)
        if check is not None:
            check([name for name, _ in algos])
        return ds, prep, algos, serving

    def train(self, ctx: WorkflowContext, engine_params: EngineParams,
              sanity_check: bool = False) -> list[Any]:
        """Read → prepare → train every algorithm; returns the models."""
        ds, prep, algos, _ = self.components(engine_params)
        log.info("Engine.train: reading training data (%s)", type(ds).__name__)
        td = ds.read_training(ctx)
        if sanity_check:
            run_sanity_check(td, "training data")
        pd = prep.prepare(ctx, td)
        if sanity_check:
            run_sanity_check(pd, "prepared data")
        models = []
        for name, algo in algos:
            log.info("Engine.train: training algorithm %r (%s)", name,
                     type(algo).__name__)
            model = algo.train(ctx, pd)
            if sanity_check:
                run_sanity_check(model, f"model[{name}]")
            models.append(model)
        return models

    @staticmethod
    def serialize_models(models: Sequence[Any]) -> bytes:
        return pickle.dumps(list(models))

    @staticmethod
    def deserialize_models(blob: bytes) -> list[Any]:
        """Models of a blob this package wrote (pickle runs code: load
        only model files you trust)."""
        return pickle.loads(blob)

    def predict(self, engine_params: EngineParams, models: Sequence[Any],
                query: Any, components=None) -> Any:
        """Serve one query; the server resolves `components` once."""
        if components is None:
            components = self.components(engine_params)
        _, _, algos, serving = components
        predictions = [algo.predict(model, query)
                       for (_, algo), model in zip(algos, models)]
        return serving.serve(query, predictions)


class EngineFactory:
    """Subclass and implement `apply()` returning an Engine; engine.json
    names it by dotted path."""

    def apply(self) -> Engine:
        raise NotImplementedError
