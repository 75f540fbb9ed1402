"""engine.json parsing + engine loading — the port of
``predictionio_tpu/workflow/workflow_utils.py``.

    {
      "id": "default",
      "engineFactory": "pkg.module.FactoryClass",
      "datasource": {"params": {...}},
      "preparator": {"params": {...}},
      "algorithms": [{"name": "als", "params": {...}}],
      "serving": {"name": "...", "params": {...}}
    }

Component classes declare a ``params_class``; each params block maps
through it, and unknown keys are an error.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from typing import Any, Optional, Type

from predictionio_torch.controller.engine import (
    Engine,
    EngineParams,
    resolve_component,
)
from predictionio_torch.controller.params import (
    Params,
    params_from_dict,
    params_to_dict,
)


@dataclasses.dataclass
class EngineVariant:
    """A parsed engine.json."""

    id: str
    description: str
    engine_factory: str
    datasource: dict[str, Any]
    preparator: dict[str, Any]
    algorithms: list[dict[str, Any]]
    serving: dict[str, Any]
    raw: dict[str, Any]
    variant: str = "default"

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "EngineVariant":
        if "engineFactory" not in d:
            raise ValueError("engine.json is missing required key 'engineFactory'")
        return cls(
            id=d.get("id", "default"),
            variant=d.get("variant", d.get("id", "default")),
            description=d.get("description", ""),
            engine_factory=d["engineFactory"],
            datasource=d.get("datasource") or {},
            preparator=d.get("preparator") or {},
            algorithms=d.get("algorithms") or [{}],
            serving=d.get("serving") or {},
            raw=d,
        )


def read_engine_json(path: str) -> EngineVariant:
    with open(path) as f:
        return EngineVariant.from_dict(json.load(f))


def resolve_symbol(dotted: str) -> Any:
    """Import `pkg.module.Name` (also `pkg.module:Name`)."""
    if ":" in dotted:
        module_name, _, attr = dotted.partition(":")
        attrs = attr.split(".")
    else:
        parts = dotted.split(".")
        for i in range(len(parts) - 1, 0, -1):
            module_name = ".".join(parts[:i])
            try:
                importlib.import_module(module_name)
                attrs = parts[i:]
                break
            except ModuleNotFoundError:
                continue
        else:
            raise ImportError(f"Cannot import any module prefix of {dotted!r}")
    obj = importlib.import_module(module_name)
    for a in attrs:
        obj = getattr(obj, a)
    return obj


def get_engine(engine_factory: str) -> Engine:
    """Resolve the factory: an EngineFactory subclass (instantiated,
    `.apply()` called), a function returning an Engine, or an Engine."""
    obj = resolve_symbol(engine_factory)
    if isinstance(obj, Engine):
        return obj
    if isinstance(obj, type):
        inst = obj()
        engine = inst.apply() if hasattr(inst, "apply") else inst
    elif callable(obj):
        engine = obj()
    else:
        raise TypeError(f"{engine_factory!r} is not an engine factory")
    if not isinstance(engine, Engine):
        raise TypeError(f"{engine_factory!r} did not produce an Engine, got "
                        f"{type(engine).__name__}")
    return engine


def _component_params(cls: Type, block: dict[str, Any],
                      role: str) -> Optional[Params]:
    params_json = block.get("params") or {}
    params_cls = getattr(cls, "params_class", None)
    if params_cls is None:
        if params_json:
            raise ValueError(f"{role} {cls.__name__} takes no params but "
                             f"engine.json provides {sorted(params_json)}")
        return None
    return params_from_dict(params_cls, params_json)


def extract_engine_params(engine: Engine, variant: EngineVariant) -> EngineParams:
    """engine.json blocks → typed EngineParams."""

    def pick(class_map: dict, block: dict[str, Any], role: str):
        name = block.get("name", "")
        cls = resolve_component(class_map, name, role)
        if name not in class_map:
            name = next(k for k, v in class_map.items() if v is cls)
        return name, cls

    ds_name, ds_cls = pick(engine.data_source_class_map, variant.datasource,
                           "datasource")
    prep_name, prep_cls = pick(engine.preparator_class_map,
                               variant.preparator, "preparator")
    serv_name, serv_cls = pick(engine.serving_class_map, variant.serving,
                               "serving")
    algo_list: list[tuple[str, Optional[Params]]] = []
    for block in variant.algorithms:
        algo_name, algo_cls = pick(engine.algorithm_class_map, block,
                                   "algorithm")
        algo_list.append((algo_name,
                          _component_params(algo_cls, block, "algorithm")))
    return EngineParams(
        data_source_name=ds_name,
        data_source_params=_component_params(ds_cls, variant.datasource,
                                             "datasource"),
        preparator_name=prep_name,
        preparator_params=_component_params(prep_cls, variant.preparator,
                                            "preparator"),
        algorithm_params_list=algo_list,
        serving_name=serv_name,
        serving_params=_component_params(serv_cls, variant.serving,
                                         "serving"),
    )


def engine_params_to_json(engine_params: EngineParams) -> dict[str, str]:
    """EngineParams blocks as the JSON columns of an engine-instance row.

    Every block stores `{"name": ..., "params": {...}}`: the component
    name must survive the row round trip, or a deploy that rebuilds the
    variant from the stored instance would resolve multi-entry class maps
    to the wrong component (a weighted-serving train deployed as
    FirstServing)."""

    def block(name, p):
        return json.dumps(
            {"name": name, "params": params_to_dict(p) if p else {}})

    return {
        "data_source_params": block(engine_params.data_source_name,
                                    engine_params.data_source_params),
        "preparator_params": block(engine_params.preparator_name,
                                   engine_params.preparator_params),
        "algorithms_params": json.dumps([
            {"name": name, "params": params_to_dict(p) if p else {}}
            for name, p in engine_params.algorithm_params_list
        ]),
        "serving_params": block(engine_params.serving_name,
                                engine_params.serving_params),
    }
