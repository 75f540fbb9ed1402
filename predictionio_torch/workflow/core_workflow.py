"""CoreWorkflow — the `pio train` and `pio eval` bodies: the port of
``predictionio_tpu/workflow/core_workflow.py::CoreWorkflow.run_train`` and
``run_evaluation``.

Train: read → prepare → train on the context's device, then pickle the
models into a model file (the engine instance's id and variant ride
along). Eval: run the MetricEvaluator over the generator's grid and write
the evaluation instance — the fields of the reference's
`EvaluationInstance` row, results included — to a JSON file. Engine- and
evaluation-instance rows and the model repository in storage come in a
later slice.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import pickle
import tempfile
import uuid
from datetime import datetime, timezone
from typing import Any, Optional, Sequence

from predictionio_torch.controller.context import WorkflowContext
from predictionio_torch.controller.engine import Engine, EngineParams
from predictionio_torch.controller.evaluation import (
    EngineParamsGenerator,
    Evaluation,
    EvaluationResult,
    MetricEvaluator,
)
from predictionio_torch.workflow.workflow_utils import EngineVariant

log = logging.getLogger(__name__)

MODEL_FILE_FORMAT = 1


@dataclasses.dataclass
class EngineInstance:
    """What one train produced: its id, engine and the time it ran."""

    id: str
    engine_id: str
    engine_variant: str
    engine_factory: str
    start_time: str
    end_time: str


@dataclasses.dataclass
class EvaluationInstance:
    """What one evaluation ran and found: the reference's
    `EvaluationInstance` fields."""

    id: str
    status: str  # EVALRUNNING → EVALCOMPLETED or EVALFAILED
    start_time: str
    end_time: str
    evaluation_class: str
    engine_params_generator_class: str
    batch: str = ""
    env: dict = dataclasses.field(default_factory=dict)
    evaluator_results: str = ""  # human-readable summary
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""


def _now() -> str:
    return datetime.now(timezone.utc).isoformat()


def _write_atomic(path: str, data: bytes) -> None:
    """Write `path` whole or not at all (written beside it, renamed)."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def write_model_file(path: str, instance: EngineInstance,
                     models: Sequence[Any]) -> None:
    """Pickle the instance record and the models to `path` atomically."""
    _write_atomic(path, pickle.dumps({
        "format": MODEL_FILE_FORMAT,
        "instance": dataclasses.asdict(instance),
        "models": Engine.serialize_models(models)}))


def read_model_file(path: str) -> tuple[EngineInstance, list[Any]]:
    """(instance, models) of a model file `write_model_file` wrote (pickle
    runs code: load only model files you trust)."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if payload.get("format") != MODEL_FILE_FORMAT:
        raise ValueError(f"{path}: unknown model file format "
                         f"{payload.get('format')!r}")
    return (EngineInstance(**payload["instance"]),
            Engine.deserialize_models(payload["models"]))


class CoreWorkflow:
    @staticmethod
    def run_train(
        engine: Engine,
        engine_params: EngineParams,
        variant: EngineVariant,
        ctx: WorkflowContext,
        model_out: str,
    ) -> EngineInstance:
        """Train every algorithm of `engine_params` (with the sanity checks
        after each stage) and persist the models to `model_out`."""
        start = _now()
        models = engine.train(ctx, engine_params, sanity_check=True)
        instance = EngineInstance(
            id=uuid.uuid4().hex,
            engine_id=variant.id,
            engine_variant=variant.variant,
            engine_factory=variant.engine_factory,
            start_time=start,
            end_time=_now(),
        )
        write_model_file(model_out, instance, models)
        log.info("CoreWorkflow.run_train: instance %s trained %d model(s) "
                 "→ %s", instance.id, len(models), model_out)
        return instance

    @staticmethod
    def run_evaluation(
        evaluation: Evaluation,
        generator: EngineParamsGenerator,
        ctx: WorkflowContext,
        evaluation_class: str = "",
        generator_class: str = "",
        out_path: Optional[str] = None,
    ) -> tuple[EvaluationInstance, EvaluationResult]:
        """Evaluate every engine params of `generator` and return the
        instance record with the result. With `out_path`, the record is
        written there as JSON when the evaluation ends, with status
        EVALFAILED when it raised."""
        instance = EvaluationInstance(
            id=uuid.uuid4().hex,
            status="EVALRUNNING",
            start_time=_now(),
            end_time="",
            evaluation_class=evaluation_class or type(evaluation).__name__,
            engine_params_generator_class=(generator_class
                                           or type(generator).__name__),
        )
        try:
            result = MetricEvaluator.evaluate(
                ctx, evaluation, list(generator.engine_params_list))
            instance.evaluator_results = result.summary()
            instance.evaluator_results_json = result.to_json()
            instance.status = "EVALCOMPLETED"
        except Exception:
            instance.status = "EVALFAILED"
            raise
        finally:
            instance.end_time = _now()
            if out_path:
                _write_atomic(out_path, json.dumps(
                    dataclasses.asdict(instance), indent=1).encode())
            log.info("CoreWorkflow.run_evaluation: instance %s %s",
                     instance.id, instance.status)
        return instance, result
