"""CoreWorkflow — the `pio train` and `pio eval` bodies: the port of
``predictionio_tpu/workflow/core_workflow.py``.

Train: read → prepare → train on the context's device, then persist the
models as the reference does: one engine-instance row per train (RUNNING
→ COMPLETED/FAILED, holding the engine params JSON) in the metadata
repository and the model blob, keyed by the instance id, in the model
repository; `pio deploy` loads the latest completed instance. A model
file (a pickle holding the same engine-instance row with the models)
may take the storage's place. Eval: run the MetricEvaluator over the
generator's grid and record one evaluation-instance row, or write the
same record to a JSON file.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import pickle
import tempfile
import traceback
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
from predictionio_torch.data.events import format_time
from predictionio_torch.storage import base as storage_base
from predictionio_torch.workflow.workflow_utils import (
    EngineVariant,
    engine_params_to_json,
)

log = logging.getLogger(__name__)

# 2: the instance is the storage's engine-instance row
# (`storage.base.EngineInstance`), the same record a train into the
# model repository writes
MODEL_FILE_FORMAT = 2


def _now() -> datetime:
    return datetime.now(timezone.utc)


@contextlib.contextmanager
def tracked_instance(instances, instance, completed: str = "COMPLETED",
                     failed: str = "FAILED", label: str = "workflow"):
    """Instance-row lifecycle shared by train and eval: insert as-is (the
    caller sets the RUNNING-style status), mark `completed` after the
    block, mark `failed` + log + re-raise on exception. Fields the block
    sets on the instance (e.g. evaluator results) persist in the final
    update. With `instances` None the record gets an id and its statuses
    but is stored nowhere (the caller writes it out)."""
    if instances is None:
        instance.id = uuid.uuid4().hex
    else:
        instance.id = instances.insert(instance)
    log.info("%s: instance %s %s", label, instance.id, instance.status)
    try:
        yield instance
    except Exception:
        instance.status = failed
        instance.end_time = _now()
        if instances is not None:
            instances.update(instance)
        log.error("%s: instance %s %s\n%s", label, instance.id, failed,
                  traceback.format_exc())
        raise
    instance.status = completed
    instance.end_time = _now()
    if instances is not None:
        instances.update(instance)
    log.info("%s: instance %s %s", label, instance.id, completed)


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


def write_model_file(path: str, instance: storage_base.EngineInstance,
                     models: Sequence[Any]) -> None:
    """Pickle the instance record and the models to `path` atomically."""
    _write_atomic(path, pickle.dumps({
        "format": MODEL_FILE_FORMAT,
        "instance": dataclasses.asdict(instance),
        "models": Engine.serialize_models(models)}))


def read_model_file(
        path: str) -> tuple[storage_base.EngineInstance, list[Any]]:
    """(instance, models) of a model file `write_model_file` wrote (pickle
    runs code: load only model files you trust)."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if payload.get("format") != MODEL_FILE_FORMAT:
        raise ValueError(f"{path}: unknown model file format "
                         f"{payload.get('format')!r}")
    return (storage_base.EngineInstance(**payload["instance"]),
            Engine.deserialize_models(payload["models"]))


def _evaluation_record(instance: storage_base.EvaluationInstance) -> bytes:
    """The evaluation instance as the JSON an `eval --out` file holds."""
    record = dataclasses.asdict(instance)
    record["start_time"] = format_time(instance.start_time)
    record["end_time"] = format_time(instance.end_time)
    return json.dumps(record, indent=1).encode()


class CoreWorkflow:
    @staticmethod
    def run_train(
        engine: Engine,
        engine_params: EngineParams,
        variant: EngineVariant,
        ctx: WorkflowContext,
        model_out: Optional[str] = None,
        engine_version: str = "1",
        sanity_check: bool = True,
    ):
        """Train every algorithm of `engine_params` (with the sanity checks
        after each stage unless `sanity_check` is False) and persist the
        models: to the context's storage (an engine-instance row and the
        model blob), or, with `model_out`, to that model file. Returns the
        instance record."""
        instance = storage_base.EngineInstance(
            id="",
            status="RUNNING",
            start_time=_now(),
            end_time=_now(),
            engine_id=variant.id,
            engine_version=engine_version,
            engine_variant=variant.variant,
            engine_factory=variant.engine_factory,
            batch=ctx.batch,
            env={},
            **engine_params_to_json(engine_params),
        )
        if model_out:
            with tracked_instance(None, instance,
                                  label="CoreWorkflow.run_train"):
                models = engine.train(ctx, engine_params,
                                      sanity_check=sanity_check)
            write_model_file(model_out, instance, models)
            log.info("CoreWorkflow.run_train: instance %s trained %d "
                     "model(s) → %s", instance.id, len(models), model_out)
            return instance
        storage = ctx.storage
        with tracked_instance(storage.meta_engine_instances(), instance,
                              label="CoreWorkflow.run_train"):
            models = engine.train(ctx, engine_params,
                                      sanity_check=sanity_check)
            blob = engine.serialize_models(models)
            storage.model_data_models().insert(
                storage_base.Model(id=instance.id, models=blob))
            log.info("CoreWorkflow.run_train: instance %s trained %d "
                     "model(s), %d byte blob", instance.id, len(models),
                     len(blob))
        return instance

    @staticmethod
    def run_evaluation(
        evaluation: Evaluation,
        generator: EngineParamsGenerator,
        ctx: WorkflowContext,
        evaluation_class: str = "",
        generator_class: str = "",
        out_path: Optional[str] = None,
    ) -> tuple[storage_base.EvaluationInstance, EvaluationResult]:
        """Evaluate every engine params of `generator` and return the
        instance record with the result. A run over the event store
        records the instance in the context's storage (EVALRUNNING →
        EVALCOMPLETED or EVALFAILED); a run over an events file records
        it nowhere. With `out_path` the record is also written there as
        JSON when the evaluation ends, whether it completed or failed."""
        instance = storage_base.EvaluationInstance(
            id="",
            status="EVALRUNNING",
            start_time=_now(),
            end_time=_now(),
            evaluation_class=evaluation_class or type(evaluation).__name__,
            engine_params_generator_class=(generator_class
                                           or type(generator).__name__),
            batch=ctx.batch,
        )
        instances = (None if ctx.events_path
                     else ctx.storage.meta_evaluation_instances())
        try:
            with tracked_instance(instances, instance,
                                  completed="EVALCOMPLETED",
                                  failed="EVALFAILED",
                                  label="CoreWorkflow.run_evaluation"):
                result = MetricEvaluator.evaluate(
                    ctx, evaluation, list(generator.engine_params_list))
                instance.evaluator_results = result.summary()
                instance.evaluator_results_json = result.to_json()
        finally:
            if out_path:
                _write_atomic(out_path, _evaluation_record(instance))
        return instance, result
