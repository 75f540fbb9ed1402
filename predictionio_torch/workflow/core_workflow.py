"""CoreWorkflow — the `pio train` body: the port of
``predictionio_tpu/workflow/core_workflow.py::CoreWorkflow.run_train``.

Read → prepare → train on the context's device, then pickle the models
into a model file (the engine instance's id and variant ride along).
Engine-instance and model-repository rows in storage come in a later
slice.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import tempfile
import uuid
from datetime import datetime, timezone
from typing import Any, Sequence

from predictionio_torch.controller.context import WorkflowContext
from predictionio_torch.controller.engine import Engine, EngineParams
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


def _now() -> str:
    return datetime.now(timezone.utc).isoformat()


def write_model_file(path: str, instance: EngineInstance,
                     models: Sequence[Any]) -> None:
    """Pickle the instance record and the models to `path` atomically
    (written beside it, then renamed)."""
    payload = {"format": MODEL_FILE_FORMAT,
               "instance": dataclasses.asdict(instance),
               "models": Engine.serialize_models(models)}
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(payload, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


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
