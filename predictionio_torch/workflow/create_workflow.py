"""CreateWorkflow — the `pio train` and `pio eval` bodies from an
engine.json or an evaluation class name: the port of
``predictionio_tpu/workflow/create_workflow.py``.

It reads the engine variant, resolves its factory, extracts the typed
params, builds the `WorkflowContext` (one device in place of the
reference's mesh) and hands off to `CoreWorkflow`. `run_train` also opens
the metrics file, the profiler trace and the debug asserts. There is no
multi-process bootstrap: the port runs one process.
"""

from __future__ import annotations

from typing import Optional

from predictionio_torch.controller.context import WorkflowContext
from predictionio_torch.device import DeviceLike
from predictionio_torch.utils import checks
from predictionio_torch.utils.profiling import (
    MetricsLogger,
    maybe_trace,
    set_debug_flags,
)
from predictionio_torch.workflow.core_workflow import CoreWorkflow
from predictionio_torch.workflow.workflow_utils import (
    extract_engine_params,
    get_engine,
    read_engine_json,
    resolve_symbol,
)


def run_train(
    engine_json: str = "engine.json",
    engine_version: str = "1",
    batch: str = "",
    seed: int = 0,
    device: DeviceLike = None,
    skip_sanity_check: bool = False,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    profile_dir: Optional[str] = None,
    metrics_file: Optional[str] = None,
    debug_nans: bool = False,
    check_asserts: bool = False,
    events_path: Optional[str] = None,
    model_out: Optional[str] = None,
):
    """Train the engine of `engine_json` and persist its models (to the
    store, or to `model_out`); returns the engine instance. The debug
    asserts are armed for this call only."""
    armed = checks.enabled()
    set_debug_flags(nan_check=debug_nans, check_asserts=check_asserts)
    try:
        variant = read_engine_json(engine_json)
        engine = get_engine(variant.engine_factory)
        engine_params = extract_engine_params(engine, variant)
        with MetricsLogger(metrics_file, run=batch or variant.id) as metrics:
            ctx = WorkflowContext(
                device=device, seed=seed, events_path=events_path,
                batch=batch, checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every, metrics=metrics)
            with maybe_trace(profile_dir):
                return CoreWorkflow.run_train(
                    engine, engine_params, variant, ctx, model_out,
                    engine_version, sanity_check=not skip_sanity_check)
    finally:
        checks.enable(armed)


def _instantiate(dotted: str):
    obj = resolve_symbol(dotted)
    return obj() if isinstance(obj, type) else obj


def run_evaluation(
    evaluation_class: str,
    generator_class: Optional[str] = None,
    batch: str = "",
    seed: int = 0,
    device: DeviceLike = None,
    events_path: Optional[str] = None,
    out_path: Optional[str] = None,
):
    """Evaluate the params grid of `generator_class` (or of the
    evaluation itself when it has an `engine_params_list`); returns
    (evaluation instance, result)."""
    evaluation = _instantiate(evaluation_class)
    if generator_class:
        generator = _instantiate(generator_class)
    elif hasattr(evaluation, "engine_params_list"):
        generator = evaluation  # an Evaluation doubling as its generator
    else:
        raise ValueError("No engine params generator: pass "
                         "generator_class or give the Evaluation an "
                         "engine_params_list.")
    ctx = WorkflowContext(device=device, seed=seed, events_path=events_path,
                          batch=batch)
    return CoreWorkflow.run_evaluation(
        evaluation, generator, ctx, evaluation_class=evaluation_class,
        generator_class=generator_class or evaluation_class,
        out_path=out_path)
