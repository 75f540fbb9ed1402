"""FakeWorkflow — run any function under the workflow harness: the port
of ``predictionio_tpu/workflow/fake.py``.

The function gets a `WorkflowContext` (device, storage, seed, metrics)
and the run gets an engine-instance row (RUNNING → COMPLETED, or FAILED
with the exception re-raised), so a one-off job shows in the store like
any train, without a DASE engine.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from predictionio_torch.controller.context import WorkflowContext
from predictionio_torch.storage.base import EngineInstance
from predictionio_torch.workflow.core_workflow import _now, tracked_instance


def run_fake_workflow(
    fn: Callable[[WorkflowContext], Any],
    ctx: Optional[WorkflowContext] = None,
    batch: str = "",
) -> Any:
    """`fn(ctx)` as a workflow; returns its result. Its engine-instance
    row goes RUNNING → COMPLETED, or FAILED and the exception
    re-raised."""
    ctx = ctx or WorkflowContext(batch=batch)
    instance = EngineInstance(
        id="", status="RUNNING", start_time=_now(), end_time=_now(),
        engine_id="fake", engine_version="1", engine_variant="fake",
        engine_factory=f"{fn.__module__}.{getattr(fn, '__qualname__', fn)}",
        batch=batch or ctx.batch, env={},
    )
    with tracked_instance(ctx.storage.meta_engine_instances(), instance,
                          label="FakeWorkflow"):
        return fn(ctx)
