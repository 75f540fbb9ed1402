"""Evaluation + MetricEvaluator: offline parameter-grid search — the port
of ``predictionio_tpu/controller/evaluation.py``.

An `Evaluation` binds an engine to metrics, an `EngineParamsGenerator`
holds the grid, and `MetricEvaluator` scores every (engine params, fold)
pair and ranks the engine params by the primary metric. Where the grid
varies only algorithm params, `Engine.eval_grid` reads the folds once and
trains the batchable cells together (`ops/als_grid.py`).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
from typing import Sequence

from predictionio_torch.controller.context import WorkflowContext
from predictionio_torch.controller.engine import Engine, EngineParams
from predictionio_torch.controller.metrics import Metric
from predictionio_torch.controller.params import params_to_dict

log = logging.getLogger(__name__)


class Evaluation:
    """Subclass and set `engine` and `metric` (and `metrics` for the
    secondary metrics)."""

    engine: Engine
    metric: Metric
    metrics: Sequence[Metric] = ()

    def all_metrics(self) -> list[Metric]:
        return [self.metric, *self.metrics]


class EngineParamsGenerator:
    """Subclass and set `engine_params_list`."""

    engine_params_list: Sequence[EngineParams]


@dataclasses.dataclass
class MetricScores:
    engine_params: EngineParams
    scores: dict[str, float]  # metric name → value, averaged over folds
    per_fold: list[dict[str, float]]


@dataclasses.dataclass
class EvaluationResult:
    best: MetricScores
    all_results: list[MetricScores]
    metric_name: str

    def to_json(self) -> str:
        def d(p):
            return params_to_dict(p) if p else {}

        def ep_dict(ep: EngineParams) -> dict:
            return {
                "dataSource": d(ep.data_source_params),
                "preparator": d(ep.preparator_params),
                "algorithms": [{"name": name, "params": d(p)}
                               for name, p in ep.algorithm_params_list],
                "serving": d(ep.serving_params),
            }

        return json.dumps({
            "metric": self.metric_name,
            "bestScore": self.best.scores[self.metric_name],
            "bestEngineParams": ep_dict(self.best.engine_params),
            "results": [{"engineParams": ep_dict(r.engine_params),
                         "scores": r.scores} for r in self.all_results],
        }, indent=2)

    def summary(self) -> str:
        lines = [f"Metric: {self.metric_name}"]
        for r in self.all_results:
            marker = " <= BEST" if r is self.best else ""
            lines.append(f"  score={r.scores[self.metric_name]:.6f}{marker}")
        return "\n".join(lines)


class MetricEvaluator:
    @staticmethod
    def evaluate(
        ctx: WorkflowContext,
        evaluation: Evaluation,
        engine_params_list: Sequence[EngineParams],
    ) -> EvaluationResult:
        if not engine_params_list:
            raise ValueError("No engine params to evaluate (empty generator "
                             "list).")
        engine = evaluation.engine
        metrics = evaluation.all_metrics()
        primary = metrics[0]
        for metric in metrics:
            metric.reset()
        # folds read once and batchable cells trained together; None =
        # the grid is not shareable, so each cell runs Engine.eval
        grid_results = engine.eval_grid(ctx, engine_params_list)
        all_results: list[MetricScores] = []
        for i, ep in enumerate(engine_params_list):
            if grid_results is not None:
                fold_results = grid_results[i]
            else:
                log.info("MetricEvaluator: engine params %d/%d", i + 1,
                         len(engine_params_list))
                fold_results = engine.eval(ctx, ep)
            per_fold = [{m.name: m.evaluate_all(qpa) for m in metrics}
                        for _, qpa in fold_results]

            # a fold where a metric is undefined (NaN) must not poison the
            # mean: average over the folds where it is defined
            def mean_defined(name: str) -> float:
                vals = [f[name] for f in per_fold if not math.isnan(f[name])]
                return sum(vals) / len(vals) if vals else float("nan")

            agg = {m.name: mean_defined(m.name) for m in metrics}
            all_results.append(MetricScores(ep, agg, per_fold))
        best = all_results[0]
        for r in all_results[1:]:
            if primary.compare(r.scores[primary.name],
                               best.scores[primary.name]) > 0:
                best = r
        return EvaluationResult(best=best, all_results=all_results,
                                metric_name=primary.name)
