"""Metrics for offline evaluation — the port of
``predictionio_tpu/controller/metrics.py``, reduced to what the
Recommendation evaluation needs: `Metric`, `AverageMetric`,
`OptionAverageMetric` and `MAPatK`.
"""

from __future__ import annotations

import abc
import math
from typing import Generic, Optional, Sequence, TypeVar

from predictionio_torch.ops.ranking import average_precision_at_k

Q = TypeVar("Q")
R = TypeVar("R")
A = TypeVar("A")


class Metric(abc.ABC, Generic[Q, R, A]):
    #: higher is better by default; metrics like RMSE set False
    higher_is_better: bool = True

    @abc.abstractmethod
    def calculate(self, query: Q, predicted: R, actual: A) -> Optional[float]:
        """Score one evaluation point; None excludes the point."""

    def aggregate(self, scores: Sequence[Optional[float]]) -> float:
        """Mean of the points that have a score (NaN when none has)."""
        vals = [s for s in scores if s is not None]
        if not vals:
            return float("nan")
        return sum(vals) / len(vals)

    def evaluate_all(self, qpa: Sequence[tuple[Q, R, A]]) -> float:
        """Metric value over one fold's (query, predicted, actual) points:
        the evaluator's entry point."""
        return self.aggregate([self.calculate(q, p, a) for q, p, a in qpa])

    @property
    def name(self) -> str:
        return type(self).__name__

    def reset(self) -> None:
        """Drop buffered evaluation state (none here); the evaluator calls
        it before each run."""

    def compare(self, a: float, b: float) -> int:
        """> 0 if a is better than b; NaN is worse than anything."""
        if math.isnan(a):
            return -1
        if math.isnan(b):
            return 1
        d = a - b if self.higher_is_better else b - a
        return (d > 0) - (d < 0)


class AverageMetric(Metric[Q, R, A], abc.ABC):
    """Mean of per-point scores."""


class OptionAverageMetric(Metric[Q, R, A], abc.ABC):
    """Mean over the points where `calculate` returns a value."""


class MAPatK(OptionAverageMetric):
    """MAP@k on the templates' itemScores wire shape: predicted
    {"itemScores": [{"item": ..., "score": ...}]} against actual
    {"items": [...]}."""

    def __init__(self, k: int = 10):
        self.k = k

    @property
    def name(self) -> str:
        return f"MAP@{self.k}"

    def calculate(self, query, predicted, actual):
        items = [s["item"] for s in predicted.get("itemScores", [])]
        actual_set = set(actual.get("items", []))
        if not actual_set:
            return None  # excluded from the mean
        return average_precision_at_k(items, actual_set, self.k)
