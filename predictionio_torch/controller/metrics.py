"""Metrics for offline evaluation — the port of
``predictionio_tpu/controller/metrics.py``: `Metric`, `AverageMetric`,
`OptionAverageMetric`, `SumMetric`, `StdevMetric`, `ZeroMetric`, `AUC`
and `MAPatK`.
"""

from __future__ import annotations

import abc
import math
from typing import Any, Generic, Optional, Sequence, TypeVar

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


class SumMetric(Metric[Q, R, A], abc.ABC):
    def aggregate(self, scores: Sequence[Optional[float]]) -> float:
        return float(sum(s for s in scores if s is not None))


class StdevMetric(Metric[Q, R, A], abc.ABC):
    def aggregate(self, scores: Sequence[Optional[float]]) -> float:
        vals = [s for s in scores if s is not None]
        if len(vals) < 2:
            return 0.0
        mean = sum(vals) / len(vals)
        return math.sqrt(sum((v - mean) ** 2 for v in vals) / (len(vals) - 1))


class ZeroMetric(Metric[Any, Any, Any]):
    """Always 0 — a placeholder secondary metric."""

    def calculate(self, query, predicted, actual) -> float:
        return 0.0


class AUC(Metric[Any, dict, dict]):
    """Area under the ROC curve of a binary scoring engine (the role of
    MLlib's `BinaryClassificationMetrics.areaUnderROC`).

    AUC is a statistic of the whole set of (score, label) pairs, with no
    per-point score: `calculate` returns None (the Optional contract's
    "excluded" value) and `evaluate_all` computes it (rank-based,
    Mann-Whitney U with ties at their average rank). Nothing is buffered
    between calls, so interleaved or aborted folds cannot mix.

    `predicted[score_key]` is the engine's score; `actual[label_key]` is
    0/1 (or falsy/truthy).
    """

    def __init__(self, score_key: str = "score", label_key: str = "label"):
        self.score_key = score_key
        self.label_key = label_key

    def calculate(self, query, predicted, actual) -> Optional[float]:
        return None  # no per-point AUC; see evaluate_all

    def aggregate(self, scores: Sequence[Optional[float]]) -> float:
        """Fails loudly for a caller on the per-point protocol: averaging
        `calculate`'s Nones would make the metric vanish as NaN."""
        raise TypeError("AUC is a set-level metric with no per-point "
                        "scores; call evaluate_all(qpa) instead of "
                        "calculate/aggregate")

    def evaluate_all(self, qpa) -> float:
        pairs = [(float(p[self.score_key]), 1 if a[self.label_key] else 0)
                 for _, p, a in qpa]
        n_pos = sum(label for _, label in pairs)
        n_neg = len(pairs) - n_pos
        if n_pos == 0 or n_neg == 0:
            return float("nan")  # undefined on a one-class fold
        # average ranks over ties, rank sum over the positives
        order = sorted(range(len(pairs)), key=lambda i: pairs[i][0])
        ranks = [0.0] * len(pairs)
        i = 0
        while i < len(order):
            j = i
            while (j + 1 < len(order)
                   and pairs[order[j + 1]][0] == pairs[order[i]][0]):
                j += 1
            avg_rank = (i + j) / 2.0 + 1.0
            for k in range(i, j + 1):
                ranks[order[k]] = avg_rank
            i = j + 1
        rank_sum_pos = sum(r for r, (_, label) in zip(ranks, pairs) if label)
        u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
        return float(u / (n_pos * n_neg))


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
