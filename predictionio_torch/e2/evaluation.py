"""Cross-validation splitting — the port of
``predictionio_tpu/e2/evaluation.py``.

Splits a dataset into k (training, testing) folds by index, the helper a
template's `DataSource.read_eval` builds its folds with (the role of
PredictionIO's e2 `CommonHelperFunctions.CrossValidation`).
"""

from __future__ import annotations

from typing import Callable, Sequence, TypeVar

D = TypeVar("D")
TD = TypeVar("TD")


def cross_validation_splits(
    data: Sequence[D],
    eval_k: int,
    create_training: Callable[[list], TD],
    to_query_actual: Callable[[D], tuple],
) -> list[tuple]:
    """Fold i tests on every point whose index is i mod k and trains on
    the rest.

    Returns [(training_data, [(query, actual), ...]), ...]: the shape
    `DataSource.read_eval` returns.
    """
    if eval_k < 2:
        raise ValueError("eval_k must be >= 2")
    folds = []
    for fold in range(eval_k):
        train = [d for i, d in enumerate(data) if i % eval_k != fold]
        test = [d for i, d in enumerate(data) if i % eval_k == fold]
        folds.append(
            (create_training(train), [to_query_actual(d) for d in test])
        )
    return folds
