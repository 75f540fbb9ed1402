"""SessionRec template evaluation: MAP@10 over a params grid — the port of
``predictionio_tpu/templates/sessionrec/evaluation.py``.

Leave-last-item-out folds (`DataSource.read_eval`): the held-out user's
prefix replays as the session and the model must rank the true next
item. Run with:

    python -m predictionio_torch.tools.console eval \
        predictionio_torch.templates.sessionrec.evaluation.SessionRecEvaluation

``PIO_EVAL_APP_NAME`` names the app (default "MyApp1"), ``PIO_EVAL_K``
the number of folds (default 3).
"""

from __future__ import annotations

import os

from predictionio_torch.controller import MAPatK
from predictionio_torch.controller.engine import EngineParams
from predictionio_torch.controller.evaluation import (
    EngineParamsGenerator,
    Evaluation,
)
from predictionio_torch.templates.sessionrec.engine import (
    DataSourceParams,
    SessionRecEngine,
    SessionRecParams,
)


def _engine_params(embed_dim: int, n_blocks: int, app_name: str,
                   eval_k: int) -> EngineParams:
    return EngineParams(
        data_source_params=DataSourceParams(appName=app_name, evalK=eval_k),
        algorithm_params_list=[
            ("attention", SessionRecParams(embedDim=embed_dim,
                                           numBlocks=n_blocks, seed=3))
        ],
    )


class SessionRecEvaluation(Evaluation, EngineParamsGenerator):
    """Grid over embedding dim {8, 16} × block count {1, 2}; primary
    metric MAP@10."""

    def __init__(self):
        app_name = os.environ.get("PIO_EVAL_APP_NAME", "MyApp1")
        eval_k = int(os.environ.get("PIO_EVAL_K", "3"))
        self.engine = SessionRecEngine().apply()
        self.metric = MAPatK(10)
        self.engine_params_list = [
            _engine_params(dim, blocks, app_name, eval_k)
            for dim in (8, 16)
            for blocks in (1, 2)
        ]
