"""Online learning — the port of ``predictionio_tpu/online``: ALS fold-in
(`foldin.py`), which re-solves the dirty rows of a trained model against
fixed opposing factors, with cold-start rows appended for never-seen ids;
the session fold (`session.py`), which rebuilds the dirty users' session
windows and pooled embeddings of a sessionrec model; the plane
(`plane.py`) that tails the event store, folds each fresh batch on the
server's device and hot-swaps the folded models into what a deployed
`PredictionServer` serves (`swap.py`); and the plane's telemetry families
(`metrics.py`).
"""

from predictionio_torch.online.foldin import (  # noqa: F401
    ALSFold,
    FoldModel,
    FoldStats,
    SeenOverlay,
    fold_model,
    solve_rows,
)
from predictionio_torch.online.plane import OnlineConfig, OnlinePlane  # noqa: F401
from predictionio_torch.online.session import SessionFold  # noqa: F401
from predictionio_torch.online.swap import DeltaSwapper, StaleState  # noqa: F401

__all__ = [
    "ALSFold", "DeltaSwapper", "FoldModel", "FoldStats", "OnlineConfig",
    "OnlinePlane", "SeenOverlay", "SessionFold", "StaleState",
    "fold_model", "solve_rows",
]
