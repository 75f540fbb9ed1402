"""Online learning — the port of ``predictionio_tpu/online``: ALS fold-in
(`foldin.py`), which re-solves the dirty rows of a trained model against
fixed opposing factors, with cold-start rows appended for never-seen ids,
and the plane's telemetry families (`metrics.py`). The plane that tails
the event store and swaps folded models into serving comes in a later
slice.
"""

from predictionio_torch.online.foldin import (  # noqa: F401
    ALSFold,
    FoldModel,
    FoldStats,
    SeenOverlay,
    fold_model,
    solve_rows,
)

__all__ = [
    "ALSFold", "FoldModel", "FoldStats", "SeenOverlay", "fold_model",
    "solve_rows",
]
