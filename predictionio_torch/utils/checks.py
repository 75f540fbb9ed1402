"""Train-loop assert mode (`console train --check-asserts`) — the port of
``predictionio_tpu/utils/checks.py``.

The reference runs its jitted train loops through `checkify`, which
carries an error value through the program and raises on readback. The
port's loops run eagerly, so the same invariant is an explicit assert
between the loop's steps: under this mode `ops.als.als_train` checks
after each half-epoch that the solved factors are finite
(`require_finite`), with the reference's message. The grid evaluator
declines to batch under this mode, as the reference's does, so every
cell trains through the checked loop.

The mode is process-wide, like the reference's: a CLI flag arms it
without threading a parameter through every op.
"""

from __future__ import annotations

import logging

import torch

log = logging.getLogger(__name__)

_enabled = False

NON_FINITE = ("ALS: non-finite factors after solve (rank-deficient normal "
              "equations or corrupt input)")


class CheckFailed(RuntimeError):
    """An assert of the train loop failed under the assert mode."""


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on
    if on:
        log.info("checks: assert mode enabled (finite checks in train "
                 "loops)")


def enabled() -> bool:
    return _enabled


def require_finite(*tensors: torch.Tensor, message: str = NON_FINITE) -> None:
    """Raise CheckFailed unless every element of `tensors` is finite (one
    device readback)."""
    ok = torch.stack([torch.isfinite(t).all() for t in tensors]).all()
    if not bool(ok):
        raise CheckFailed(message)
