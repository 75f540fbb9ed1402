"""Device resolution: the port runs one device per process.

Plays the single-device role of the reference's
``parallel/mesh.py::make_mesh`` (which device the work runs on) and of
``controller/context.py::WorkflowContext.mesh/rng`` (the device and the
seeded random stream a train uses).

Entry points take an explicit ``device``. With none given they read
``PIO_TORCH_DEVICE`` and otherwise take CUDA; a CUDA request on a machine
without a CUDA device raises instead of running on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

DEVICE_ENV = "PIO_TORCH_DEVICE"

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: `device` when given, else
    ``$PIO_TORCH_DEVICE``, else ``cuda``. Raises RuntimeError for a CUDA
    device when CUDA is not available."""
    name = device if device is not None else (
        os.environ.get(DEVICE_ENV) or "cuda")
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "predictionio_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' (or set PIO_TORCH_DEVICE=cpu) "
            "to run on the CPU")
    return dev


def make_generator(device: torch.device, seed: int) -> torch.Generator:
    """A `torch.Generator` on `device`, seeded — the port's counterpart of
    ``jax.random.key(seed)`` (the two give different numbers)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def synchronize(device: Optional[torch.device]) -> None:
    """Fence: wait for the device's queued work (no-op on the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
