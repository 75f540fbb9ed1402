"""WorkflowContext — what a train threads through every DASE call: the
port of ``predictionio_tpu/controller/context.py``.

Where the reference carries a JAX device mesh and a `jax.random` key, the
port carries one `torch.device` and a seeded `torch.Generator`; it also
carries the event source the DataSource reads.
"""

from __future__ import annotations

from typing import Optional

import torch

from predictionio_torch.device import DeviceLike, make_generator, resolve_device


class WorkflowContext:
    def __init__(
        self,
        device: DeviceLike = None,
        seed: int = 0,
        events_path: Optional[str] = None,
    ):
        """Args:
        device: the device the train runs on (`device.resolve_device`).
        seed: base seed for all algorithms in this run.
        events_path: the JSON-lines events file the DataSource reads.
        """
        self.device = resolve_device(device)
        self.seed = seed
        self.events_path = events_path

    def generator(self, salt: int = 0) -> torch.Generator:
        """A generator on the context's device seeded with seed + salt."""
        return make_generator(self.device, self.seed + salt)

    def __repr__(self) -> str:
        return (f"WorkflowContext(device={self.device}, seed={self.seed}, "
                f"events_path={self.events_path!r})")
