"""WorkflowContext — what a train threads through every DASE call: the
port of ``predictionio_tpu/controller/context.py``.

Where the reference carries a JAX device mesh and a `jax.random` key, the
port carries one `torch.device` and a seeded `torch.Generator`. Like the
reference's it carries the storage the run reads and writes; a run may
instead read a JSON-lines events file (`events_path`).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import torch

from predictionio_torch.device import DeviceLike, make_generator, resolve_device

if TYPE_CHECKING:
    from predictionio_torch.storage.registry import Storage


class WorkflowContext:
    def __init__(
        self,
        device: DeviceLike = None,
        seed: int = 0,
        events_path: Optional[str] = None,
        storage: Optional["Storage"] = None,
    ):
        """Args:
        device: the device the train runs on (`device.resolve_device`).
        seed: base seed for all algorithms in this run.
        events_path: a JSON-lines events file the DataSource reads in
            place of the event store.
        storage: the storage the run reads events from and writes its
            instance records and models to; None is `Storage.get()`, taken
            when first used.
        """
        self.device = resolve_device(device)
        self.seed = seed
        self.events_path = events_path
        self._storage = storage

    @property
    def storage(self) -> "Storage":
        if self._storage is None:
            from predictionio_torch.storage.registry import Storage

            self._storage = Storage.get()
        return self._storage

    def generator(self, salt: int = 0) -> torch.Generator:
        """A generator on the context's device seeded with seed + salt."""
        return make_generator(self.device, self.seed + salt)

    def __repr__(self) -> str:
        return (f"WorkflowContext(device={self.device}, seed={self.seed}, "
                f"events_path={self.events_path!r})")
