"""WorkflowContext — what a train threads through every DASE call: the
port of ``predictionio_tpu/controller/context.py``.

Where the reference carries a JAX device mesh and a `jax.random` key, the
port carries one `torch.device` and a seeded `torch.Generator`. Like the
reference's it carries the storage the run reads and writes (a run may
instead read a JSON-lines events file, `events_path`), the run's label,
where its algorithms checkpoint and cache, and its metrics logger. The
reference's `verbose` stays at the console, where it sets the log level.
"""

from __future__ import annotations

import contextlib
import os
from typing import TYPE_CHECKING, Any, Optional

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
        batch: str = "",
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: Optional[int] = None,
        metrics: Optional[Any] = None,
    ):
        """Args:
        device: the device the train runs on (`device.resolve_device`).
        seed: base seed for all algorithms in this run.
        events_path: a JSON-lines events file the DataSource reads in
            place of the event store.
        storage: the storage the run reads events from and writes its
            instance records and models to; None is `Storage.get()`, taken
            when first used.
        batch: the run's label (the reference's `--batch`).
        checkpoint_dir: when set, algorithms checkpoint their trainer state
            under it every `checkpoint_every` of their own steps (ALS:
            epochs) and resume from the latest step on a re-run.
        checkpoint_every: None lets each algorithm pick (ALS: every
            epoch); a value applies as given.
        metrics: a `utils.profiling.MetricsLogger` for per-epoch metrics
            (default: the log only).
        """
        self.device = resolve_device(device)
        self.seed = seed
        self.events_path = events_path
        self._storage = storage
        self.batch = batch
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        # set by Engine.train/eval around each algorithm's train: ".N" for
        # the N-th user of a checkpoint tag in one engine, so two such
        # algorithms neither share nor purge one checkpoint subdir
        self.algo_ckpt_suffix = ""
        self._metrics = metrics

    @property
    def metrics(self):
        if self._metrics is None:
            from predictionio_torch.utils.profiling import NullMetricsLogger

            self._metrics = NullMetricsLogger()
        return self._metrics

    def checkpoint_every_or(self, default: int) -> int:
        """`checkpoint_every` when the run set one, else the algorithm's
        own `default` (its step unit varies: an ALS epoch runs long enough
        to save after each, a 200-step Adam loop saving every step would
        be 200 saves)."""
        return self.checkpoint_every if self.checkpoint_every else default

    @contextlib.contextmanager
    def algo_checkpoint_scope(self, suffix: str):
        """`algo_ckpt_suffix` set to `suffix` inside the block: how the
        engine marks which algorithm instance is training."""
        prev = self.algo_ckpt_suffix
        self.algo_ckpt_suffix = suffix
        try:
            yield
        finally:
            self.algo_ckpt_suffix = prev

    def algorithm_checkpoint_dir(self, algo_name: str) -> Optional[str]:
        """The checkpoint subdirectory of the algorithm tag `algo_name`
        (None without a checkpoint dir), with the instance's suffix."""
        if not self.checkpoint_dir:
            return None
        return os.path.join(self.checkpoint_dir,
                            algo_name + self.algo_ckpt_suffix)

    def algorithm_cache_dir(self, algo_name: str) -> Optional[str]:
        """The on-disk cache of derived training inputs of `algo_name`
        (the ALS bucketing): `fs_basedir()/cache/<algo_name>`, so a train
        in a fresh process over unchanged events hits it.
        `PIO_BUCKET_CACHE=0` disables it (None)."""
        from predictionio_torch.utils.fs import fs_basedir

        if os.environ.get("PIO_BUCKET_CACHE", "1") == "0":
            return None
        return os.path.join(fs_basedir(), "cache", algo_name)

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
                f"events_path={self.events_path!r}, batch={self.batch!r})")
