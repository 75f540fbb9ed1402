"""Storage abstraction: env-driven registry + pluggable backends — own
copy of the reference's ``predictionio_tpu/storage``.

Mirrors the reference's «data/.../data/storage/Storage.scala :: Storage»
registry and its repositories (Apps, AccessKeys, Channels, EngineInstances,
EvaluationInstances, Models, LEvents/PEvents) — SURVEY.md §2.2 [U].
"""

from predictionio_torch.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    Model,
    StorageBackend,
)
from predictionio_torch.storage.registry import Storage, StorageConfig

__all__ = [
    "App",
    "AccessKey",
    "Channel",
    "EngineInstance",
    "EvaluationInstance",
    "Model",
    "StorageBackend",
    "Storage",
    "StorageConfig",
]
