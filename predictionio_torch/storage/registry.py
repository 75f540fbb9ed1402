"""Env-driven storage registry — own copy of the reference's
``predictionio_tpu/storage/registry.py``.

Parity with «data/.../data/storage/Storage.scala :: Storage» (SURVEY.md §2.2
[U]): the reference parses ``PIO_STORAGE_REPOSITORIES_{METADATA,MODELDATA,
EVENTDATA}_{NAME,SOURCE}`` and ``PIO_STORAGE_SOURCES_<SRC>_{TYPE,...}`` from
`pio-env.sh` and reflectively loads backend clients. We keep the same env
contract with backend types ``sqlite`` (PATH = db file), ``memory``, and
``localfs`` (PATH = model-blob dir, models-only); `register_backend` adds
custom types. The reference's ``postgres`` type (which needs a
PostgreSQL client library the port does not depend on) and its ``s3``
type are not ported. The repository split lets metadata/events/models live in
different sources, exactly like the reference's HBase-events + ES-metadata
+ localfs-models deployments. The event and model repositories are timed
into `storage_op_seconds{repo,op}` (`_TimedRepo`), which a deployed
server's `/metrics` renders; the reference also attributes each call to
the calling request's span timeline, which the port does not have.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Optional

from predictionio_torch.storage import base
from predictionio_torch.storage.sqlite import SQLiteBackend
from predictionio_torch.telemetry.registry import REGISTRY

log = logging.getLogger(__name__)

_REPOSITORIES = ("METADATA", "MODELDATA", "EVENTDATA")

STORAGE_OP_SECONDS = REGISTRY.histogram(
    "storage_op_seconds", "Storage backend operation latency in seconds",
    labelnames=("repo", "op"))


class _TimedRepo:
    """Transparent proxy timing a repo's data-path methods into
    `storage_op_seconds{repo,op}`. Non-listed attributes (including
    `integrity_errors`, used in `except` clauses) delegate untouched."""

    _TIMED_OPS = frozenset({
        "insert", "insert_batch", "insert_grouped", "get", "find", "delete",
        "find_columnar", "aggregate_properties_columnar",
        "get_latest_completed", "get_completed", "get_all", "update",
    })

    __slots__ = ("_repo", "_label")

    def __init__(self, repo, label: str):
        object.__setattr__(self, "_repo", repo)
        object.__setattr__(self, "_label", label)

    def __getattr__(self, name):
        attr = getattr(self._repo, name)
        if name not in self._TIMED_OPS or not callable(attr):
            return attr
        timer = STORAGE_OP_SECONDS.labels(repo=self._label, op=name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return attr(*args, **kwargs)
            finally:
                timer.observe(time.perf_counter() - t0)

        return timed


def _make_sqlite(source: "SourceConfig") -> base.StorageBackend:
    os.makedirs(os.path.dirname(source.path) or ".", exist_ok=True)
    return SQLiteBackend(source.path)


def _make_memory(source: "SourceConfig") -> base.StorageBackend:
    return SQLiteBackend(":memory:")


def _make_localfs(source: "SourceConfig") -> base.StorageBackend:
    from predictionio_torch.storage.localfs import LocalFSBackend

    return LocalFSBackend(source.path)


# type name → factory(SourceConfig) — the reflective-client-load analogue
# of the reference's Storage.scala; third-party backends register here
BACKEND_TYPES: dict = {
    "sqlite": _make_sqlite,
    "memory": _make_memory,
    "localfs": _make_localfs,
}


def register_backend(type_name: str, factory) -> None:
    """Register a custom storage backend type (factory: SourceConfig →
    StorageBackend). Mirrors the reference's pluggable backend loading."""
    BACKEND_TYPES[type_name] = factory


@dataclasses.dataclass
class SourceConfig:
    name: str
    type: str  # a BACKEND_TYPES key: "sqlite" | "memory" | "localfs" | custom
    path: str = ""  # sqlite db file / localfs model dir


@dataclasses.dataclass
class StorageConfig:
    """Resolved repository → source wiring."""

    metadata: SourceConfig
    modeldata: SourceConfig
    eventdata: SourceConfig

    @classmethod
    def from_env(cls, env: Optional[dict] = None) -> "StorageConfig":
        env = dict(os.environ if env is None else env)
        from predictionio_torch.utils.fs import fs_basedir

        default_path = fs_basedir(env)

        def source_for(repo: str) -> SourceConfig:
            src = env.get(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "PIO_DEFAULT")
            stype = env.get(f"PIO_STORAGE_SOURCES_{src}_TYPE", "sqlite")
            default = (os.path.join(default_path, "models")
                       if stype == "localfs"
                       else os.path.join(default_path, "pio.db"))
            spath = env.get(f"PIO_STORAGE_SOURCES_{src}_PATH", default)
            if stype not in BACKEND_TYPES:
                raise ValueError(
                    f"Unsupported storage source type {stype!r} for {src} "
                    f"(supported: {', '.join(sorted(BACKEND_TYPES))})"
                )
            return SourceConfig(name=src, type=stype, path=spath)

        return cls(
            metadata=source_for("METADATA"),
            modeldata=source_for("MODELDATA"),
            eventdata=source_for("EVENTDATA"),
        )


class Storage:
    """Process-wide storage access, one backend instance per distinct source.

    Mirrors the reference `Storage` object's accessors: `getMetaDataApps`,
    `getLEvents`, `getModelDataModels`, `verifyAllDataObjects`, ... [U].
    """

    _lock = threading.RLock()
    _instance: Optional["Storage"] = None

    def __init__(self, config: Optional[StorageConfig] = None):
        self.config = config or StorageConfig.from_env()
        self._backends: dict[tuple[str, str, str], base.StorageBackend] = {}

    # -- singleton wiring (CLI / servers); tests construct directly --------
    @classmethod
    def get(cls) -> "Storage":
        with cls._lock:
            if cls._instance is None:
                cls._instance = Storage()
            return cls._instance

    @classmethod
    def reset(cls, storage: Optional["Storage"] = None) -> None:
        with cls._lock:
            cls._instance = storage

    def _backend(self, source: SourceConfig) -> base.StorageBackend:
        # sqlite sources sharing a db file share one backend (path in the
        # key); distinct custom sources stay distinct even on a shared
        # path (name in the key); memory sources are per-name by design
        key = (source.type, source.name, source.path)
        if source.type == "sqlite":
            key = (source.type, "", source.path)
        with self._lock:
            backend = self._backends.get(key)
            if backend is None:
                try:
                    factory = BACKEND_TYPES[source.type]
                except KeyError:
                    raise ValueError(
                        f"Unsupported storage source type {source.type!r} "
                        f"(supported: {', '.join(sorted(BACKEND_TYPES))})"
                    ) from None
                backend = factory(source)
                self._backends[key] = backend
            return backend

    # -- metadata ----------------------------------------------------------
    def meta_apps(self) -> base.Apps:
        return self._backend(self.config.metadata).apps()

    def meta_access_keys(self) -> base.AccessKeys:
        return self._backend(self.config.metadata).access_keys()

    def meta_channels(self) -> base.Channels:
        return self._backend(self.config.metadata).channels()

    def meta_engine_instances(self) -> base.EngineInstances:
        return self._backend(self.config.metadata).engine_instances()

    def meta_evaluation_instances(self) -> base.EvaluationInstances:
        return self._backend(self.config.metadata).evaluation_instances()

    # -- model / event data ------------------------------------------------
    # The hot data paths (event find/insert, model blob read/write) are
    # served through _TimedRepo so every backend round trip lands in
    # storage_op_seconds; metadata CRUD is cold-path and left bare.
    def model_data_models(self) -> base.Models:
        return _TimedRepo(self._backend(self.config.modeldata).models(),
                          "models")

    def l_events(self) -> base.LEvents:
        return _TimedRepo(self._backend(self.config.eventdata).events(),
                          "l_events")

    # -- health ------------------------------------------------------------
    def verify_all_data_objects(self) -> dict[str, bool]:
        """`pio status`-style storage connectivity check."""
        results = {}
        for name, fn in (
            ("metadata.apps", self.meta_apps),
            ("metadata.access_keys", self.meta_access_keys),
            ("metadata.channels", self.meta_channels),
            ("metadata.engine_instances", self.meta_engine_instances),
            ("metadata.evaluation_instances", self.meta_evaluation_instances),
            ("modeldata.models", self.model_data_models),
            ("eventdata.events", self.l_events),
        ):
            try:
                fn()
                results[name] = True
            except Exception as e:
                # surface WHY: a bare FAILED line hides actionable
                # config errors
                log.warning("storage check %s failed: %s", name, e)
                results[name] = False
        return results

    def close(self) -> None:
        with self._lock:
            for backend in self._backends.values():
                backend.close()
            self._backends.clear()
