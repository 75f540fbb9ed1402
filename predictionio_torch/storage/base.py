"""Storage data records + backend interface — own copy of the reference's
``predictionio_tpu/storage/base.py``.

Record shapes follow the reference's metadata repos (SURVEY.md §2.2 [U]):
`Apps`, `AccessKeys`, `Channels`, `EngineInstances` (one row per `pio train`,
holding engine params JSON + model key), `EvaluationInstances`, `Models`
(byte-array blobs keyed by engine-instance id), and the `LEvents` event CRUD
surface that the event server and event stores call.
"""

from __future__ import annotations

import abc
import dataclasses
import secrets
from datetime import datetime
from typing import TYPE_CHECKING, Iterable, Optional, Sequence

from predictionio_torch.data.events import Event

if TYPE_CHECKING:
    from predictionio_torch.data.columnar import EventColumns


@dataclasses.dataclass
class App:
    id: int
    name: str
    description: str = ""


@dataclasses.dataclass
class AccessKey:
    key: str
    app_id: int
    events: list[str] = dataclasses.field(default_factory=list)  # empty = all allowed

    @staticmethod
    def generate(app_id: int, events: Optional[list[str]] = None) -> "AccessKey":
        return AccessKey(key=secrets.token_urlsafe(32), app_id=app_id, events=events or [])


@dataclasses.dataclass
class Channel:
    id: int
    name: str
    app_id: int

    NAME_MAX = 16

    @staticmethod
    def is_valid_name(name: str) -> bool:
        return (
            0 < len(name) <= Channel.NAME_MAX
            and name.replace("-", "").replace("_", "").isalnum()
        )


@dataclasses.dataclass
class EngineInstance:
    """One row per `pio train` run (status RUNNING/COMPLETED/FAILED)."""

    id: str
    status: str
    start_time: datetime
    end_time: datetime
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: dict = dataclasses.field(default_factory=dict)
    data_source_params: str = "{}"
    preparator_params: str = "{}"
    algorithms_params: str = "[]"
    serving_params: str = "{}"


@dataclasses.dataclass
class EvaluationInstance:
    id: str
    status: str
    start_time: datetime
    end_time: datetime
    evaluation_class: str
    engine_params_generator_class: str
    batch: str = ""
    env: dict = dataclasses.field(default_factory=dict)
    evaluator_results: str = ""  # human-readable summary
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""


@dataclasses.dataclass
class Model:
    """Serialized model blob keyed by engine-instance id."""

    id: str
    models: bytes


class Apps(abc.ABC):
    @abc.abstractmethod
    def insert(self, app: App) -> Optional[int]: ...

    @abc.abstractmethod
    def get(self, app_id: int) -> Optional[App]: ...

    @abc.abstractmethod
    def get_by_name(self, name: str) -> Optional[App]: ...

    @abc.abstractmethod
    def get_all(self) -> list[App]: ...

    @abc.abstractmethod
    def update(self, app: App) -> bool: ...

    @abc.abstractmethod
    def delete(self, app_id: int) -> bool: ...


class AccessKeys(abc.ABC):
    @abc.abstractmethod
    def insert(self, access_key: AccessKey) -> Optional[str]: ...

    @abc.abstractmethod
    def get(self, key: str) -> Optional[AccessKey]: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> list[AccessKey]: ...

    @abc.abstractmethod
    def delete(self, key: str) -> bool: ...


class Channels(abc.ABC):
    @abc.abstractmethod
    def insert(self, channel: Channel) -> Optional[int]: ...

    @abc.abstractmethod
    def get(self, channel_id: int) -> Optional[Channel]: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> list[Channel]: ...

    @abc.abstractmethod
    def delete(self, channel_id: int) -> bool: ...


class EngineInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, instance: EngineInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> list[EngineInstance]: ...

    @abc.abstractmethod
    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def update(self, instance: EngineInstance) -> None: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...


class EvaluationInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, instance: EvaluationInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_completed(self) -> list[EvaluationInstance]: ...

    @abc.abstractmethod
    def update(self, instance: EvaluationInstance) -> None: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...


class Models(abc.ABC):
    @abc.abstractmethod
    def insert(self, model: Model) -> None: ...

    @abc.abstractmethod
    def get(self, model_id: str) -> Optional[Model]: ...

    @abc.abstractmethod
    def delete(self, model_id: str) -> bool: ...


class LEvents(abc.ABC):
    """Event CRUD. `channel_id=None` addresses an app's default channel."""

    # duplicate-key exception classes of the underlying store, for callers
    # that map uniqueness violations to user errors (the event API's
    # duplicate-eventId 400). Backends override; () catches nothing.
    integrity_errors: tuple = ()

    @abc.abstractmethod
    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool: ...

    @abc.abstractmethod
    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool: ...

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str: ...

    def insert_batch(
        self, events: "list[Event]", app_id: int,
        channel_id: Optional[int] = None,
    ) -> list[str]:
        """Bulk insert. Default: per-event loop; backends override with a
        single-transaction fast path (bulk import is 20×+ faster there).

        No atomicity guarantee at this interface: the default commits
        per event (a mid-batch failure leaves earlier events stored),
        while the SQLite/Postgres overrides are all-or-nothing. Callers
        needing exactness should treat a raised exception as "re-import
        this file/chunk after fixing the cause"."""
        return [self.insert(e, app_id, channel_id) for e in events]

    def insert_grouped(
        self, items: "list[tuple[Event, int, Optional[int]]]",
    ) -> list[str]:
        """Group-commit insert: heterogeneous (event, app_id, channel_id)
        rows — coalesced from CONCURRENT single-event requests by the
        reference's ingest write plane (predictionio_tpu/ingest) — made durable
        together. Backends override with one shared transaction so N
        front-door inserts pay one fsync; this default loops `insert`
        (commits per item, no atomicity) so every backend stays correct.

        The write plane acknowledges each caller's 201 only after this
        returns, so an override MUST NOT return before its transaction
        is committed."""
        return [self.insert(e, a, c) for e, a, c in items]

    @abc.abstractmethod
    def get(
        self, event_id: str, app_id: int, channel_id: Optional[int] = None
    ) -> Optional[Event]: ...

    @abc.abstractmethod
    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool: ...

    @abc.abstractmethod
    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str | Sequence[str]] = None,
        event_names: Optional[list[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str | Sequence[str]] = None,
        limit: Optional[int] = None,
        reversed: bool = False,
    ) -> Iterable[Event]:
        """Entity filters accept one id or a sequence of ids (an
        IN-style batch lookup; an empty sequence matches nothing)."""
        ...

    def aggregate_properties_columnar(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
        entity_type: Optional[str] = None,
        required: Optional[list] = None,
    ):
        """Pushed-down `$set/$unset/$delete` fold. Returns
        dict[entity_id, (fields_dict, first_updated, last_updated)], or
        None meaning "no pushdown here — use the per-event Python fold"
        (the default for backends without a SQL pushdown; see
        `storage/sqlite.py` for the real implementation and
        `data/store.py::EventStore.aggregate_properties` for the
        fallback chain)."""
        return None

    def find_columnar(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
        entity_type: Optional[str] = None,
        target_entity_type: Optional[str] = None,
        event_names: Optional[list[str]] = None,
        value_key: Optional[str] = None,
        ordered: bool = True,
    ) -> "EventColumns":
        """Bulk columnar scan: integer-coded entity/target/event columns +
        one numeric property column, no per-event Python objects (the
        reference's HBase `TableInputFormat` scan role — SURVEY.md §2.2
        [U]). Default implementation folds over `find()` so every backend
        has the interface; SQL backends override with a pushed-down query
        (see `storage/sqlite.py`). BiMap codes are assigned in sorted
        order of the distinct ids on every path.
        """
        from predictionio_torch.data.columnar import (
            columns_from_events,
            columns_from_numeric_rows,
        )

        if event_names is not None and not event_names:
            # explicit empty filter selects nothing (the find() layers
            # treat [] as "no filter" — that must not leak special events
            # into a columnar scan)
            return columns_from_numeric_rows([], [], [], [])
        events = self.find(
            app_id=app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            target_entity_type=target_entity_type,
            event_names=event_names,
        )
        return columns_from_events(events, event_names, value_key, ordered)


class StorageBackend(abc.ABC):
    """A storage source providing all repositories (the reference wires these
    per-repository via PIO_STORAGE_REPOSITORIES_*; so do we — see registry)."""

    @abc.abstractmethod
    def apps(self) -> Apps: ...

    @abc.abstractmethod
    def access_keys(self) -> AccessKeys: ...

    @abc.abstractmethod
    def channels(self) -> Channels: ...

    @abc.abstractmethod
    def engine_instances(self) -> EngineInstances: ...

    @abc.abstractmethod
    def evaluation_instances(self) -> EvaluationInstances: ...

    @abc.abstractmethod
    def models(self) -> Models: ...

    @abc.abstractmethod
    def events(self) -> LEvents: ...

    def close(self) -> None:
        pass
