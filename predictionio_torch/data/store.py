"""Event store façade for templates — the port of the reference's
``predictionio_tpu/data/store.py``.

`EventStore` (spelled `PEventStore` for training reads and `LEventStore`
for serving-time lookups, as in the reference) reads one app's events
out of storage (`storage.Storage`: `pio.db` unless PIO_STORAGE_* says
otherwise). `EventFileStore` reads a JSON-lines events file in the format
`pio export` writes and `pio import` reads (one event object per line,
the event API's wire shape) that holds one app's events; the console's
`--events` flag trains and evaluates from such a file.
"""

from __future__ import annotations

import json
import logging
from datetime import datetime
from typing import Optional

from predictionio_torch.data.columnar import EventColumns, columns_from_event_dicts
from predictionio_torch.data.datamap import PropertyMap, aggregate_properties
from predictionio_torch.data.events import Event
from predictionio_torch.storage.registry import Storage

log = logging.getLogger(__name__)


def read_event_file(path: str) -> list[dict]:
    """Event objects of a JSON-lines file; lines that are not JSON objects
    are skipped with a warning, as the reference's import does."""
    events = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
            except json.JSONDecodeError as e:
                log.warning("events file %s: skipping line %d: %s", path,
                            lineno, e)
                continue
            if not isinstance(event, dict) or "event" not in event \
                    or "entityId" not in event:
                log.warning("events file %s: skipping line %d: not an "
                            "event object", path, lineno)
                continue
            events.append(event)
    return events


class EventFileStore:
    """Training reads over one app's JSON-lines events file."""

    def __init__(self, events_path: str):
        self.events_path = events_path

    def find_columnar(
        self,
        app_name: str = "",
        entity_type: Optional[str] = None,
        target_entity_type: Optional[str] = None,
        event_names: Optional[list[str]] = None,
        value_key: Optional[str] = None,
        ordered: bool = True,
    ) -> EventColumns:
        """Integer-coded columns of the matching events (sorted BiMap
        codes; event-time row order when `ordered`). `app_name` names the
        app the file was exported from, for the log only."""
        events = read_event_file(self.events_path)
        cols = columns_from_event_dicts(
            events, entity_type=entity_type,
            target_entity_type=target_entity_type, event_names=event_names,
            value_key=value_key, ordered=ordered)
        log.info("EventFileStore: %d of %d events of app %r from %s", len(cols),
                 len(events), app_name, self.events_path)
        return cols


class EventStore:
    """Training reads and serving-time lookups over the event store
    (`storage.Storage`), by app name."""

    def __init__(self, storage: Optional[Storage] = None):
        self._storage = storage

    def _resolve(self, app_name: str, channel_name: Optional[str]):
        storage = self._storage or Storage.get()
        app = storage.meta_apps().get_by_name(app_name)
        if app is None:
            raise ValueError(f"Invalid app name {app_name!r}")
        channel_id = None
        if channel_name is not None:
            channels = {c.name: c for c in storage.meta_channels().get_by_app_id(app.id)}
            if channel_name not in channels:
                raise ValueError(f"Invalid channel name {channel_name!r} for app {app_name!r}")
            channel_id = channels[channel_name].id
        return storage, app.id, channel_id

    def find(
        self,
        app_name: str,
        channel_name: Optional[str] = None,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[list[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        limit: Optional[int] = None,
        reversed: bool = False,
    ) -> list[Event]:
        storage, app_id, channel_id = self._resolve(app_name, channel_name)
        return list(
            storage.l_events().find(
                app_id=app_id,
                channel_id=channel_id,
                start_time=start_time,
                until_time=until_time,
                entity_type=entity_type,
                entity_id=entity_id,
                event_names=event_names,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id,
                limit=limit,
                reversed=reversed,
            )
        )

    def find_by_entity(
        self,
        app_name: str,
        entity_type: str,
        entity_id: str,
        channel_name: Optional[str] = None,
        event_names: Optional[list[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
        limit: Optional[int] = None,
        latest: bool = True,
    ) -> list[Event]:
        """Serving-time lookup (`LEventStore.findByEntity` [U]) — the E-Comm
        template calls this on the query hot path (SURVEY.md §3.2)."""
        return self.find(
            app_name=app_name,
            channel_name=channel_name,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            entity_id=entity_id,
            event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
            limit=limit,
            reversed=latest,
        )

    def find_columnar(
        self,
        app_name: str,
        channel_name: Optional[str] = None,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
        entity_type: Optional[str] = None,
        target_entity_type: Optional[str] = None,
        event_names: Optional[list[str]] = None,
        value_key: Optional[str] = None,
        ordered: bool = True,
    ):
        """Bulk columnar training read — integer-coded numpy columns, no
        per-event Python objects (see
        `storage/base.py::LEvents.find_columnar`). `ordered=False` skips
        the output time-sort for order-invariant consumers (ALS).
        """
        storage, app_id, channel_id = self._resolve(app_name, channel_name)
        return storage.l_events().find_columnar(
            app_id=app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            target_entity_type=target_entity_type,
            event_names=event_names,
            value_key=value_key,
            ordered=ordered,
        )

    def aggregate_properties(
        self,
        app_name: str,
        entity_type: str,
        channel_name: Optional[str] = None,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
        required: Optional[list[str]] = None,
    ) -> dict[str, PropertyMap]:
        """`$set/$unset/$delete`-folded entity state (`aggregateProperties` [U]).

        Reads through the pushed-down columnar fold when the backend has
        one (on sqlite the C++ reader of `native/pio_aggprops.cpp`, then
        the SQL tier in `storage/sqlite.py`; no per-event Python
        object). A backend without it (its `aggregate_properties_columnar`
        returns None) takes the per-event
        `data/datamap.py::aggregate_properties` fold, which is the
        semantics oracle the pushdown is tested against."""
        storage, app_id, channel_id = self._resolve(app_name, channel_name)
        agg = storage.l_events().aggregate_properties_columnar(
            app_id=app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            required=list(required) if required else None,
        )
        if agg is not None:
            return {
                eid: PropertyMap(fields, first_updated=first, last_updated=last)
                for eid, (fields, first, last) in agg.items()
            }
        events = self.find(
            app_name=app_name,
            channel_name=channel_name,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            event_names=["$set", "$unset", "$delete"],
        )
        props = aggregate_properties(events)
        if required:
            props = {
                eid: p for eid, p in props.items() if all(k in p for k in required)
            }
        return props


PEventStore = EventStore
LEventStore = EventStore
