"""Event store façade for templates — the port of the reference's
``predictionio_tpu/data/store.py::PEventStore.find_columnar``.

In this slice the event source is a JSON-lines file in the format
`pio export` writes and `pio import` reads (one event object per line, the
event API's wire shape); the file holds one app's events. Storage
backends come in a later slice.
"""

from __future__ import annotations

import json
import logging
from typing import Optional

from predictionio_torch.data.columnar import EventColumns, columns_from_event_dicts

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


class EventStore:
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
        log.info("EventStore: %d of %d events of app %r from %s", len(cols),
                 len(events), app_name, self.events_path)
        return cols


PEventStore = EventStore
