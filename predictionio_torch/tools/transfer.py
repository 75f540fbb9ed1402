"""Import/export: JSON-lines event files ↔ event store — the port of the
reference's ``predictionio_tpu/tools/transfer.py``.

The file format is one event JSON object per line, the wire shape of the
event API, so a file exported by either package imports into the other.
The reference's C++ fast paths (its ``native/`` package) are not ported;
the Python path below is the one the reference holds them equal to.
"""

from __future__ import annotations

import json
import logging
from typing import Optional

from predictionio_torch.data.events import (
    Event,
    EventValidationError,
    validate_event,
)
from predictionio_torch.storage.registry import Storage

log = logging.getLogger(__name__)

# events a transaction (one commit per chunk: ~20× the per-row rate)
_CHUNK = 5000


def _resolve_app(storage: Storage, app_name: str,
                 channel_name: Optional[str]) -> tuple[int, Optional[int]]:
    app = storage.meta_apps().get_by_name(app_name)
    if app is None:
        raise ValueError(f"App {app_name!r} does not exist.")
    channel_id = None
    if channel_name:
        channels = {c.name: c
                    for c in storage.meta_channels().get_by_app_id(app.id)}
        if channel_name not in channels:
            raise ValueError(f"Channel {channel_name!r} does not exist for "
                             f"app {app_name!r}.")
        channel_id = channels[channel_name].id
    return app.id, channel_id


def file_to_events(
    input_path: str,
    app_name: str,
    channel_name: Optional[str] = None,
    storage: Optional[Storage] = None,
) -> tuple[int, int]:
    """Import events; returns (imported, skipped). Invalid lines are
    skipped with a warning, matching the reference's tolerant import."""
    storage = storage or Storage.get()
    app_id, channel_id = _resolve_app(storage, app_name, channel_name)
    le = storage.l_events()
    imported = skipped = 0
    batch: list[Event] = []
    with open(input_path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                event = Event.from_dict(json.loads(line))
                validate_event(event)
                # fresh ids: exported files keep eventId for traceability,
                # but ids are store-unique, so re-import must not reuse them
                event.event_id = None
                batch.append(event)
            except (json.JSONDecodeError, EventValidationError, ValueError,
                    TypeError, KeyError) as e:
                skipped += 1
                log.warning("import: skipping line %d: %s", lineno, e)
                continue
            if len(batch) >= _CHUNK:
                imported += len(le.insert_batch(batch, app_id, channel_id))
                batch.clear()
    if batch:
        imported += len(le.insert_batch(batch, app_id, channel_id))
    return imported, skipped


def events_to_file(
    output_path: str,
    app_name: str,
    channel_name: Optional[str] = None,
    storage: Optional[Storage] = None,
) -> int:
    """Export all of an app's events as JSON lines; returns the count."""
    storage = storage or Storage.get()
    app_id, channel_id = _resolve_app(storage, app_name, channel_name)
    events = storage.l_events().find(app_id=app_id, channel_id=channel_id)
    n = 0
    with open(output_path, "w") as f:
        for event in events:
            f.write(json.dumps(event.to_dict()) + "\n")
            n += 1
    return n
