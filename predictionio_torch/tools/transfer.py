"""Import/export: JSON-lines event files ↔ event store — the port of the
reference's ``predictionio_tpu/tools/transfer.py``.

The file format is one event JSON object per line, the wire shape of the
event API, so a file exported by either package imports into the other.
On a sqlite file store both directions try the C++ fast paths first
(``predictionio_torch/native``: ``pio_import.cpp``, ``pio_export.cpp``),
as the reference does; the Python path below is the one they are held
equal to, and the fallback when they are unavailable or bail.
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


def _native_sqlite_backend(storage: Storage):
    """The event store's SQLiteBackend when the C++ fast paths apply,
    else None. Exact type check: a dialect subclass would share the
    class but not the db file."""
    from predictionio_torch.storage.sqlite import SQLiteBackend

    backend = storage._backend(storage.config.eventdata)
    if type(backend) is not SQLiteBackend or backend.path == ":memory:":
        return None
    return backend


def _native_import(storage: Storage, input_path: str, app_id: int,
                   channel_id: Optional[int]) -> Optional[tuple[int, int]]:
    """C++ fast path (native/pio_import.cpp): parse + insert straight into
    the sqlite store; lines the parser can't render Python-identically
    come back as line numbers and go through the Python path below.
    Returns None when inapplicable (non-sqlite-file store, no toolchain,
    hard failure) — the caller then runs the Python path for everything."""
    from predictionio_torch import native

    backend = _native_sqlite_backend(storage)
    if backend is None:
        return None
    res = native.import_events_native(input_path, backend.path, app_id,
                                      channel_id)
    if res is None:
        return None
    imported, skipped, fallback_lines, resume_from = res
    want = set(fallback_lines)
    if want or resume_from:
        if want:
            log.info("import: %d line(s) use constructs outside the "
                     "native fast path; processing them in Python",
                     len(want))
        if resume_from:
            log.warning("import: native path stopped mid-file; resuming "
                        "from line %d in Python", resume_from)
        more, more_skipped = _python_import(
            storage, input_path, app_id, channel_id,
            lambda lineno: lineno in want or 0 < resume_from <= lineno)
        imported += more
        skipped += more_skipped
    return imported, skipped


def _python_import(storage: Storage, input_path: str, app_id: int,
                   channel_id: Optional[int],
                   wanted=None) -> tuple[int, int]:
    """The Python path over the file's lines (those whose 1-based number
    `wanted` accepts, every line without it); returns (imported,
    skipped)."""
    le = storage.l_events()
    imported = skipped = 0
    batch: list[Event] = []
    with open(input_path) as f:
        for lineno, line in enumerate(f, 1):
            if wanted is not None and not wanted(lineno):
                continue
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
    native_result = _native_import(storage, input_path, app_id, channel_id)
    if native_result is not None:
        return native_result
    return _python_import(storage, input_path, app_id, channel_id)


def _native_export(storage: Storage, output_path: str, app_id: int,
                   channel_id: Optional[int]) -> Optional[int]:
    """C++ fast path (native/pio_export.cpp): stream sqlite rows straight
    to JSON lines, byte-identical to the Python path for rows this
    framework wrote. All-or-nothing: returns None when inapplicable or
    when the writer bailed (it removes its partial file), and the caller
    runs the Python path."""
    from predictionio_torch import native

    backend = _native_sqlite_backend(storage)
    if backend is None:
        return None
    return native.export_events_native(backend.path, output_path, app_id,
                                       channel_id)


def events_to_file(
    output_path: str,
    app_name: str,
    channel_name: Optional[str] = None,
    storage: Optional[Storage] = None,
) -> int:
    """Export all of an app's events as JSON lines; returns the count.
    SQLite file stores stream through the C++ writer (O(1) memory, where
    `find()` materialises every row as an Event); other stores take the
    Python path."""
    storage = storage or Storage.get()
    app_id, channel_id = _resolve_app(storage, app_name, channel_name)
    native_count = _native_export(storage, output_path, app_id, channel_id)
    if native_count is not None:
        return native_count
    events = storage.l_events().find(app_id=app_id, channel_id=channel_id)
    n = 0
    with open(output_path, "w") as f:
        for event in events:
            f.write(json.dumps(event.to_dict()) + "\n")
            n += 1
    return n
