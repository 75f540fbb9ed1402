"""Columnar event batches — own copy of the reference's
``predictionio_tpu/data/columnar.py``: `EventColumns` built from event
JSON objects (the wire shape of the event API and of `pio export` files),
from `Event`s, or from the rows the storage backends code in SQL.

Contract kept from the reference: BiMap codes follow the **sorted** order
of the distinct id strings, and rows keep (event_time, creation_time,
event id) order — the Recommendation Preparator's keep-last dedup relies
on it.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime, timezone
from itertools import chain
from typing import Iterable, Optional, Sequence

import numpy as np

from predictionio_torch.data.bimap import BiMap
from predictionio_torch.data.events import parse_time

SPECIAL_EVENTS = ("$set", "$unset", "$delete")


@dataclasses.dataclass(frozen=True)
class EventColumns:
    """Columnar batch of events: `entity_ids`/`target_ids` int32 codes via
    the attached BiMaps (target −1 when absent), `event_codes` int32 via
    `event_names`, `values` float32 (the chosen property, NaN when
    absent), `times` float64 unix seconds."""

    entity_ids: np.ndarray
    target_ids: np.ndarray
    event_codes: np.ndarray
    values: np.ndarray
    times: np.ndarray
    entity_bimap: BiMap
    target_bimap: BiMap
    event_names: list[str]

    def __len__(self) -> int:
        return int(self.entity_ids.shape[0])


def columns_from_numeric_rows(
    rows: Sequence[tuple],
    entity_uniques: Iterable[str],
    target_uniques: Iterable[str],
    event_names: Sequence[str],
) -> EventColumns:
    """Assemble `EventColumns` from already-coded numeric rows.

    `rows` are `(entity_code, target_code, event_code, value, time)`
    tuples where a missing value is encoded as +inf (JSON cannot encode
    infinity, so the sentinel cannot collide with real property values)
    and a missing target is −1. One flat `np.fromiter` pass keeps the
    Python-per-row cost to tuple iteration only.
    """
    n = len(rows)
    if n:
        flat = np.fromiter(
            chain.from_iterable(rows), dtype=np.float64, count=5 * n
        ).reshape(n, 5)
    else:
        flat = np.empty((0, 5), dtype=np.float64)
    values = flat[:, 3].astype(np.float32)
    values[np.isinf(values)] = np.nan
    return EventColumns(
        entity_ids=flat[:, 0].astype(np.int32),
        target_ids=flat[:, 1].astype(np.int32),
        event_codes=flat[:, 2].astype(np.int32),
        values=values,
        times=flat[:, 4].copy(),
        entity_bimap=BiMap.string_int(entity_uniques),
        target_bimap=BiMap.string_int(target_uniques),
        event_names=list(event_names),
    )


def numeric_or_none(v) -> Optional[float]:
    """Value-property coercion: numbers and bools pass through, numeric
    strings parse, everything else is missing."""
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v)
        except ValueError:
            return None
    return None


def columns_from_event_dicts(
    events: Iterable[dict],
    entity_type: Optional[str] = None,
    target_entity_type: Optional[str] = None,
    event_names: Optional[list] = None,
    value_key: Optional[str] = None,
    ordered: bool = True,
) -> EventColumns:
    """Fold event JSON objects into `EventColumns`, keeping those whose
    entity type, target entity type and event name match the filters."""
    _epoch = datetime(1970, 1, 1, tzinfo=timezone.utc)
    rows = []
    for e in events:
        if entity_type is not None and e.get("entityType") != entity_type:
            continue
        if (target_entity_type is not None
                and e.get("targetEntityType") != target_entity_type):
            continue
        rows.append(e)
    if event_names is None:
        event_names = sorted({e["event"] for e in rows
                              if e["event"] not in SPECIAL_EVENTS})
    wanted = set(event_names)
    rows = [e for e in rows if e["event"] in wanted]
    times = [parse_time(e["eventTime"]) if e.get("eventTime") else _epoch
             for e in rows]
    if ordered:
        created = [parse_time(e["creationTime"]) if e.get("creationTime")
                   else _epoch for e in rows]
        # the event id is the final tiebreak, as in the reference's scans
        order = sorted(range(len(rows)), key=lambda n: (
            times[n], created[n], str(rows[n].get("eventId") or "")))
        rows = [rows[n] for n in order]
        times = [times[n] for n in order]
    entity_uniques = sorted({str(e["entityId"]) for e in rows})
    target_uniques = sorted({str(e["targetEntityId"]) for e in rows
                             if e.get("targetEntityId") is not None})
    e_code = {s: i for i, s in enumerate(entity_uniques)}
    t_code = {s: i for i, s in enumerate(target_uniques)}
    code_of = {name: i for i, name in enumerate(event_names)}
    n = len(rows)
    values = np.full(n, np.nan, np.float32)
    if value_key:
        for i, e in enumerate(rows):
            v = numeric_or_none((e.get("properties") or {}).get(value_key))
            if v is not None:
                values[i] = v
    return EventColumns(
        entity_ids=np.asarray([e_code[str(e["entityId"])] for e in rows],
                              dtype=np.int32),
        target_ids=np.asarray(
            [t_code[str(e["targetEntityId"])]
             if e.get("targetEntityId") is not None else -1 for e in rows],
            dtype=np.int32),
        event_codes=np.asarray([code_of[e["event"]] for e in rows],
                               dtype=np.int32),
        values=values,
        times=np.asarray([t.timestamp() for t in times], dtype=np.float64),
        entity_bimap=BiMap.string_int(entity_uniques),
        target_bimap=BiMap.string_int(target_uniques),
        event_names=list(event_names),
    )


def columns_from_events(
    events,
    event_names: Optional[list] = None,
    value_key: Optional[str] = None,
    ordered: bool = True,
) -> EventColumns:
    """Fold already-materialized `Event` objects into `EventColumns` —
    the generic tier every storage backend shares. Output contract
    matches the pushed-down scans: sorted BiMap codes, (event_time,
    creation_time, id) row order when `ordered`."""
    events = list(events)
    if ordered:
        events.sort(key=lambda e: (e.event_time, e.creation_time,
                                   e.event_id or ""))
    if event_names is None:
        event_names = sorted(
            {e.event for e in events if e.event not in SPECIAL_EVENTS})
    if not event_names:
        return columns_from_numeric_rows([], [], [], [])
    wanted = set(event_names)
    events = [e for e in events if e.event in wanted]
    code_of = {name: i for i, name in enumerate(event_names)}
    entity_uniques = sorted({e.entity_id for e in events})
    target_uniques = sorted(
        {e.target_entity_id for e in events
         if e.target_entity_id is not None})
    e_code = {s: i for i, s in enumerate(entity_uniques)}
    t_code = {s: i for i, s in enumerate(target_uniques)}
    inf = float("inf")
    rows = []
    for e in events:
        v = (numeric_or_none(e.properties.get_opt(value_key))
             if value_key else None)
        rows.append((
            e_code[e.entity_id],
            (t_code[e.target_entity_id]
             if e.target_entity_id is not None else -1),
            code_of[e.event],
            inf if v is None else v,
            e.event_time.timestamp(),
        ))
    return columns_from_numeric_rows(
        rows, entity_uniques, target_uniques, event_names)
