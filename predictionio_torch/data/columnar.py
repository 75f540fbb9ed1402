"""Columnar event batches — own copy of the reference's
``predictionio_tpu/data/columnar.py::EventColumns``, built from event
JSON objects (the wire shape of the event API and of `pio export` files).

Contract kept from the reference: BiMap codes follow the **sorted** order
of the distinct id strings, and rows keep (event_time, creation_time,
event id) order — the Recommendation Preparator's keep-last dedup relies
on it.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime, timezone
from typing import Any, Iterable, Optional

import numpy as np

from predictionio_torch.data.bimap import BiMap

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


def parse_time(value: Any) -> datetime:
    """ISO-8601 ('Z' suffix allowed) → aware datetime (UTC when naive)."""
    s = str(value).strip()
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    dt = datetime.fromisoformat(s)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt


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
