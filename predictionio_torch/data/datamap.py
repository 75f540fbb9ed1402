"""DataMap / PropertyMap: JSON-backed property bags with `$set`/`$unset`/`$delete`
aggregation semantics — own copy of the reference's
``predictionio_tpu/data/datamap.py``.

Capability parity with the reference's `DataMap.scala` / `PropertyMap.scala`
(«data/.../data/storage/DataMap.scala :: DataMap», unverified — mount empty;
see SURVEY.md §2.2). The aggregation rules are the subtle part the
Classification and E-Commerce templates depend on (SURVEY.md §7.3):

- events are folded in ascending `event_time` order;
- ``$set`` creates/updates keys (later sets win per-key);
- ``$unset`` removes the named keys (its property *names* select what to drop);
- ``$delete`` removes the entity entirely — a later ``$set`` recreates it with
  a fresh ``first_updated``.
"""

from __future__ import annotations

import json
from collections.abc import Iterable, Mapping
from datetime import datetime
from typing import Any, Iterator, Optional, Sequence, TypeVar

T = TypeVar("T")


class DataMapError(KeyError):
    """Raised when a required field is missing or has the wrong shape."""


class DataMap(Mapping):
    """An immutable-by-convention JSON property bag with typed accessors."""

    __slots__ = ("_fields",)

    def __init__(self, fields: Optional[Mapping[str, Any]] = None):
        self._fields: dict[str, Any] = dict(fields or {})

    # -- typed accessors ---------------------------------------------------
    def require(self, name: str, cls: Optional[type] = None) -> Any:
        if name not in self._fields:
            raise DataMapError(f"The field {name} is required.")
        value = self._fields[name]
        if cls is not None and value is not None and not isinstance(value, cls):
            # int→float promotion is the one coercion JSON round-trips need
            if cls is float and isinstance(value, int):
                return float(value)
            raise DataMapError(
                f"Field {name} has type {type(value).__name__}, expected {cls.__name__}."
            )
        return value

    def get_opt(self, name: str, cls: Optional[type] = None) -> Optional[Any]:
        if name not in self._fields or self._fields[name] is None:
            return None
        return self.require(name, cls)

    def get_or_else(self, name: str, default: T) -> T:
        value = self.get_opt(name)
        return default if value is None else value

    def get_string_list(self, name: str) -> list[str]:
        value = self.require(name)
        if not isinstance(value, list) or not all(isinstance(x, str) for x in value):
            raise DataMapError(f"Field {name} is not a list of strings.")
        return value

    def get_double_list(self, name: str) -> list[float]:
        value = self.require(name)
        if not isinstance(value, list):
            raise DataMapError(f"Field {name} is not a list.")
        return [float(x) for x in value]

    # -- Mapping protocol --------------------------------------------------
    def __getitem__(self, name: str) -> Any:
        return self._fields[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, name: object) -> bool:
        return name in self._fields

    def keyset(self) -> set[str]:
        return set(self._fields)

    @property
    def is_empty(self) -> bool:
        return not self._fields

    # -- transforms --------------------------------------------------------
    def merge(self, other: "DataMap") -> "DataMap":
        """Right-biased merge (``other`` wins on key conflicts)."""
        merged = dict(self._fields)
        merged.update(other._fields)
        return DataMap(merged)

    def drop(self, keys: Iterable[str]) -> "DataMap":
        drop_set = set(keys)
        return DataMap({k: v for k, v in self._fields.items() if k not in drop_set})

    # -- serde -------------------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return dict(self._fields)

    def to_json(self) -> str:
        return json.dumps(self._fields, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "DataMap":
        obj = json.loads(s)
        if not isinstance(obj, dict):
            raise DataMapError("DataMap JSON must be an object.")
        return cls(obj)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, DataMap) and self._fields == other._fields

    def __hash__(self) -> int:  # usable as dict key in tests
        return hash(self.to_json())

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"


class PropertyMap(DataMap):
    """A DataMap aggregated from ``$set``/``$unset``/``$delete`` events, plus
    the entity's first/last update times."""

    __slots__ = ("first_updated", "last_updated")

    def __init__(
        self,
        fields: Optional[Mapping[str, Any]] = None,
        first_updated: Optional[datetime] = None,
        last_updated: Optional[datetime] = None,
    ):
        super().__init__(fields)
        if first_updated is None or last_updated is None:
            raise ValueError("PropertyMap requires first_updated and last_updated.")
        self.first_updated = first_updated
        self.last_updated = last_updated

    def __repr__(self) -> str:
        return (
            f"PropertyMap({self.to_dict()!r}, first_updated={self.first_updated}, "
            f"last_updated={self.last_updated})"
        )


def aggregate_properties(events: Sequence) -> dict[str, PropertyMap]:
    """Fold special events into per-entity PropertyMaps.

    ``events`` are `Event`s of a single entity_type (any order; sorted here by
    (event_time, creation_time, event_id) ascending — the unique id as
    final tiebreak, so exact-timestamp ties resolve identically to the
    SQL window and C++ pushdown tiers regardless of input order).
    Parity target:
    «data/.../storage/PropertyMap.scala» + `LEvents.aggregateProperties` [U].
    """
    # Local import to avoid a cycle at module load.
    from predictionio_torch.data.events import Event  # noqa: F401

    state: dict[str, dict[str, Any]] = {}
    first: dict[str, datetime] = {}
    last: dict[str, datetime] = {}

    def sort_key(e):
        return (e.event_time, e.creation_time, e.event_id or "")

    for e in sorted(events, key=sort_key):
        eid = e.entity_id
        if e.event == "$set":
            if eid not in state:
                state[eid] = {}
                first[eid] = e.event_time
            state[eid].update(e.properties.to_dict())
            last[eid] = e.event_time
        elif e.event == "$unset":
            if eid in state:
                for k in e.properties.keyset():
                    state[eid].pop(k, None)
                last[eid] = e.event_time
        elif e.event == "$delete":
            state.pop(eid, None)
            first.pop(eid, None)
            last.pop(eid, None)
        # non-special events do not affect properties

    return {
        eid: PropertyMap(fields, first_updated=first[eid], last_updated=last[eid])
        for eid, fields in state.items()
    }
