"""Batch views — snapshots of an app's event stream: the port of
``predictionio_tpu/data/view.py``.

A view is bound to an (app, channel, time window) and offers (a) the raw
ordered event stream, (b) `$set/$unset/$delete`-folded property maps per
entity type, and (c) an ordered per-entity fold for custom aggregations
(the `aggregateByEntityOrdered` of PredictionIO's 0.9.x view layer).

`PBatchView` returns columnar numpy batches (`EventColumns`): integer
coded entity and event ids plus a float property column, ready to go to
a device as tensors. The string → int work happens once, on the host.
"""

from __future__ import annotations

from datetime import datetime
from typing import Callable, Optional, Sequence, TypeVar

import numpy as np

from predictionio_torch.data.bimap import BiMap
from predictionio_torch.data.columnar import SPECIAL_EVENTS as _SPECIAL
from predictionio_torch.data.columnar import EventColumns
from predictionio_torch.data.datamap import PropertyMap, aggregate_properties
from predictionio_torch.data.events import Event
from predictionio_torch.data.store import EventStore

T = TypeVar("T")


def _ordered(events: Sequence[Event]) -> list[Event]:
    return sorted(events,
                  key=lambda e: (e.event_time, e.creation_time,
                                 e.event_id or ""))


class LBatchView:
    """Host-side batch view over one app/channel/time window. The event
    list is fetched once and cached; every aggregation below runs over
    that snapshot."""

    def __init__(
        self,
        app_name: str,
        channel_name: Optional[str] = None,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
        store: Optional[EventStore] = None,
    ):
        self.app_name = app_name
        self.channel_name = channel_name
        self.start_time = start_time
        self.until_time = until_time
        self._store = store or EventStore()
        self._events: Optional[list[Event]] = None

    @property
    def events(self) -> list[Event]:
        """The window's events, ordered by (event_time, creation_time)."""
        if self._events is None:
            self._events = _ordered(
                self._store.find(
                    app_name=self.app_name,
                    channel_name=self.channel_name,
                    start_time=self.start_time,
                    until_time=self.until_time,
                )
            )
        return self._events

    def aggregate_properties(self, entity_type: str) -> dict[str, PropertyMap]:
        """Folded `$set/$unset/$delete` entity state."""
        return aggregate_properties(
            [
                e
                for e in self.events
                if e.entity_type == entity_type and e.event in _SPECIAL
            ]
        )

    def aggregate_by_entity_ordered(
        self,
        predicate: Callable[[Event], bool],
        init: T,
        op: Callable[[T, Event], T],
    ) -> dict[str, T]:
        """Time-ordered per-entity fold of the events matching
        `predicate`: last-N-actions features, transition counts."""
        out: dict[str, T] = {}
        for e in self.events:
            if not predicate(e):
                continue
            out[e.entity_id] = op(out.get(e.entity_id, init), e)
        return out


class PBatchView(LBatchView):
    """Columnar variant of `LBatchView`: dense numpy columns in place of
    the RDDs of PredictionIO's `PBatchView`."""

    def to_columns(
        self,
        event_names: Optional[list[str]] = None,
        value_key: Optional[str] = None,
    ) -> EventColumns:
        """Columnar form of the view's window.

        While the view's event snapshot is unmaterialized, the scan is
        pushed down to the storage backend (`LEvents.find_columnar`: SQL
        id coding or the native reader). Once `self.events` has been
        read, the columns are folded from that cached snapshot instead,
        so they stay coherent with `aggregate_properties` and the other
        folds under concurrent ingestion.
        """
        if self._events is not None:
            from predictionio_torch.data.columnar import columns_from_events

            return columns_from_events(self._events, event_names, value_key)
        return self._store.find_columnar(
            app_name=self.app_name,
            channel_name=self.channel_name,
            start_time=self.start_time,
            until_time=self.until_time,
            event_names=event_names,
            value_key=value_key,
        )

    def property_matrix(
        self, entity_type: str, keys: list[str]
    ) -> tuple[np.ndarray, BiMap]:
        """Dense (n_entities × len(keys)) float32 matrix of folded numeric
        properties (NaN where unset) and the entity BiMap."""
        props = self.aggregate_properties(entity_type)
        bimap = BiMap.string_int(sorted(props))
        mat = np.full((len(bimap), len(keys)), np.nan, np.float32)
        for eid, p in props.items():
            row = bimap[eid]
            for j, k in enumerate(keys):
                v = p.get_opt(k)
                if v is not None:
                    mat[row, j] = float(v)
        return mat, bimap
