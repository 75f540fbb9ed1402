"""The port's batch views (`data/view.py`): the reference's
tests/test_view.py on the port's storage, the same folds as the
reference's views over the same events, and the `PBatchView.to_columns`
snapshot case of the reference's tests/test_columnar.py."""

from datetime import datetime, timedelta, timezone

import numpy as np

from predictionio_tpu.data.datamap import DataMap as RefDataMap
from predictionio_tpu.data.events import Event as RefEvent
from predictionio_tpu.data.view import (
    LBatchView as RefLBatchView,
    PBatchView as RefPBatchView,
)
from predictionio_tpu.storage.base import App as RefApp
from predictionio_torch.data.datamap import DataMap
from predictionio_torch.data.events import Event
from predictionio_torch.data.store import EventStore
from predictionio_torch.data.view import LBatchView, PBatchView
from predictionio_torch.storage.base import App
from tests.test_torch_similarproduct import port_storage  # noqa: F401


def ts(h, m=0):
    return datetime(2026, 1, 1, h, m, 0, tzinfo=timezone.utc)


ROWS = [
    # (event, entity, target or None, properties, hour)
    ("$set", "u1", None, {"plan": "free", "age": 30}, 1),
    ("$set", "u1", None, {"plan": "pro"}, 2),
    ("$unset", "u1", None, {"age": None}, 3),
    ("$set", "u2", None, {"plan": "free", "age": 22}, 2),
    ("rate", "u1", "i1", {"rating": 4.0}, 4),
    ("rate", "u2", "i2", {"rating": 3.0}, 5),
    ("view", "u1", "i2", {}, 6),
    ("rate", "u1", "i2", {"rating": 5.0}, 7),
]


def _seed(storage, port=True, name="ViewApp"):
    event_cls, app_cls, datamap = ((Event, App, DataMap) if port
                                   else (RefEvent, RefApp, RefDataMap))
    app_id = storage.meta_apps().insert(app_cls(id=0, name=name))
    events = storage.l_events()
    for event, entity, target, props, hour in ROWS:
        events.insert(event_cls(
            event=event, entity_type="user", entity_id=entity,
            target_entity_type="item" if target else None,
            target_entity_id=target, properties=datamap(props),
            event_time=ts(hour)), app_id)
    return app_id


class TestLBatchView:
    def test_events_ordered_and_windowed(self, port_storage):
        _seed(port_storage)
        view = LBatchView("ViewApp")
        assert [e.event_time for e in view.events] == sorted(
            e.event_time for e in view.events)
        assert len(view.events) == 8
        windowed = LBatchView("ViewApp", start_time=ts(4), until_time=ts(6))
        assert [e.event for e in windowed.events] == ["rate", "rate"]

    def test_aggregate_properties(self, port_storage):
        _seed(port_storage)
        props = LBatchView("ViewApp").aggregate_properties("user")
        assert props["u1"].to_dict() == {"plan": "pro"}  # age $unset
        assert props["u2"].to_dict() == {"plan": "free", "age": 22}

    def test_aggregate_by_entity_ordered(self, port_storage):
        _seed(port_storage)
        view = LBatchView("ViewApp")
        # last-rated item per user: order matters (u1 rated i1 then i2)
        last = view.aggregate_by_entity_ordered(
            lambda e: e.event == "rate", None,
            lambda _, e: e.target_entity_id)
        assert last == {"u1": "i2", "u2": "i2"}
        counts = view.aggregate_by_entity_ordered(
            lambda e: e.event in ("rate", "view"), 0, lambda acc, _: acc + 1)
        assert counts == {"u1": 3, "u2": 1}


class TestPBatchView:
    def test_to_columns(self, port_storage):
        _seed(port_storage)
        cols = PBatchView("ViewApp").to_columns(value_key="rating")
        # special events excluded; the default event vocabulary sorted
        assert cols.event_names == ["rate", "view"]
        assert len(cols) == 4
        rate = cols.event_codes == cols.event_names.index("rate")
        assert np.allclose(np.sort(cols.values[rate]), [3.0, 4.0, 5.0])
        assert np.isnan(cols.values[~rate]).all()
        users = cols.entity_bimap.from_index(cols.entity_ids)
        items = cols.target_bimap.from_index(cols.target_ids)
        assert {("u1", "i1"), ("u2", "i2")} <= set(zip(users, items))
        assert (np.diff(cols.times) >= 0).all()  # rows keep time order

    def test_to_columns_subset_vocabulary(self, port_storage):
        _seed(port_storage)
        cols = PBatchView("ViewApp").to_columns(event_names=["view"])
        assert len(cols) == 1 and cols.event_names == ["view"]
        assert cols.entity_bimap.from_index(cols.entity_ids) == ["u1"]

    def test_property_matrix(self, port_storage):
        _seed(port_storage)
        mat, bimap = PBatchView("ViewApp").property_matrix("user", ["age"])
        assert mat.shape == (2, 1)
        assert np.isnan(mat[bimap["u1"], 0])  # age was $unset
        assert mat[bimap["u2"], 0] == 22.0

    def test_to_columns_uses_cached_snapshot(self, port_storage):
        """After the event snapshot is read, to_columns folds from it,
        coherent with aggregate_properties under concurrent ingestion; a
        fresh view sees a later event through the pushed-down scan."""
        app_id = _seed(port_storage, name="SnapApp")
        view = PBatchView("SnapApp", store=EventStore(port_storage))
        n_before = len(view.events)
        port_storage.l_events().insert(
            Event(event="view", entity_type="user", entity_id="late-u",
                  target_entity_type="item", target_entity_id="late-i",
                  properties=DataMap({}), event_time=ts(8)), app_id)
        cols = view.to_columns()
        assert "late-u" not in cols.entity_bimap
        assert len(cols) <= n_before
        fresh = PBatchView("SnapApp", store=view._store).to_columns()
        assert "late-u" in fresh.entity_bimap


def test_views_match_the_references(port_storage, memory_storage):
    """Over the same events in a memory store of each package, the
    ordered events, the property folds, an ordered fold and both column
    forms (pushed down and from the snapshot) are equal."""
    ids = {True: _seed(port_storage), False: _seed(memory_storage, port=False)}
    for extra in range(12):  # views of several users
        for storage, port in ((port_storage, True), (memory_storage, False)):
            event_cls, datamap = ((Event, DataMap) if port
                                  else (RefEvent, RefDataMap))
            storage.l_events().insert(event_cls(
                event="view", entity_type="user", entity_id=f"u{extra % 5}",
                target_entity_type="item", target_entity_id=f"i{extra % 7}",
                properties=datamap({}),
                event_time=ts(8) + timedelta(minutes=extra)), ids[port])
    port, ref = PBatchView("ViewApp"), RefPBatchView("ViewApp")
    pushed = (port.to_columns(value_key="rating"),
              ref.to_columns(value_key="rating"))
    assert [(e.event, e.entity_id, e.target_entity_id, e.event_time)
            for e in port.events] == \
        [(e.event, e.entity_id, e.target_entity_id, e.event_time)
         for e in ref.events]
    assert {k: v.to_dict() for k, v in
            port.aggregate_properties("user").items()} == \
        {k: v.to_dict() for k, v in ref.aggregate_properties("user").items()}

    def trail(acc, e):
        return acc + (e.target_entity_id,)

    def views(e):
        return e.event == "view"

    assert port.aggregate_by_entity_ordered(views, (), trail) == \
        ref.aggregate_by_entity_ordered(views, (), trail)
    assert RefLBatchView("ViewApp").aggregate_by_entity_ordered(
        views, (), trail) == LBatchView("ViewApp").aggregate_by_entity_ordered(
        views, (), trail)
    snap = (port.to_columns(value_key="rating"),
            ref.to_columns(value_key="rating"))
    for got, want in (pushed, snap):
        for name in ("entity_ids", "target_ids", "event_codes"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), err_msg=name)
        # the port reads event times exactly; the reference's memory scan
        # goes through a day-number conversion, ~20 µs off at these dates
        assert (got.times == np.round(got.times)).all()
        np.testing.assert_allclose(got.times, want.times, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got.values, want.values)
        assert got.event_names == want.event_names
        assert list(got.entity_bimap.keys()) == list(want.entity_bimap.keys())
