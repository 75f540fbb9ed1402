"""The port's columnar event scan (`LEvents.find_columnar`) — the
reference's tests/test_columnar.py on the port's storage, and the
cross-tier bars of the native reader: on a sqlite file the C++ reader
(`native/pio_scan.cpp`) is bitwise equal to the port's SQL tier (the
tier `PIO_NATIVE=0` leaves), and to the reference's own C++ reader on a
store either package wrote."""

from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from predictionio_torch import native
from predictionio_torch.data.datamap import DataMap
from predictionio_torch.data.events import Event
from predictionio_torch.data.store import EventStore
from predictionio_torch.storage import base
from predictionio_torch.storage.base import App, Channel
from predictionio_torch.storage.registry import (
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_torch.storage.sqlite import SQLiteBackend

T0 = datetime(2024, 5, 1, 12, 0, 0, tzinfo=timezone.utc)


@pytest.fixture()
def _native():
    """Skips unless g++ built the native library; decided when a test
    runs, never while the module is collected."""
    if not native.native_available():
        pytest.skip("no C++ toolchain (g++) to build the native library")


needs_native = pytest.mark.usefixtures("_native")


@pytest.fixture()
def port_storage():
    """A fresh in-memory port Storage wired as the port's singleton."""
    src = SourceConfig(name="TEST", type="memory")
    storage = Storage(StorageConfig(metadata=src, modeldata=src,
                                    eventdata=src))
    Storage.reset(storage)
    yield storage
    storage.close()
    Storage.reset(None)


def _ingest(storage, app_name="ColApp", event_cls=Event, datamap=DataMap,
            app_cls=App, channel_cls=Channel):
    # accepts either a Storage registry wrapper or a raw backend (of
    # either package, with that package's classes)
    raw = not hasattr(storage, "meta_apps")
    apps = storage.apps() if raw else storage.meta_apps()
    chans = storage.channels() if raw else storage.meta_channels()
    le = storage.events() if raw else storage.l_events()
    app_id = apps.insert(app_cls(id=0, name=app_name))
    ch_id = chans.insert(channel_cls(id=0, name="side", app_id=app_id))
    rows = [
        # (entity, target, event, props, minute-offset)
        ("u2", "i9", "rate", {"rating": 4.5}, 0),
        ("u1", "i1", "rate", {"rating": 2.0}, 1),
        ("u1", None, "$set", {"plan": "pro"}, 2),      # special: excluded
        ("u3", "i1", "view", {}, 3),                   # no value property
        ("u1", "i2", "buy", {"rating": "3"}, 4),       # string-coded number
        ("u2", None, "signup", {}, 5),                 # no target
        ("u10", "i10", "rate", {"rating": -1.25}, 6),  # "u10" < "u2" bytewise
    ]
    for ent, tgt, name, props, dt_min in rows:
        le.insert(
            event_cls(
                event=name, entity_type="user", entity_id=ent,
                target_entity_type="item" if tgt else None,
                target_entity_id=tgt,
                properties=datamap(props),
                event_time=T0 + timedelta(minutes=dt_min),
            ),
            app_id,
        )
    # different channel + different app: must be invisible to the scan
    le.insert(
        event_cls(event="rate", entity_type="user", entity_id="uX",
                  target_entity_type="item", target_entity_id="iX",
                  properties=datamap({"rating": 9.0}), event_time=T0),
        app_id, ch_id)
    other = apps.insert(app_cls(id=0, name=app_name + "2"))
    le.insert(
        event_cls(event="rate", entity_type="user", entity_id="uY",
                  target_entity_type="item", target_entity_id="iY",
                  properties=datamap({"rating": 8.0}), event_time=T0),
        other)
    return app_id


def _assert_columns_equal(a, b):
    np.testing.assert_array_equal(a.entity_ids, b.entity_ids)
    np.testing.assert_array_equal(a.target_ids, b.target_ids)
    np.testing.assert_array_equal(a.event_codes, b.event_codes)
    np.testing.assert_allclose(a.values, b.values, rtol=1e-6)
    np.testing.assert_allclose(a.times, b.times, atol=5e-4)
    assert a.event_names == b.event_names
    assert dict(a.entity_bimap.items()) == dict(b.entity_bimap.items())
    assert dict(a.target_bimap.items()) == dict(b.target_bimap.items())


def _rows_bits(cols, ordered):
    """Every column as raw bits (values and times bitwise, NaN by its
    pattern), rows sorted by those bits unless `ordered`."""
    table = np.stack([
        cols.entity_ids.astype(np.int64), cols.target_ids.astype(np.int64),
        cols.event_codes.astype(np.int64),
        np.asarray(cols.values, np.float32).view(np.uint32).astype(np.int64),
        np.asarray(cols.times, np.float64).view(np.int64)], axis=1)
    if not ordered and len(table):
        table = table[np.lexsort(table.T[::-1])]
    return table


def _assert_bitwise(a, b, ordered=True):
    assert a.entity_ids.dtype == b.entity_ids.dtype
    assert a.values.dtype == b.values.dtype
    assert a.times.dtype == b.times.dtype
    np.testing.assert_array_equal(_rows_bits(a, ordered),
                                  _rows_bits(b, ordered))
    assert a.event_names == b.event_names
    assert list(a.entity_bimap.items()) == list(b.entity_bimap.items())
    assert list(a.target_bimap.items()) == list(b.target_bimap.items())


def _sql_tier(monkeypatch, fn):
    """`fn()` with the native tier switched off (`PIO_NATIVE=0`)."""
    with monkeypatch.context() as m:
        m.setenv("PIO_NATIVE", "0")
        return fn()


class TestFindColumnar:
    @pytest.mark.parametrize("kwargs", [
        dict(value_key="rating"),
        dict(),
        dict(event_names=["rate", "buy"], value_key="rating"),
        dict(event_names=["rate"], value_key="missing_key"),
        dict(entity_type="user", target_entity_type="item",
             value_key="rating"),
        dict(start_time=T0 + timedelta(minutes=1),
             until_time=T0 + timedelta(minutes=5), value_key="rating"),
    ])
    def test_sql_path_matches_generic_fallback(self, port_storage, kwargs):
        app_id = _ingest(port_storage)
        le = port_storage.l_events()
        fast = le.find_columnar(app_id=app_id, **kwargs)
        slow = base.LEvents.find_columnar(le, app_id=app_id, **kwargs)
        _assert_columns_equal(fast, slow)

    def test_contents(self, port_storage):
        app_id = _ingest(port_storage)
        le = port_storage.l_events()
        cols = le.find_columnar(app_id=app_id, value_key="rating")
        # special + other-channel + other-app events excluded
        assert len(cols) == 6
        assert cols.event_names == ["buy", "rate", "signup", "view"]
        # rows in (event_time, creation_time) order
        assert (np.diff(cols.times) >= 0).all()
        decoded = cols.entity_bimap.from_index(cols.entity_ids)
        assert decoded == ["u2", "u1", "u3", "u1", "u2", "u10"]
        # sorted-order codes: "u1" < "u10" < "u2" < "u3" bytewise
        assert dict(cols.entity_bimap.items()) == {
            "u1": 0, "u10": 1, "u2": 2, "u3": 3}
        # value column: present → float (incl. string-coded), absent → NaN
        np.testing.assert_allclose(cols.values[[0, 1, 3, 5]],
                                   [4.5, 2.0, 3.0, -1.25])
        assert np.isnan(cols.values[[2, 4]]).all()
        # missing target → -1
        assert cols.target_ids[4] == -1
        # times round-trip the stored timestamps
        assert cols.times[0] == pytest.approx(T0.timestamp(), abs=5e-4)

    @needs_native
    @pytest.mark.parametrize("kwargs", [
        dict(value_key="rating"),
        dict(),
        dict(event_names=["rate", "buy"], value_key="rating"),
        dict(entity_type="user", target_entity_type="item",
             value_key="rating"),
        dict(start_time=T0 + timedelta(minutes=1),
             until_time=T0 + timedelta(minutes=5), value_key="rating"),
    ])
    @pytest.mark.parametrize("ordered", [True, False])
    def test_native_scan_matches_sql(self, tmp_path, kwargs, ordered):
        """File-backed DB: the C++ sqlite reader must agree with the SQL
        tier exactly (same codes, values, times, bimaps)."""
        b = SQLiteBackend(str(tmp_path / "scan.db"))
        app_id = _ingest(b)
        le = b.events()
        fast = le.find_columnar(app_id=app_id, ordered=ordered, **kwargs)
        # force the SQL tier on the same backend
        try:
            b._native_scan_path = lambda: None  # type: ignore
            slow = le.find_columnar(app_id=app_id, ordered=ordered, **kwargs)
        finally:
            del b.__dict__["_native_scan_path"]
        _assert_bitwise(fast, slow, ordered)

    @needs_native
    def test_native_scan_used_on_file_db(self, tmp_path, monkeypatch):
        """The native reader actually engages for file DBs (guards against
        silently falling back forever)."""
        b = SQLiteBackend(str(tmp_path / "scan2.db"))
        app_id = _ingest(b)
        calls = []
        real = native.columnar_scan_native

        def spy(*a, **k):
            out = real(*a, **k)
            calls.append(out is not None)
            return out

        monkeypatch.setattr(native, "columnar_scan_native", spy)
        b.events().find_columnar(app_id=app_id, value_key="rating")
        assert calls == [True]
        # PIO_NATIVE=0: the wrapper is asked and declines
        calls.clear()
        _sql_tier(monkeypatch, lambda: b.events().find_columnar(
            app_id=app_id, value_key="rating"))
        assert calls == [False]

    def test_channel_scan(self, port_storage):
        _ingest(port_storage)
        store = EventStore(port_storage)
        cols = store.find_columnar("ColApp", channel_name="side",
                                   value_key="rating")
        assert len(cols) == 1
        assert cols.entity_bimap.from_index(cols.entity_ids) == ["uX"]
        np.testing.assert_allclose(cols.values, [9.0])

    def test_unordered_scan_same_multiset(self, port_storage):
        app_id = _ingest(port_storage)
        le = port_storage.l_events()
        a = le.find_columnar(app_id=app_id, value_key="rating")
        b = le.find_columnar(app_id=app_id, value_key="rating",
                             ordered=False)
        assert len(a) == len(b)
        assert dict(a.entity_bimap.items()) == dict(b.entity_bimap.items())
        # same rows as a multiset (order not guaranteed)
        key = lambda c: sorted(zip(c.entity_ids.tolist(),
                                   c.target_ids.tolist(),
                                   c.event_codes.tolist(),
                                   np.nan_to_num(c.values, nan=-9).tolist()))
        assert key(a) == key(b)

    def test_empty_event_names_selects_nothing(self, port_storage):
        """Explicit [] must select zero rows, not fall through to an
        unfiltered scan leaking $set/special events."""
        app_id = _ingest(port_storage)
        le = port_storage.l_events()
        cols = le.find_columnar(app_id=app_id, event_names=[])
        assert len(cols) == 0
        slow = base.LEvents.find_columnar(le, app_id=app_id, event_names=[])
        assert len(slow) == 0

    @pytest.mark.parametrize("backend", ["memory", "file"])
    def test_non_numeric_values_are_missing_not_zero(
            self, port_storage, tmp_path, backend):
        """A non-numeric value property must come back NaN (missing) on
        every tier — SQL, native C++ reader, and generic fallback —
        CAST's silent 0.0 would train bogus ratings."""
        if backend == "memory":
            app_id = port_storage.meta_apps().insert(App(id=0, name="NN"))
            le = port_storage.l_events()
        else:
            b = SQLiteBackend(str(tmp_path / "nn.db"))
            app_id = b.apps().insert(App(id=0, name="NN"))
            le = b.events()
        props = [{"rating": "not-a-number"}, {"rating": [1, 2]},
                 {"rating": {"x": 1}}, {"rating": "4.5"},
                 {"rating": True}, {"rating": 2}]
        for i, p in enumerate(props):
            le.insert(
                Event(event="rate", entity_type="user", entity_id=f"u{i}",
                      target_entity_type="item", target_entity_id="i1",
                      properties=DataMap(p),
                      event_time=T0 + timedelta(minutes=i)),
                app_id)
        for cols in (
            le.find_columnar(app_id=app_id, value_key="rating"),
            base.LEvents.find_columnar(le, app_id=app_id,
                                       value_key="rating"),
        ):
            assert np.isnan(cols.values[[0, 1, 2]]).all()
            np.testing.assert_allclose(cols.values[[3, 4, 5]],
                                       [4.5, 1.0, 2.0])

    def test_empty_scan(self, port_storage):
        app_id = port_storage.meta_apps().insert(App(id=0, name="Empty"))
        le = port_storage.l_events()
        cols = le.find_columnar(app_id=app_id, value_key="rating")
        assert len(cols) == 0
        assert cols.event_names == []
        assert len(cols.entity_bimap) == 0


# -- the cross-tier and cross-package bars -----------------------------------

def _tricky_store(path, n=400, seed=3):
    """A file store of rate/view/buy events whose values are numbers,
    text-coded numbers, booleans, lists, objects, non-numeric text and
    absent, at microsecond event times (some shared), with `$set`s and
    a second channel mixed in."""
    rng = np.random.default_rng(seed)
    b = SQLiteBackend(str(path))
    app_id = b.apps().insert(App(id=0, name="Tricky"))
    ch_id = b.channels().insert(Channel(id=0, name="side", app_id=app_id))
    kinds = [lambda: float(rng.uniform(-5, 5)), lambda: int(rng.integers(9)),
             lambda: f"{rng.uniform(0, 5):.6f}", lambda: "not-a-number",
             lambda: bool(rng.integers(2)), lambda: [1, 2],
             lambda: {"x": 1}, lambda: None, lambda: 0.1, lambda: 1e-7]
    events = []
    for k in range(n):
        name = ["rate", "view", "buy", "$set"][int(rng.integers(4))]
        pick = int(rng.integers(len(kinds) + 1))
        props = {} if pick == len(kinds) else {"rating": kinds[pick]()}
        us = int(rng.integers(0, 10**6))
        t = T0 + timedelta(seconds=int(rng.integers(0, 50)), microseconds=us)
        tgt = None if name == "$set" or rng.integers(9) == 0 else \
            f"i{int(rng.integers(60))}"
        events.append(Event(
            event=name, entity_type="user",
            entity_id=f"u{int(rng.integers(40))}",
            target_entity_type="item" if tgt else None,
            target_entity_id=tgt, properties=DataMap(props), event_time=t))
    b.events().insert_batch(events[: n // 2], app_id)
    b.events().insert_batch(events[n // 2: n - 20], app_id)
    b.events().insert_batch(events[n - 20:], app_id, ch_id)
    return b, app_id


@needs_native
@pytest.mark.parametrize("kwargs", [
    dict(value_key="rating"),
    dict(event_names=["rate", "buy"], value_key="rating"),
    dict(entity_type="user", target_entity_type="item", value_key="rating"),
    dict(start_time=T0 + timedelta(seconds=10, microseconds=250_000),
         until_time=T0 + timedelta(seconds=30), value_key="rating"),
    dict(),
])
@pytest.mark.parametrize("ordered", [True, False])
def test_native_bitwise_equals_sql_tier_under_pio_native_0(
        tmp_path, monkeypatch, kwargs, ordered):
    """Native scan against the SQL tier that `PIO_NATIVE=0` leaves, on
    the same file: codes, event codes, values and microsecond times bit
    for bit, both BiMaps, in order (or as the same rows when
    unordered)."""
    b, app_id = _tricky_store(tmp_path / "tricky.db")
    le = b.events()
    calls = []
    real = native.columnar_scan_native

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(native, "columnar_scan_native", spy)
    fast = le.find_columnar(app_id=app_id, ordered=ordered, **kwargs)
    slow = _sql_tier(monkeypatch, lambda: le.find_columnar(
        app_id=app_id, ordered=ordered, **kwargs))
    assert calls == [True, False]
    assert len(fast) > 0
    _assert_bitwise(fast, slow, ordered)
    if kwargs.get("value_key"):
        assert np.isnan(fast.values).any() and (~np.isnan(fast.values)).any()
    # the times keep their microseconds
    assert (np.round(fast.times * 1e6) % 1e6 != 0).any()
    b.close()


@needs_native
@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("ordered", [True, False])
def test_port_native_equals_the_reference_native(tmp_path, writer, ordered):
    """On a store one package wrote, the port's C++ reader and the
    reference's return the same columns bit for bit."""
    from predictionio_tpu import native as ref_native
    from predictionio_tpu.data.datamap import DataMap as RefDataMap
    from predictionio_tpu.data.events import Event as RefEvent
    from predictionio_tpu.storage.base import App as RefApp
    from predictionio_tpu.storage.base import Channel as RefChannel
    from predictionio_tpu.storage.sqlite import SQLiteBackend as RefBackend

    if not ref_native.native_available():
        pytest.skip("the reference's native library did not build")
    path = str(tmp_path / "both.db")
    if writer == "port":
        w = SQLiteBackend(path)
        app_id = _ingest(w)
    else:
        w = RefBackend(path)
        app_id = _ingest(w, event_cls=RefEvent, datamap=RefDataMap,
                         app_cls=RefApp, channel_cls=RefChannel)
    w.close()
    port, ref = SQLiteBackend(path), RefBackend(path)
    for kwargs in (dict(value_key="rating"), dict(),
                   dict(event_names=["rate", "buy"], value_key="rating")):
        mine = port.events().find_columnar(app_id=app_id, ordered=ordered,
                                           **kwargs)
        theirs = ref.events().find_columnar(app_id=app_id, ordered=ordered,
                                            **kwargs)
        assert len(mine) == (4 if kwargs.get("event_names") else 6)
        _assert_bitwise(mine, theirs, ordered)
    port.close()
    ref.close()
