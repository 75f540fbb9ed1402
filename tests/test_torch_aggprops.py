"""The port's pushed-down $set/$unset/$delete aggregation — the
reference's tests/test_aggprops_pushdown.py on the port's storage, with
the port's C++ tier (`native/pio_aggprops.cpp`) beside its SQL tier.

The per-event fold (data/datamap.py::aggregate_properties) is the
semantics oracle: every test here asserts the pushdown tiers reproduce it
exactly — values, value TYPES (bool is not 1, 1.0 is not 1), first/last
update times, tombstone ordering, and the `required` filter. The last
cases hold the native tier to the SQL tier and the per-event fold on one
file, with `PIO_NATIVE=0` as the switch, take a list-valued `$set`
through the native tier, and hold the port's native fold to the
reference's on a file either package wrote.
"""

import datetime as dt
import json
import random

import pytest

from predictionio_torch import native
from predictionio_torch.data.datamap import DataMap, aggregate_properties
from predictionio_torch.data.events import Event, format_time
from predictionio_torch.data.store import EventStore
from predictionio_torch.storage.base import App
from predictionio_torch.storage.sqlite import SQLiteBackend


@pytest.fixture()
def _native():
    """Skips unless g++ built the native library; decided when a test
    runs, never while the module is collected."""
    if not native.native_available():
        pytest.skip("no C++ toolchain (g++) to build the native library")


needs_native = pytest.mark.usefixtures("_native")

T0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)


def _ev(i, kind, eid, props, entity_type="user"):
    return Event(
        event=kind, entity_type=entity_type, entity_id=eid,
        properties=DataMap(props),
        event_time=T0 + dt.timedelta(seconds=i),
        creation_time=T0 + dt.timedelta(seconds=i, microseconds=1),
    )


@pytest.fixture()
def file_backend(tmp_path):
    b = SQLiteBackend(str(tmp_path / "agg.db"))
    app_id = b.apps().insert(App(id=None, name="AggApp"))
    return b, app_id


def _oracle(le, app_id, required=None, **kw):
    props = aggregate_properties(
        le.find(app_id=app_id,
                event_names=["$set", "$unset", "$delete"], **kw))
    if required:
        props = {eid: p for eid, p in props.items()
                 if all(k in p for k in required)}
    return props


def _assert_matches(got, oracle):
    """Pushdown result (fields, first, last) vs oracle PropertyMaps —
    exact, including value types."""
    assert got is not None, "pushdown unexpectedly fell back"
    assert set(got) == set(oracle)
    for eid, (fields, first, last) in got.items():
        o = oracle[eid]
        assert fields == o.to_dict(), eid
        for k, v in fields.items():
            assert type(v) is type(o.to_dict()[k]), (eid, k, v)
        assert first == o.first_updated, eid
        assert last == o.last_updated, eid


def _both_tiers(b, app_id, required=None, **kw):
    """Run the C++ tier (file DBs with a toolchain) and the SQL tier on
    the same backend; yield each non-None result."""
    le = b.events()
    out = []
    native_res = le.aggregate_properties_columnar(
        app_id=app_id, required=required, **kw)
    if native_res is not None:
        out.append(("native-or-sql", native_res))
    try:
        b._native_scan_path = lambda: None  # force the SQL tier
        sql_res = le.aggregate_properties_columnar(
            app_id=app_id, required=required, **kw)
    finally:
        del b.__dict__["_native_scan_path"]
    if sql_res is not None:
        out.append(("sql", sql_res))
    assert out, "no pushdown tier ran at all"
    return out


class TestFidelity:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_random_streams_match_python_fold(self, file_backend, seed):
        """Randomized $set/$unset/$delete streams over tricky keys and
        values (17-digit floats, bools, null, nested, unicode/control
        keys) — both tiers reproduce the Python fold exactly."""
        b, app_id = file_backend
        rnd = random.Random(seed)
        keys = ["a", "b", "price", "né\t", "weird key", "0"]
        vals = [42, 0.1234567890123456789, 's"x\\', True, False, None,
                {"n": [1, 2.5]}, [], 9007199254740993, 1.0, -0.0,
                rnd.random(), "", "é "]
        evs = []
        for i in range(300):
            kind = rnd.choices(["$set", "$unset", "$delete"], [8, 3, 1])[0]
            if kind == "$set":
                props = {rnd.choice(keys): rnd.choice(vals)
                         for _ in range(rnd.randrange(0, 4))}
            elif kind == "$unset":
                props = {rnd.choice(keys): None
                         for _ in range(rnd.randrange(0, 3))}
            else:
                props = {}
            evs.append(_ev(i, kind, f"u{rnd.randrange(10)}", props))
        b.events().insert_batch(evs, app_id)
        oracle = _oracle(b.events(), app_id)
        for name, got in _both_tiers(b, app_id, entity_type="user"):
            _assert_matches(got, oracle)

    def test_delete_recreate_fresh_first_updated(self, file_backend):
        b, app_id = file_backend
        evs = [
            _ev(0, "$set", "u1", {"a": 1}),
            _ev(1, "$delete", "u1", {}),
            _ev(2, "$set", "u1", {"b": 2}),
        ]
        b.events().insert_batch(evs, app_id)
        oracle = _oracle(b.events(), app_id)
        assert oracle["u1"].first_updated == T0 + dt.timedelta(seconds=2)
        for _, got in _both_tiers(b, app_id):
            _assert_matches(got, oracle)
            assert got["u1"][0] == {"b": 2}

    def test_unset_touches_last_updated_even_with_absent_keys(
            self, file_backend):
        """$unset of keys the entity never had (or an empty bag) still
        stamps last_updated — the Python fold's exact rule."""
        b, app_id = file_backend
        evs = [
            _ev(0, "$set", "u1", {"a": 1}),
            _ev(5, "$unset", "u1", {"never_there": None}),
            _ev(7, "$unset", "u1", {}),
        ]
        b.events().insert_batch(evs, app_id)
        oracle = _oracle(b.events(), app_id)
        assert oracle["u1"].last_updated == T0 + dt.timedelta(seconds=7)
        for _, got in _both_tiers(b, app_id):
            _assert_matches(got, oracle)

    def test_unset_before_create_is_full_noop(self, file_backend):
        """$unset (or post-$delete $unset) on a non-existent entity
        neither creates it nor moves last_updated."""
        b, app_id = file_backend
        evs = [
            _ev(0, "$unset", "ghost", {"a": None}),
            _ev(1, "$set", "u1", {"a": 1}),
            _ev(2, "$delete", "u1", {}),
            _ev(3, "$unset", "u1", {"a": None}),
            _ev(4, "$set", "u1", {"a": 5}),
        ]
        b.events().insert_batch(evs, app_id)
        oracle = _oracle(b.events(), app_id)
        assert set(oracle) == {"u1"}
        assert oracle["u1"].first_updated == T0 + dt.timedelta(seconds=4)
        for _, got in _both_tiers(b, app_id):
            _assert_matches(got, oracle)

    def test_unset_then_reset_key_survives(self, file_backend):
        b, app_id = file_backend
        evs = [
            _ev(0, "$set", "u1", {"a": 1, "b": 2}),
            _ev(1, "$unset", "u1", {"a": None}),
            _ev(2, "$set", "u1", {"a": 3}),
        ]
        b.events().insert_batch(evs, app_id)
        oracle = _oracle(b.events(), app_id)
        assert oracle["u1"].to_dict() == {"a": 3, "b": 2}
        for _, got in _both_tiers(b, app_id):
            _assert_matches(got, oracle)

    def test_all_keys_unset_keeps_empty_entity(self, file_backend):
        """Unsetting every key leaves an EMPTY PropertyMap — the entity
        still exists (matches the fold: state[eid] stays, just empty)."""
        b, app_id = file_backend
        evs = [
            _ev(0, "$set", "u1", {"a": 1}),
            _ev(1, "$unset", "u1", {"a": None}),
        ]
        b.events().insert_batch(evs, app_id)
        oracle = _oracle(b.events(), app_id)
        assert oracle["u1"].to_dict() == {}
        for _, got in _both_tiers(b, app_id):
            _assert_matches(got, oracle)

    def test_time_window_and_channel_filters(self, file_backend):
        b, app_id = file_backend
        from predictionio_torch.storage.base import Channel

        ch_id = b.channels().insert(
            Channel(id=None, name="side", app_id=app_id))
        evs = [_ev(i, "$set", "u1", {"k": i}) for i in range(10)]
        b.events().insert_batch(evs, app_id)
        b.events().insert_batch([_ev(50, "$set", "uC", {"c": 1})],
                                app_id, ch_id)
        kw = dict(start_time=T0 + dt.timedelta(seconds=2),
                  until_time=T0 + dt.timedelta(seconds=7))
        oracle = _oracle(b.events(), app_id, **kw)
        assert oracle["u1"].to_dict() == {"k": 6}
        assert oracle["u1"].first_updated == T0 + dt.timedelta(seconds=2)
        for _, got in _both_tiers(b, app_id, **kw):
            _assert_matches(got, oracle)
        # channel isolation
        ch_oracle = {"uC"}
        got = b.events().aggregate_properties_columnar(
            app_id=app_id, channel_id=ch_id)
        assert got is not None and set(got) == ch_oracle

    def test_required_filter_with_duplicate_keys(self, file_backend):
        """required with a repeated key (the classification template can
        produce attributes + labelAttribute overlaps) must behave like
        the oracle's set-semantics `all(k in p)`, not demand two winner
        rows for one key."""
        b, app_id = file_backend
        b.events().insert_batch(
            [_ev(0, "$set", "u1", {"a": 1, "lbl": 0}),
             _ev(1, "$set", "u2", {"a": 2})], app_id)
        req = ["a", "lbl", "lbl"]
        oracle = _oracle(b.events(), app_id, required=req)
        assert set(oracle) == {"u1"}
        for _, got in _both_tiers(b, app_id, required=req):
            _assert_matches(got, oracle)

    def test_required_filter_counts_null_values(self, file_backend):
        """required=[k] keeps entities whose k is present even when its
        VALUE is null (`k in p`, not truthiness)."""
        b, app_id = file_backend
        evs = [
            _ev(0, "$set", "u1", {"a": None, "b": 1}),
            _ev(1, "$set", "u2", {"b": 2}),
        ]
        b.events().insert_batch(evs, app_id)
        oracle = _oracle(b.events(), app_id, required=["a"])
        assert set(oracle) == {"u1"}
        for _, got in _both_tiers(b, app_id, required=["a"]):
            _assert_matches(got, oracle)


class TestCorners:
    def test_exact_time_tie_resolves_by_id_everywhere(self, file_backend):
        """Two $set events with IDENTICAL event_time AND creation_time
        (routine in batch imports sharing one creation stamp): every
        tier — per-event oracle, SQL window, C++ fold — must agree on
        the winner. The unique `id` column is the final tiebreak in all
        ORDER BYs, so the larger id wins deterministically."""
        b, app_id = file_backend
        e_lo = _ev(0, "$set", "u1", {"price": 1, "only_lo": True})
        e_hi = _ev(0, "$set", "u1", {"price": 2})
        e_lo.event_id = "a" * 32
        e_hi.event_id = "b" * 32
        e_hi.creation_time = e_lo.creation_time  # exact tie, both stamps
        # insert the would-be winner FIRST so insertion order can't be
        # what the tiers secretly agree on
        b.events().insert_batch([e_hi, e_lo], app_id)
        oracle = _oracle(b.events(), app_id)
        assert oracle["u1"].to_dict() == {"price": 2, "only_lo": True}
        for _, got in _both_tiers(b, app_id):
            _assert_matches(got, oracle)
            assert got["u1"][0]["price"] == 2
        # the shared fold itself must resolve the tie by id even when
        # the caller hands it events in non-id order (its documented
        # "any order" contract) — not just transitively via find()'s
        # ORDER BY
        direct = aggregate_properties([e_hi, e_lo])
        assert direct["u1"].to_dict() == {"price": 2, "only_lo": True}

    @pytest.mark.parametrize("seed", [0, 1])
    def test_randomized_tie_heavy_streams_agree(self, file_backend, seed):
        """Fuzz the tiebreak: streams where MOST events share a
        handful of (event_time, creation_time) stamps (batch-import
        shape), random ids — every tier must produce identical folds."""
        b, app_id = file_backend
        rnd = random.Random(seed)
        stamps = [T0 + dt.timedelta(seconds=s) for s in (0, 0, 0, 1, 1)]
        evs = []
        for i in range(200):
            kind = rnd.choices(["$set", "$unset", "$delete"], [8, 3, 1])[0]
            props = ({rnd.choice("abc"): rnd.randrange(100)}
                     if kind == "$set" else
                     {rnd.choice("abc"): None} if kind == "$unset" else {})
            t = rnd.choice(stamps)
            e = Event(event=kind, entity_type="user",
                      entity_id=f"u{rnd.randrange(6)}",
                      properties=DataMap(props), event_time=t,
                      creation_time=t)
            e.event_id = "%032x" % rnd.getrandbits(128)
            evs.append(e)
        rnd.shuffle(evs)
        b.events().insert_batch(evs, app_id)
        oracle = _oracle(b.events(), app_id)
        for _, got in _both_tiers(b, app_id, entity_type="user"):
            _assert_matches(got, oracle)
        # the shared fold also agrees when fed DIRECTLY in shuffled order
        direct = aggregate_properties(evs)
        assert {k: v.to_dict() for k, v in direct.items()} == \
            {k: v.to_dict() for k, v in oracle.items()}

    def test_duplicate_keys_last_wins(self, file_backend):
        """Raw rows with duplicate JSON keys (a non-Python writer could
        store them): json.loads keeps the last — so must both tiers."""
        b, app_id = file_backend
        ts = format_time(T0)
        with b._cursor() as cur:
            cur.execute(
                "INSERT INTO events (id, app_id, channel_id, event, "
                "entity_type, entity_id, properties, event_time, tags, "
                "creation_time) VALUES (?,?,NULL,?,?,?,?,?,?,?)",
                ["dup", app_id, "$set", "user", "u1",
                 '{"a":1,"a":2}', ts, "[]", ts])
        oracle = _oracle(b.events(), app_id)
        assert oracle["u1"].to_dict() == {"a": 2}
        for _, got in _both_tiers(b, app_id):
            _assert_matches(got, oracle)

    def test_lone_surrogate_key_roundtrips(self, file_backend):
        """json.loads admits lone surrogates into keys; the C++ tier's
        ASCII re-encoding must preserve them exactly."""
        b, app_id = file_backend
        ts = format_time(T0)
        with b._cursor() as cur:
            cur.execute(
                "INSERT INTO events (id, app_id, channel_id, event, "
                "entity_type, entity_id, properties, event_time, tags, "
                "creation_time) VALUES (?,?,NULL,?,?,?,?,?,?,?)",
                ["ls", app_id, "$set", "user", "u1",
                 '{"\\ud800k":"v"}', ts, "[]", ts])
        oracle = _oracle(b.events(), app_id)
        assert list(oracle["u1"].to_dict()) == ["\ud800k"]
        for _, got in _both_tiers(b, app_id):
            _assert_matches(got, oracle)

    def test_quoted_key_float_sql_tier_bails(self, file_backend):
        """A float under a key containing '\"' defeats sqlite's
        `-> fullkey` extraction; the SQL tier must FALL BACK (None), not
        return a 15-digit rounding of the value. The C++ tier handles it
        exactly."""
        b, app_id = file_backend
        f = 0.1234567890123456789
        b.events().insert_batch(
            [_ev(0, "$set", "u1", {'k"q': f, "a": 1})], app_id)
        oracle = _oracle(b.events(), app_id)
        if native.native_available():
            got = b.events().aggregate_properties_columnar(app_id=app_id)
            _assert_matches(got, oracle)
            assert got["u1"][0]['k"q'] == f
        try:
            b._native_scan_path = lambda: None
            assert b.events().aggregate_properties_columnar(
                app_id=app_id) is None
        finally:
            del b.__dict__["_native_scan_path"]

    def test_nan_properties_native_exact_sql_bails(self, file_backend):
        """json.dumps-style NaN is invalid JSON for sqlite's json_each →
        the SQL tier falls back; the native splitter splices the raw
        span and json.loads accepts it, matching the fold."""
        import math

        b, app_id = file_backend
        ts = format_time(T0)
        with b._cursor() as cur:
            cur.execute(
                "INSERT INTO events (id, app_id, channel_id, event, "
                "entity_type, entity_id, properties, event_time, tags, "
                "creation_time) VALUES (?,?,NULL,?,?,?,?,?,?,?)",
                ["nan", app_id, "$set", "user", "u1",
                 '{"x": NaN}', ts, "[]", ts])
        if native.native_available():
            got = b.events().aggregate_properties_columnar(app_id=app_id)
            assert got is not None and math.isnan(got["u1"][0]["x"])
        try:
            b._native_scan_path = lambda: None
            assert b.events().aggregate_properties_columnar(
                app_id=app_id) is None
        finally:
            del b.__dict__["_native_scan_path"]

    def test_memory_db_uses_sql_tier(self):
        """:memory: databases can't be reopened by the C++ reader — the
        SQL tier must serve them (not a fallback to per-event)."""
        b = SQLiteBackend(":memory:")
        app_id = b.apps().insert(App(id=None, name="M"))
        b.events().insert_batch(
            [_ev(0, "$set", "u1", {"a": True})], app_id)
        got = b.events().aggregate_properties_columnar(app_id=app_id)
        assert got is not None and got["u1"][0] == {"a": True}
        assert got["u1"][0]["a"] is True


def _file_storage(tmp_path, name):
    from predictionio_torch.storage.registry import (
        SourceConfig, Storage, StorageConfig)

    src = SourceConfig(name="T", type="sqlite",
                       path=str(tmp_path / f"{name}.db"))
    storage = Storage(StorageConfig(metadata=src, modeldata=src,
                                    eventdata=src))
    return storage


class TestEventStoreRouting:
    def test_store_uses_pushdown_and_matches_fold(self, tmp_path,
                                                  monkeypatch):
        """EventStore.aggregate_properties routes through the pushdown
        (spied) and returns PropertyMaps identical to the per-event
        path."""
        storage = _file_storage(tmp_path, "s")
        b = storage._backend(storage.config.eventdata)
        app_id = b.apps().insert(App(id=None, name="RouteApp"))
        evs = [
            _ev(0, "$set", "i1", {"cat": "a", "price": 9.5},
                entity_type="item"),
            _ev(1, "$set", "i2", {"cat": "b"}, entity_type="item"),
            _ev(2, "$unset", "i1", {"price": None}, entity_type="item"),
        ]
        b.events().insert_batch(evs, app_id)
        store = EventStore(storage)

        calls = []
        real = type(b.events()).aggregate_properties_columnar

        def spy(self, *a, **k):
            out = real(self, *a, **k)
            calls.append(out is not None)
            return out

        monkeypatch.setattr(type(b.events()),
                            "aggregate_properties_columnar", spy)
        props = store.aggregate_properties("RouteApp", "item")
        assert calls == [True]
        # identical to the per-event path (PropertyMap equality is
        # field equality; check times too)
        monkeypatch.setattr(type(b.events()),
                            "aggregate_properties_columnar",
                            lambda self, *a, **k: None)
        slow = store.aggregate_properties("RouteApp", "item")
        assert set(props) == set(slow)
        for eid in props:
            assert props[eid] == slow[eid]
            assert props[eid].first_updated == slow[eid].first_updated
            assert props[eid].last_updated == slow[eid].last_updated

    def test_env_gate_forces_the_sql_tier(self, tmp_path, monkeypatch):
        """PIO_NATIVE=0 (the port's escape hatch; it has no
        PIO_AGG_PUSHDOWN) must skip the C++ tier — its wrapper declines —
        and the SQL tier returns the same result."""
        storage = _file_storage(tmp_path, "gate")
        b = storage._backend(storage.config.eventdata)
        app_id = b.apps().insert(App(id=None, name="GateApp"))
        b.events().insert_batch(
            [_ev(0, "$set", "u1", {"a": 1}, entity_type="item")], app_id)
        store = EventStore(storage)
        calls = []
        real = native.agg_props_native
        monkeypatch.setattr(
            native, "agg_props_native",
            lambda *a, **k: calls.append(real(*a, **k)) or calls[-1])
        monkeypatch.setenv("PIO_NATIVE", "0")
        props = store.aggregate_properties("GateApp", "item")
        assert calls == [None] and props["u1"].to_dict() == {"a": 1}

    def test_store_required_pushdown(self, tmp_path):
        storage = _file_storage(tmp_path, "s2")
        b = storage._backend(storage.config.eventdata)
        app_id = b.apps().insert(App(id=None, name="ReqApp"))
        b.events().insert_batch(
            [_ev(0, "$set", "i1", {"cat": "a"}, entity_type="item"),
             _ev(1, "$set", "i2", {"other": 1}, entity_type="item")],
            app_id)
        store = EventStore(storage)
        props = store.aggregate_properties("ReqApp", "item",
                                           required=["cat"])
        assert set(props) == {"i1"}


# -- the native tier against the SQL tier and the per-event fold ------------

def _random_stream(seed, n=400):
    rnd = random.Random(seed)
    keys = ["a", "b", "price", "categories", "né\t", 'k"q', "0"]
    vals = [42, 0.1234567890123456789, 's"x\\', True, False, None,
            {"n": [1, 2.5]}, [], ["c1", "c0"], 9007199254740993, 1.0,
            -0.0, rnd.random(), "", "é "]
    evs = []
    for i in range(n):
        kind = rnd.choices(["$set", "$unset", "$delete"], [8, 3, 1])[0]
        if kind == "$set":
            props = {rnd.choice(keys): rnd.choice(vals)
                     for _ in range(rnd.randrange(0, 4))}
        elif kind == "$unset":
            props = {rnd.choice(keys): None
                     for _ in range(rnd.randrange(0, 3))}
        else:
            props = {}
        e = _ev(i // 3, kind, f"u{rnd.randrange(12)}", props,
                entity_type=rnd.choice(["user", "item"]))
        evs.append(e)
    return evs


def _typed(result):
    """A fold result as text that tells 1 from 1.0 from True."""
    return {eid: (json.dumps(fields, sort_keys=True), repr(sorted(
        (k, type(v).__name__) for k, v in fields.items())), first, last)
        for eid, (fields, first, last) in result.items()}


@needs_native
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("required", [None, ["a"], ["price", "b"]])
def test_native_tier_equals_sql_tier_and_fold(file_backend, monkeypatch,
                                              seed, required):
    """On one file: the native fold (spied: it ran and answered) equals
    the fold `PIO_NATIVE=0` leaves — the SQL tier, or the per-event fold
    where the SQL tier bails (a float under a key holding '"') — and the
    oracle, types and times included."""
    b, app_id = file_backend
    b.events().insert_batch(_random_stream(seed), app_id)
    calls = []
    real = native.agg_props_native
    monkeypatch.setattr(native, "agg_props_native",
                        lambda *a, **k: calls.append(real(*a, **k))
                        or calls[-1])
    store = EventStore(_StorageOf(b))
    for entity_type in ("user", "item"):
        calls.clear()
        fast = b.events().aggregate_properties_columnar(
            app_id=app_id, entity_type=entity_type, required=required)
        assert len(calls) == 1 and calls[0] is not None
        with monkeypatch.context() as m:
            m.setenv("PIO_NATIVE", "0")
            slow = b.events().aggregate_properties_columnar(
                app_id=app_id, entity_type=entity_type, required=required)
            via_store = store.aggregate_properties(
                "AggApp", entity_type, required=required)
        assert calls[1:] == [None, None]
        oracle = _oracle(b.events(), app_id, required=required,
                         entity_type=entity_type)
        _assert_matches(fast, oracle)
        if slow is not None:
            assert _typed(slow) == _typed(fast)
        assert _typed(fast) == _typed({
            eid: (p.to_dict(), p.first_updated, p.last_updated)
            for eid, p in via_store.items()})


class _StorageOf:
    """The registry's face over one raw backend (what EventStore asks)."""

    def __init__(self, backend):
        self._b = backend

    def meta_apps(self):
        return self._b.apps()

    def meta_channels(self):
        return self._b.channels()

    def l_events(self):
        return self._b.events()


@needs_native
def test_list_valued_set_comes_back_a_list_on_the_native_tier(
        file_backend, monkeypatch):
    """The list- and object-valued `$set` of
    test_torch_storage.py::test_aggregate_value_expr_without_json_subtypes
    through the native tier: each value keeps its JSON type."""
    props = {"categories": ["c6", "c0"], "o": {"a": [1, 2.5]}, "r": 0.1,
             "i": 3, "t": True, "f": False, "s": "x", "z": None}
    b, app_id = file_backend
    b.events().insert_batch([_ev(0, "$set", "i1", props,
                                 entity_type="item")], app_id)
    calls = []
    real = native.agg_props_native
    monkeypatch.setattr(native, "agg_props_native",
                        lambda *a, **k: calls.append(real(*a, **k))
                        or calls[-1])
    got = b.events().aggregate_properties_columnar(app_id=app_id,
                                                   entity_type="item")
    assert calls and calls[0] is not None
    fields = got["i1"][0]
    assert fields == props
    assert {k: type(v) for k, v in fields.items()} == \
        {k: type(v) for k, v in props.items()}
    assert isinstance(fields["categories"], list)


def _spied(monkeypatch, mod):
    """Wraps `mod.agg_props_native` and records whether each call
    answered."""
    calls = []
    real = mod.agg_props_native
    monkeypatch.setattr(mod, "agg_props_native",
                        lambda *a, **k: calls.append(real(*a, **k))
                        or calls[-1])
    return calls


@needs_native
@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("required", [None, ["a"]])
def test_port_native_fold_equals_the_reference_native(
        tmp_path, monkeypatch, writer, required):
    """On a sqlite file one package wrote, the port's native fold and the
    reference's return the same entities, fields, value types and
    first/last update times. The stream holds typed and list-valued
    `$set`s, `$unset`s and `$delete`s, three events to each second
    (exact-timestamp ties, broken by creation time and row id alike)."""
    from predictionio_tpu import native as ref_native
    from predictionio_tpu.data.datamap import DataMap as RefDataMap
    from predictionio_tpu.data.events import Event as RefEvent
    from predictionio_tpu.storage.base import App as RefApp
    from predictionio_tpu.storage.sqlite import SQLiteBackend as RefBackend

    if not ref_native.native_available():
        pytest.skip("the reference's native library did not build")
    events = _random_stream(7, n=600)
    path = str(tmp_path / "both.db")
    if writer == "port":
        w = SQLiteBackend(path)
        app_id = w.apps().insert(App(id=None, name="AggApp"))
    else:
        w = RefBackend(path)
        app_id = w.apps().insert(RefApp(id=None, name="AggApp"))
        events = [RefEvent(
            event=e.event, entity_type=e.entity_type,
            entity_id=e.entity_id,
            properties=RefDataMap(e.properties.to_dict()),
            event_time=e.event_time, creation_time=e.creation_time)
            for e in events]
    w.events().insert_batch(events, app_id)
    w.close()
    mine_calls = _spied(monkeypatch, native)
    theirs_calls = _spied(monkeypatch, ref_native)
    port, ref = SQLiteBackend(path), RefBackend(path)
    kinds = set()
    for entity_type in ("user", "item"):
        mine = port.events().aggregate_properties_columnar(
            app_id=app_id, entity_type=entity_type, required=required)
        theirs = ref.events().aggregate_properties_columnar(
            app_id=app_id, entity_type=entity_type, required=required)
        assert mine
        assert _typed(mine) == _typed(theirs)
        kinds |= {type(v) for fields, _, _ in mine.values()
                  for v in fields.values()}
    assert {list, dict, bool, int, float, str} <= kinds
    # both answers came from the C++ folds
    assert len(mine_calls) == 2 and None not in mine_calls
    assert len(theirs_calls) == 2 and None not in theirs_calls
    port.close()
    ref.close()
