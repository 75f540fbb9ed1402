"""The port's storage (`predictionio_torch.storage`, `data/events.py`,
`data/datamap.py`, `data/store.py`'s storage path, `tools/transfer.py`)
held to the reference's storage tests (tests/test_storage.py,
tests/test_localfs_storage.py), and a `pio.db` written by either package
read back by the other."""

import json
import os
import sqlite3
import threading
import time
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from predictionio_tpu.data.datamap import DataMap as RefDataMap
from predictionio_tpu.data.events import Event as RefEvent
from predictionio_tpu.data.store import EventStore as RefEventStore
from predictionio_tpu.storage import base as ref_base
from predictionio_tpu.storage.sqlite import SQLiteBackend as RefSQLiteBackend
from predictionio_tpu.telemetry.lineage import CausalContext as RefContext
from predictionio_torch.data.datamap import DataMap, aggregate_properties
from predictionio_torch.data.events import Event
from predictionio_torch.data.store import EventStore
from predictionio_torch.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    Model,
)
from predictionio_torch.storage.localfs import LocalFSBackend, LocalFSModels
from predictionio_torch.storage.registry import (
    BACKEND_TYPES,
    SourceConfig,
    Storage,
    StorageConfig,
    register_backend,
)
from predictionio_torch.storage.sqlite import SQLiteBackend, SQLiteLEvents
from predictionio_torch.telemetry.lineage import CausalContext
from predictionio_torch.utils import faults


def ts(h, m=0):
    return datetime(2026, 1, 1, h, m, 0, tzinfo=timezone.utc)


def ev(name, eid="u1", t=None, **kw):
    return Event(event=name, entity_type="user", entity_id=eid,
                 event_time=t or ts(0), **kw)


@pytest.fixture()
def storage():
    """A fresh in-memory port Storage wired as the port's singleton."""
    src = SourceConfig(name="TEST", type="memory")
    s = Storage(StorageConfig(metadata=src, modeldata=src, eventdata=src))
    Storage.reset(s)
    yield s
    s.close()
    Storage.reset(None)


def _file_storage(path):
    src = SourceConfig(name="F", type="sqlite", path=str(path))
    return Storage(StorageConfig(metadata=src, modeldata=src, eventdata=src))


# -- the reference's tests/test_storage.py, on the port ----------------------

def test_apps_crud(storage):
    apps = storage.meta_apps()
    app_id = apps.insert(App(id=0, name="MyApp", description="d"))
    assert app_id is not None
    assert apps.get(app_id).name == "MyApp"
    assert apps.get_by_name("MyApp").id == app_id
    assert apps.insert(App(id=0, name="MyApp")) is None  # duplicate name
    assert apps.update(App(id=app_id, name="Renamed"))
    assert apps.get_by_name("Renamed") is not None
    assert [a.name for a in apps.get_all()] == ["Renamed"]
    assert apps.delete(app_id)
    assert apps.get(app_id) is None


def test_access_keys(storage):
    keys = storage.meta_access_keys()
    k = AccessKey.generate(app_id=1, events=["rate"])
    keys.insert(k)
    got = keys.get(k.key)
    assert got.app_id == 1 and got.events == ["rate"]
    assert len(keys.get_by_app_id(1)) == 1
    assert keys.delete(k.key)
    assert keys.get(k.key) is None


def test_channels(storage):
    channels = storage.meta_channels()
    cid = channels.insert(Channel(id=0, name="ch1", app_id=1))
    assert cid is not None
    assert channels.get(cid).name == "ch1"
    assert channels.insert(Channel(id=0, name="ch1", app_id=1)) is None
    assert channels.insert(Channel(id=0, name="x" * 20, app_id=1)) is None
    assert [c.name for c in channels.get_by_app_id(1)] == ["ch1"]


def _instance(status="RUNNING", t=None):
    t = t or ts(1)
    return EngineInstance(
        id="", status=status, start_time=t, end_time=t, engine_id="eng",
        engine_version="1", engine_variant="engine.json",
        engine_factory="mod.Factory")


def test_engine_instances_insert_get_update(storage):
    eis = storage.meta_engine_instances()
    iid = eis.insert(_instance())
    inst = eis.get(iid)
    assert inst.status == "RUNNING"
    inst.status = "COMPLETED"
    eis.update(inst)
    assert eis.get(iid).status == "COMPLETED"


def test_engine_instances_latest_completed(storage):
    eis = storage.meta_engine_instances()
    eis.insert(_instance("COMPLETED", ts(1)))
    latest = _instance("COMPLETED", ts(2))
    eis.insert(latest)
    eis.insert(_instance("RUNNING", ts(3)))
    assert eis.get_latest_completed("eng", "1", "engine.json").id == latest.id
    assert eis.get_latest_completed("other", "1", "engine.json") is None


def test_evaluation_instances(storage):
    evs = storage.meta_evaluation_instances()
    inst = EvaluationInstance(
        id="", status="EVALRUNNING", start_time=ts(1), end_time=ts(1),
        evaluation_class="ev.Cls", engine_params_generator_class="gen.Cls")
    iid = evs.insert(inst)
    inst.status = "EVALCOMPLETED"
    inst.evaluator_results = "MAP@10: 0.1"
    evs.update(inst)
    completed = evs.get_completed()
    assert [i.id for i in completed] == [iid]
    assert completed[0].evaluator_results == "MAP@10: 0.1"


@pytest.mark.parametrize("backend", ["sqlite", "localfs"])
def test_models_blob_round_trip_overwrite_delete(storage, tmp_path, backend):
    """The model repository on both backends: insert, overwrite, delete
    (test_storage.py::test_models_blob, test_localfs_storage.py's
    round-trip and overwrite cases)."""
    models = (storage.model_data_models() if backend == "sqlite"
              else LocalFSModels(str(tmp_path)))
    models.insert(Model(id="i1", models=b"\x00\x01bytes"))
    assert models.get("i1").models == b"\x00\x01bytes"
    models.insert(Model(id="i1", models=b"replaced"))
    assert models.get("i1").models == b"replaced"
    assert models.delete("i1")
    assert models.get("i1") is None
    assert not models.delete("i1")


def test_levents_insert_get_delete(storage):
    le = storage.l_events()
    eid = le.insert(ev("rate", properties=DataMap({"rating": 4.0})), app_id=1)
    got = le.get(eid, app_id=1)
    assert got.properties.to_dict() == {"rating": 4.0}
    assert le.get(eid, app_id=2) is None  # app isolation
    assert le.delete(eid, app_id=1)
    assert le.get(eid, app_id=1) is None


def test_levents_find_filters(storage):
    le = storage.l_events()
    le.insert(ev("rate", "u1", ts(1)), app_id=1)
    le.insert(ev("buy", "u1", ts(2)), app_id=1)
    le.insert(ev("rate", "u2", ts(3)), app_id=1)
    le.insert(ev("rate", "u9", ts(1)), app_id=2)
    assert len(le.find(app_id=1)) == 3
    assert len(le.find(app_id=1, event_names=["rate"])) == 2
    assert len(le.find(app_id=1, entity_id="u1")) == 2
    assert len(le.find(app_id=1, entity_id=["u1", "u2"])) == 3
    assert le.find(app_id=1, entity_id=[]) == []
    assert len(le.find(app_id=1, start_time=ts(2))) == 2
    assert len(le.find(app_id=1, until_time=ts(2))) == 1
    times = [e.event_time for e in le.find(app_id=1)]
    assert times == sorted(times)
    assert le.find(app_id=1, reversed=True, limit=1)[0].event_time == ts(3)


@pytest.mark.parametrize("kw, index", [
    ({"entity_type": "user", "entity_id": "u1"}, "idx_events_entity"),
    ({"entity_type": "user", "entity_id": ["u1", "u3"],
      "event_names": ["view"], "target_entity_type": "item"},
     "idx_events_entity"),
    ({"target_entity_type": "item", "target_entity_id": "i2",
      "reversed": True, "limit": 3}, "idx_events_target"),
])
def test_find_by_entity_seeks_its_index(tmp_path, kw, index):
    """A lookup by entity (the ecommerce template's per-query reads, the
    online plane's history gather) reads through that entity's index, not
    the scan index sqlite picks for the ORDER BY (every event of the
    app), and returns the rows in event-time order."""
    s = _file_storage(tmp_path / "pio.db")
    try:
        le = s.l_events()
        for n in range(60):
            le.insert(Event(event="view" if n % 4 else "buy",
                            entity_type="user", entity_id=f"u{n % 5}",
                            target_entity_type="item",
                            target_entity_id=f"i{n % 7}",
                            event_time=ts(0, 59 - n)), app_id=1)
        statements = []
        conn = le._b._conn()
        conn.set_trace_callback(statements.append)
        got = le.find(app_id=1, **kw)
        conn.set_trace_callback(None)
        [select] = [q for q in statements if q.startswith("SELECT")]
        plan = " ".join(str(tuple(r)) for r in conn.execute(
            "EXPLAIN QUERY PLAN " + select).fetchall())
        assert f"USING INDEX {index}" in plan, plan
        everything = le.find(app_id=1)
        users = kw.get("entity_id")
        users = [users] if isinstance(users, str) else users
        want = [e for e in everything
                if (users is None or e.entity_id in users)
                and e.event in kw.get("event_names", [e.event])
                and kw.get("target_entity_id", e.target_entity_id)
                == e.target_entity_id]
        if kw.get("reversed"):
            want = want[::-1][:kw["limit"]]
        assert [e.event_id for e in got] == [e.event_id for e in want]
        assert len(got) >= 3
    finally:
        s.close()


def test_aggregate_value_expr_without_json_subtypes(tmp_path):
    """The pushed-down property fold takes a list- or object-valued
    property as its JSON text. From sqlite 3.45 json_each's value column
    carries no JSON subtype, and json_quote of it made a list a string
    (the categories of every item, on such a host); here json_each's rows
    are copied into a plain table, which carries no subtype either."""
    props = {"categories": ["c6", "c0"], "o": {"a": [1, 2.5]}, "r": 0.1,
             "i": 3, "t": True, "f": False, "s": "x", "z": None}
    s = _file_storage(tmp_path / "pio.db")
    try:
        expr = s.l_events()._b._agg_value_expr()
    finally:
        s.close()
    conn = sqlite3.connect(":memory:")
    conn.execute("CREATE TABLE s (properties TEXT)")
    conn.execute("INSERT INTO s VALUES (?)", (json.dumps(props),))
    conn.execute("CREATE TABLE je AS SELECT key, type, value, fullkey, id "
                 "FROM json_each((SELECT properties FROM s))")
    got = {k: json.loads(v) for k, v in conn.execute(
        f"SELECT je.key, json({expr}) FROM s, je").fetchall()}
    assert got == props


def test_levents_channel_isolation(storage):
    le = storage.l_events()
    le.insert(ev("rate", "u1", ts(1)), app_id=1, channel_id=None)
    le.insert(ev("rate", "u2", ts(2)), app_id=1, channel_id=7)
    assert [e.entity_id for e in le.find(app_id=1)] == ["u1"]
    assert [e.entity_id for e in le.find(app_id=1, channel_id=7)] == ["u2"]


def test_event_store_find_by_app_name(storage):
    app_id = storage.meta_apps().insert(App(id=0, name="App1"))
    storage.l_events().insert(ev("rate"), app_id=app_id)
    store = EventStore(storage)
    assert len(store.find("App1")) == 1
    assert [e.event for e in store.find_by_entity("App1", "user", "u1")] \
        == ["rate"]
    with pytest.raises(ValueError):
        store.find("NoSuchApp")


@pytest.mark.parametrize("tier", ["pushdown", "per_event"])
def test_event_store_aggregate_properties(storage, monkeypatch, tier):
    """Both tiers: the SQL pushdown, and the per-event fold a backend
    without one (its `aggregate_properties_columnar` returns None) takes;
    each equal to `data.datamap.aggregate_properties` over the store's
    own `find`."""
    if tier == "per_event":
        monkeypatch.setattr(SQLiteLEvents, "aggregate_properties_columnar",
                            lambda self, **kw: None)
    app_id = storage.meta_apps().insert(App(id=0, name="App1"))
    le = storage.l_events()
    for eid, etype, props, t in (("u1", "user", {"a": 1}, 1),
                                 ("u1", "user", {"b": 2}, 2),
                                 ("u2", "user", {"a": 5}, 2),
                                 ("i1", "item", {"c": 3}, 1)):
        le.insert(Event(event="$set", entity_type=etype, entity_id=eid,
                        properties=DataMap(props), event_time=ts(t)), app_id)
    le.insert(Event(event="$unset", entity_type="user", entity_id="u1",
                    properties=DataMap({"a": None}), event_time=ts(3)),
              app_id)
    le.insert(Event(event="$delete", entity_type="user", entity_id="u2",
                    event_time=ts(4)), app_id)
    assert (le.aggregate_properties_columnar(app_id=app_id) is None) \
        == (tier == "per_event")
    store = EventStore(storage)
    props = store.aggregate_properties("App1", "user")
    oracle = aggregate_properties(store.find(
        "App1", entity_type="user", event_names=["$set", "$unset",
                                                 "$delete"]))
    assert {k: (p.to_dict(), p.first_updated, p.last_updated)
            for k, p in props.items()} == {
        k: (p.to_dict(), p.first_updated, p.last_updated)
        for k, p in oracle.items()}
    assert props["u1"].to_dict() == {"b": 2}
    assert props["u1"].first_updated == ts(1)
    assert props["u1"].last_updated == ts(3)
    assert "i1" not in props and "u2" not in props
    assert store.aggregate_properties("App1", "user",
                                      required=["missing"]) == {}
    assert set(store.aggregate_properties("App1", "user",
                                          required=["b"])) == {"u1"}


def test_sqlite_file_backend(tmp_path):
    storage = _file_storage(tmp_path / "pio.db")
    app_id = storage.meta_apps().insert(App(id=0, name="FileApp"))
    storage.l_events().insert(ev("rate"), app_id=app_id)
    assert len(list(storage.l_events().find(app_id=app_id))) == 1
    assert all(storage.verify_all_data_objects().values())
    storage.close()


def test_subsecond_event_time_ordering(storage):
    le = storage.l_events()
    base = ts(1)
    le.insert(ev("a", "u1", base), app_id=1)
    le.insert(ev("b", "u1", base + timedelta(microseconds=500000)), app_id=1)
    le.insert(ev("c", "u1", base + timedelta(seconds=1)), app_id=1)
    assert [e.event for e in le.find(app_id=1)] == ["a", "b", "c"]
    got = le.find(app_id=1, start_time=base,
                  until_time=base + timedelta(seconds=1))
    assert [e.event for e in got] == ["a", "b"]


def test_get_delete_channel_scoped(storage):
    le = storage.l_events()
    eid = le.insert(ev("rate", "u1", ts(1)), app_id=1, channel_id=7)
    assert le.get(eid, app_id=1) is None
    assert not le.delete(eid, app_id=1)
    assert le.get(eid, app_id=1, channel_id=7) is not None
    assert le.delete(eid, app_id=1, channel_id=7)


def test_access_key_duplicate_insert_returns_none(storage):
    keys = storage.meta_access_keys()
    assert keys.insert(AccessKey(key="fixed", app_id=1)) == "fixed"
    assert keys.insert(AccessKey(key="fixed", app_id=2)) is None


@pytest.mark.parametrize("method", ["insert_batch", "insert_grouped"])
def test_bulk_inserts_single_transaction(storage, method):
    le = storage.l_events()
    batch = [ev("rate", eid=f"u{i}", t=ts(i % 24)) for i in range(250)]
    if method == "insert_batch":
        ids = le.insert_batch(batch, app_id=1)
    else:
        ids = le.insert_grouped([(e, 1, None) for e in batch])
    assert len(ids) == 250 and len(set(ids)) == 250
    assert len(le.find(app_id=1)) == 250
    assert all(e.event_id for e in batch)


def test_memory_backend_shares_one_connection_across_threads(storage):
    """`:memory:` serves every thread from one locked connection (each
    connection would otherwise open its own private database); 8 threads
    × 50 inserts all land."""
    le = storage.l_events()

    def write(t):
        for i in range(50):
            le.insert(ev("rate", eid=f"u{t}-{i}"), app_id=1)

    threads = [threading.Thread(target=write, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert len(le.find(app_id=1)) == 400


def test_dead_thread_connections_are_reaped(tmp_path):
    b = SQLiteBackend(str(tmp_path / "reap.db"))
    b.apps().insert(App(id=None, name="ReapApp"))

    def read():
        assert b.apps().get_by_name("ReapApp") is not None

    for _ in range(21):
        t = threading.Thread(target=read)
        t.start()
        t.join()
    with b._conns_lock:
        live = len(b._all_conns)
    assert live <= 3, f"{live} connections retained for dead threads"
    b.close()


def test_locked_error_reproduced_then_retried_away(tmp_path, monkeypatch):
    """Two per-thread WAL connections collide on the write lock: the
    undecorated insert surfaces the raw OperationalError, the retrying
    one rides the same window out (the `sqlite.pre_commit=delay:` fault
    holds a real writer's transaction open)."""
    monkeypatch.setenv("PIO_SQLITE_BUSY_TIMEOUT_MS", "0")
    storage = _file_storage(tmp_path / "locked.db")
    le = storage.l_events()
    try:
        monkeypatch.setenv("PIO_FAULTS", "sqlite.pre_commit=delay:200")
        faults._parse()

        def hold(started):
            started.set()
            le.insert(ev("hold"), app_id=1)

        def stage_collision():
            started = threading.Event()
            t = threading.Thread(target=hold, args=(started,))
            t.start()
            started.wait(5)
            time.sleep(0.08)  # the holder is inside its commit sleep
            return t

        locked = None
        deadline = time.monotonic() + 10
        while locked is None and time.monotonic() < deadline:
            t = stage_collision()
            try:
                SQLiteLEvents.insert.__wrapped__(le, ev("bare"), 1)
            except sqlite3.OperationalError as e:
                locked = e
            t.join(10)
        assert locked is not None and "locked" in str(locked).lower()
        t = stage_collision()
        assert le.insert(ev("retried"), app_id=1)
        t.join(10)
        assert {"hold", "retried"} <= {e.event for e in le.find(app_id=1)}
    finally:
        monkeypatch.delenv("PIO_FAULTS", raising=False)
        faults._parse()
        storage.close()


# -- the reference's tests/test_localfs_storage.py, on the port --------------

def test_localfs_rejects_path_escape(tmp_path):
    store = LocalFSModels(str(tmp_path))
    for bad in ("../evil", "a/b", "a\\b", ""):
        with pytest.raises(ValueError):
            store.get(bad)


def test_localfs_non_models_repos_fail_fast(tmp_path):
    backend = LocalFSBackend(str(tmp_path))
    with pytest.raises(NotImplementedError):
        backend.apps()
    with pytest.raises(NotImplementedError):
        backend.events()


def test_mixed_sources_from_env(tmp_path):
    env = {
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "PGLIKE",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PGLIKE",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "LOCALFS",
        "PIO_STORAGE_SOURCES_PGLIKE_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_PGLIKE_PATH": str(tmp_path / "meta.db"),
        "PIO_STORAGE_SOURCES_LOCALFS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_LOCALFS_PATH": str(tmp_path / "models"),
    }
    storage = Storage(StorageConfig.from_env(env))
    try:
        storage.model_data_models().insert(Model(id="x1", models=b"blob"))
        assert os.path.exists(tmp_path / "models" / "x1.model")
        assert storage.model_data_models().get("x1").models == b"blob"
        storage.meta_apps().insert(App(id=0, name="EnvApp"))
        assert storage.meta_apps().get_by_name("EnvApp") is not None
        assert all(storage.verify_all_data_objects().values())
    finally:
        storage.close()


@pytest.mark.parametrize("stype,leaf", [("localfs", "models"),
                                        ("sqlite", "pio.db")])
def test_default_paths_use_the_basedir(tmp_path, stype, leaf):
    env = {"PIO_FS_BASEDIR": str(tmp_path),
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SRC",
           "PIO_STORAGE_SOURCES_SRC_TYPE": stype}
    cfg = StorageConfig.from_env(env)
    assert cfg.modeldata.path == str(tmp_path / leaf)
    assert StorageConfig.from_env({"PIO_FS_BASEDIR": str(tmp_path)}) \
        .eventdata.path == str(tmp_path / "pio.db")


def test_unknown_type_rejected():
    with pytest.raises(ValueError, match="hbase"):
        StorageConfig.from_env({"PIO_STORAGE_SOURCES_PIO_DEFAULT_TYPE":
                                "hbase"})


def test_register_custom_backend(tmp_path):
    calls = []

    def factory(source):
        calls.append(source.name)
        return LocalFSBackend(source.path)

    register_backend("mycloud", factory)
    try:
        env = {"PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MC",
               "PIO_STORAGE_SOURCES_MC_TYPE": "mycloud",
               "PIO_STORAGE_SOURCES_MC_PATH": str(tmp_path)}
        storage = Storage(StorageConfig.from_env(env))
        storage.model_data_models().insert(Model(id="c", models=b"z"))
        assert calls == ["MC"]
        storage.close()
    finally:
        BACKEND_TYPES.pop("mycloud", None)


# -- one pio.db, both packages ------------------------------------------------

def _events_for(mk_event, mk_map, mk_ctx):
    """Rating events, a $set, a tagged event with a prId, a lineage
    envelope on two of them, and a sub-second time."""
    t0 = datetime(2026, 2, 1, tzinfo=timezone.utc)
    out = []
    for n in range(12):
        e = mk_event(event="rate", entity_type="user", entity_id=f"u{n % 4}",
                     target_entity_type="item",
                     target_entity_id=f"i{n % 5}",
                     properties=mk_map({"rating": 1 + n % 5}),
                     event_time=t0 + timedelta(seconds=n, microseconds=7 * n))
        if n in (3, 8):
            e.lineage_ctx = mk_ctx(trace_id=f"trace{n}", origin_wall=1.5 * n,
                                   hop=n, debug=n == 8, app="a1")
        out.append(e)
    out.append(mk_event(event="$set", entity_type="user", entity_id="u0",
                        properties=mk_map({"age": 3, "name": "x"}),
                        event_time=t0, tags=["t1"], pr_id="p1"))
    return out


def _event_fields(e):
    ctx = getattr(e, "lineage_ctx", None)
    return (e.event, e.entity_type, e.entity_id, e.target_entity_type,
            e.target_entity_id, e.properties.to_dict(), e.event_time,
            list(e.tags), e.pr_id, e.creation_time, e.event_id,
            None if ctx is None else ctx.to_dict())


def _instance_fields(inst):
    return tuple(getattr(inst, f) for f in (
        "id", "status", "start_time", "end_time", "engine_id",
        "engine_version", "engine_variant", "engine_factory", "batch", "env",
        "data_source_params", "preparator_params", "algorithms_params",
        "serving_params"))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_pio_db_written_by_one_package_reads_in_the_other(tmp_path, writer):
    """Events equal field by field (the lineage envelope stripped from the
    properties and re-attached as the context), engine-instance rows
    and model blobs equal."""
    path = str(tmp_path / "pio.db")
    ref = writer == "reference"
    w = RefSQLiteBackend(path) if ref else SQLiteBackend(path)
    events = _events_for(RefEvent if ref else Event,
                         RefDataMap if ref else DataMap,
                         RefContext if ref else CausalContext)
    mk_app = ref_base.App if ref else App
    app_id = w.apps().insert(mk_app(id=0, name="Shared"))
    w.events().insert_batch(events[:6], app_id)
    for e in events[6:]:
        w.events().insert(e, app_id)
    mk_inst = ref_base.EngineInstance if ref else EngineInstance
    inst = mk_inst(id="", status="COMPLETED", start_time=ts(1),
                   end_time=ts(2), engine_id="eng", engine_version="1",
                   engine_variant="v", engine_factory="pkg.Factory",
                   batch="b", env={"k": "v"},
                   algorithms_params='[{"name": "als", "params": {}}]')
    w.engine_instances().insert(inst)
    w.models().insert((ref_base.Model if ref else Model)(id=inst.id,
                                                         models=b"\x00blob"))
    w.close()

    r = SQLiteBackend(path) if ref else RefSQLiteBackend(path)
    assert [a.name for a in r.apps().get_all()] == ["Shared"]
    got = r.events().find(app_id=app_id)
    want = sorted(events, key=lambda e: (e.event_time, e.creation_time,
                                         e.event_id))
    assert [_event_fields(e) for e in got] == \
        [_event_fields(e) for e in want]
    assert all("pio_lineage" not in e.properties for e in got)
    assert sum(getattr(e, "lineage_ctx", None) is not None for e in got) == 2
    assert _instance_fields(r.engine_instances().get(inst.id)) == \
        _instance_fields(inst)
    assert r.models().get(inst.id).models == b"\x00blob"
    r.close()


def test_find_columnar_equals_the_reference_column_for_column(tmp_path,
                                                              monkeypatch):
    """The port's EventStore.find_columnar against the reference's on one
    pio.db (rate/buy events, a missing and a non-numeric rating, a $set
    the scan must skip), ordered and unordered, discovered and given
    event names."""
    from predictionio_tpu.storage.registry import Storage as RefStorage
    from predictionio_tpu.storage.registry import (
        StorageConfig as RefStorageConfig,
    )

    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    storage = Storage(StorageConfig.from_env())
    ref_storage = RefStorage(RefStorageConfig.from_env())
    rng = np.random.default_rng(5)
    t0 = datetime(2026, 3, 1, tzinfo=timezone.utc)
    app_id = storage.meta_apps().insert(App(id=0, name="Cols"))
    events = []
    for n in range(300):
        props = {"rating": float(rng.integers(1, 11)) / 2}
        if n % 17 == 0:
            props = {}
        elif n % 23 == 0:
            props = {"rating": "bad"}
        events.append(Event(
            event="buy" if n % 7 == 0 else "rate", entity_type="user",
            entity_id=f"u{rng.integers(40)}", target_entity_type="item",
            target_entity_id=f"i{rng.integers(25)}",
            properties=DataMap(props),
            event_time=t0 + timedelta(seconds=int(rng.integers(200)))))
    events.append(Event(event="$set", entity_type="user", entity_id="u1",
                        properties=DataMap({"a": 1}), event_time=t0))
    storage.l_events().insert_batch(events, app_id)
    try:
        for kw in ({}, {"event_names": ["rate", "buy"], "ordered": False},
                   {"entity_type": "user", "target_entity_type": "item",
                    "event_names": ["rate", "buy"]}):
            got = EventStore(storage).find_columnar(
                app_name="Cols", value_key="rating", **kw)
            want = RefEventStore(ref_storage).find_columnar(
                app_name="Cols", value_key="rating", **kw)
            assert got.event_names == want.event_names
            assert got.entity_bimap.to_dict() == want.entity_bimap.to_dict()
            assert got.target_bimap.to_dict() == want.target_bimap.to_dict()
            cols = ("entity_ids", "target_ids", "event_codes", "values",
                    "times")
            if kw.get("ordered", True):
                for name in cols:
                    np.testing.assert_array_equal(getattr(got, name),
                                                  getattr(want, name))
            else:  # the same rows in an order the scan leaves open
                def rows(c):
                    # NaN (a missing rating) compares unequal to itself
                    arrays = [np.nan_to_num(getattr(c, n), nan=-1.0)
                              for n in cols]
                    return sorted(zip(*(a.tolist() for a in arrays)))
                assert rows(got) == rows(want)
    finally:
        storage.close()
        ref_storage.close()
