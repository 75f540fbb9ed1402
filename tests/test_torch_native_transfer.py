"""The port's native import and export (`native/pio_import.cpp`,
`native/pio_export.cpp` behind `tools/transfer.py`) — the reference's
tests/test_native_import.py and test_native_export.py on the port's
copies, then the cross bars: a file exported by either package imports
into the other and reads back equal, and `find` by entity works right
after a native bulk load into an empty store (the load drops the
idx_events_* indexes that `find` names, and rebuilds them from their
own DDL before it returns)."""

import json
import sqlite3

import pytest

from predictionio_torch import native
from predictionio_torch.storage.base import App, Channel
from predictionio_torch.storage.registry import (
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_torch.tools import transfer



@pytest.fixture(autouse=True)
def _native():
    """Skips unless g++ built the native library; decided when a test
    runs, never while the module is collected."""
    if not native.native_available():
        pytest.skip("no C++ toolchain (g++) to build the native library")


def _mk_storage(db_path, app_name="ImpApp"):
    src = SourceConfig(name="S", type="sqlite", path=str(db_path))
    storage = Storage(StorageConfig(metadata=src, modeldata=src,
                                    eventdata=src))
    app_id = storage.meta_apps().insert(App(id=0, name=app_name))
    return storage, app_id


# -- the reference's tests/test_native_import.py ------------------------------

LINES = [
    # plain event
    {"event": "rate", "entityType": "user", "entityId": "u1",
     "targetEntityType": "item", "targetEntityId": "i1",
     "properties": {"rating": 4.5}, "eventTime": "2024-03-01T10:20:30.123Z"},
    # integer-coerced ids, int + float + bool + null + nested properties
    {"event": "view", "entityType": "user", "entityId": 42,
     "targetEntityType": "item", "targetEntityId": 7,
     "properties": {"z": 1, "a": 100.0, "m": {"y": [1, 2.5, "s"], "x": True},
                    "n": None, "big": 12345678901234567890123},
     "eventTime": "2024-03-01T12:00:00+05:30"},
    # unicode + escapes + sorted-key check + tags + prId
    {"event": "buy", "entityType": "user", "entityId": "ué",
     "properties": {"b": "héllo\nworld", "a": "ctrl",
                    "emoji": "\U0001f600"},
     "tags": ["t2", "t1"], "prId": "pr-1",
     "eventTime": "2024-12-31T23:59:59.999999Z"},
    # special events
    {"event": "$set", "entityType": "user", "entityId": "s1",
     "properties": {"p": "v"}},
    {"event": "$unset", "entityType": "user", "entityId": "s2",
     "properties": {"p": None}},
    {"event": "$delete", "entityType": "user", "entityId": "s3"},
    # no eventTime → import-time stamp (compared modulo time)
    {"event": "ping", "entityType": "user", "entityId": "p1"},
    # duplicate keys in properties: last wins (raw JSON below)
    None,  # placeholder, replaced by raw line
    # float exponent + negative zero + small floats
    {"event": "f", "entityType": "user", "entityId": "f1",
     "properties": {"a": 1e20, "b": -0.0, "c": 1.5e-07, "d": 0.1}},
    # repr picks FIXED notation for exponents in [-4, 16)
    {"event": "f2", "entityType": "user", "entityId": "f2",
     "properties": {"a": 1e5, "b": 1e15, "c": 1e16, "d": 1e-4, "e": 1e-5,
                    "f": 123456.789}},
    # falsy properties coerce to {} (Python's `or {}`)
    {"event": "falsyprops", "entityType": "user", "entityId": "fp1",
     "properties": []},
    # falsy eventTime means "stamp now", not an error
    {"event": "falsytime", "entityType": "user", "entityId": "ft1",
     "eventTime": ""},
    # dict-valued tag elements keep insertion order (no
    # sort_keys on the tags dump)
    {"event": "dicttags", "entityType": "user", "entityId": "dt1",
     "tags": [{"b": 1, "a": 2}]},
    # eventId in file must NOT be reused
    {"event": "hasid", "entityType": "user", "entityId": "h1",
     "eventId": "feedfacefeedfacefeedfacefeedface"},
]

RAW_EXTRAS = [
    '{"event": "dup", "entityType": "user", "entityId": "d1", '
    '"properties": {"k": 1, "k": 2}}',
    # invalid: reserved event name
    '{"event": "$bogus", "entityType": "user", "entityId": "x"}',
    # invalid: pio_ property
    '{"event": "e", "entityType": "user", "entityId": "x", '
    '"properties": {"pio_x": 1}}',
    # invalid: $set with target
    '{"event": "$set", "entityType": "user", "entityId": "x", '
    '"targetEntityId": "y"}',
    # invalid: not json
    'not json at all',
    # invalid: missing entityId
    '{"event": "e", "entityType": "user"}',
    # fallback-path construct: NaN (json.loads accepts it)
    '{"event": "nan", "entityType": "user", "entityId": "n1", '
    '"properties": {"v": NaN}}',
    # fallback: float-typed entityId (Python str()s it)
    '{"event": "fid", "entityType": "user", "entityId": 3.5}',
    # leading-zero int is invalid JSON (Python skips the line)
    '{"event": "lz", "entityType": "user", "entityId": 007}',
    # -0 int normalizes to 0 like json.dumps(json.loads("-0"))
    '{"event": "negzero", "entityType": "user", "entityId": "nz1", '
    '"properties": {"v": -0}}',
    # impossible date — Python rejects, so must we
    '{"event": "feb30", "entityType": "user", "entityId": "x", '
    '"eventTime": "2024-02-30T00:00:00Z"}',
    "",  # blank line
]


def _write_file(path):
    with open(path, "w") as f:
        for obj in LINES:
            if obj is None:
                continue
            f.write(json.dumps(obj) + "\n")
        for raw in RAW_EXTRAS:
            f.write(raw + "\n")


def _rows(db_path):
    conn = sqlite3.connect(db_path)
    rows = conn.execute(
        "SELECT event, entity_type, entity_id, target_entity_type, "
        "target_entity_id, properties, event_time, tags, pr_id "
        "FROM events").fetchall()
    conn.close()
    # event_time of stamped-at-import events varies → zero it when recent
    out = []
    for r in rows:
        r = list(r)
        out.append(tuple(r))
    return sorted(out)


def test_native_and_python_paths_produce_identical_rows(tmp_path):
    f = tmp_path / "events.jsonl"
    _write_file(f)

    db_native = tmp_path / "native.db"
    st_n, app_n = _mk_storage(db_native)
    imported_n, skipped_n = transfer.file_to_events(str(f), "ImpApp",
                                                    storage=st_n)
    st_n.close()

    db_py = tmp_path / "python.db"
    st_p, app_p = _mk_storage(db_py)
    orig = native.import_events_native
    try:
        native.import_events_native = lambda *a, **k: None  # force Python
        imported_p, skipped_p = transfer.file_to_events(str(f), "ImpApp",
                                                        storage=st_p)
    finally:
        native.import_events_native = orig
    st_p.close()

    assert (imported_n, skipped_n) == (imported_p, skipped_p)
    rows_n, rows_p = _rows(db_native), _rows(db_py)
    assert len(rows_n) == len(rows_p) == imported_n

    # the only lines with a REAL eventTime (falsytime's "" means "now")
    has_time = {"rate", "view", "buy"}

    def strip_now(rows):
        # events without an eventTime are stamped at import time; compare
        # those for format only, not value
        out = []
        for r in rows:
            r = list(r)
            if r[0] not in has_time:
                assert len(r[6]) == 27 and r[6].endswith("Z")
                r[6] = "<now>"
            out.append(tuple(r))
        return out

    assert strip_now(rows_n) == strip_now(rows_p)


def test_native_import_normalizations(tmp_path):
    """Spot-check the C++ renderings directly: sorted keys, ensure_ascii,
    float repr, timezone conversion, id coercion, duplicate-key last-wins,
    fresh event ids."""
    f = tmp_path / "ev.jsonl"
    _write_file(f)
    db = tmp_path / "n2.db"
    st, _ = _mk_storage(db)
    transfer.file_to_events(str(f), "ImpApp", storage=st)
    st.close()

    conn = sqlite3.connect(db)
    get = lambda ev: conn.execute(
        "SELECT properties, event_time, entity_id, target_entity_id, tags, "
        "id FROM events WHERE event=?", (ev,)).fetchone()

    props, etime, eid, teid, tags, rowid = get("view")
    assert eid == "42" and teid == "7"
    assert etime == "2024-03-01T06:30:00.000000Z"  # +05:30 → UTC
    obj = json.loads(props)
    assert list(obj.keys()) == sorted(obj.keys())
    assert obj["big"] == 12345678901234567890123
    assert props == json.dumps(obj, sort_keys=True)

    props, _, eid, _, tags, _ = get("buy")
    assert "\\u00e9" in props and "\\ud83d\\ude00" in props  # ensure_ascii
    assert json.loads(tags) == ["t2", "t1"]  # list order preserved

    props, _, _, _, _, _ = get("f")
    assert json.loads(props) == {"a": 1e20, "b": -0.0, "c": 1.5e-07,
                                 "d": 0.1}
    assert props == json.dumps(json.loads(props), sort_keys=True)

    props, _, _, _, _, _ = get("dup")
    assert json.loads(props) == {"k": 2}  # duplicate key: last wins

    _, _, _, _, _, rowid = get("hasid")
    assert rowid != "feedfacefeedfacefeedfacefeedface"  # fresh id
    assert len(rowid) == 32

    _, _, eid, _, _, _ = get("fid")  # float id via the Python fallback
    assert eid == "3.5"

    props, _, _, _, _, _ = get("f2")  # fixed-vs-scientific thresholds
    assert props == json.dumps(
        {"a": 1e5, "b": 1e15, "c": 1e16, "d": 1e-4, "e": 1e-5,
         "f": 123456.789}, sort_keys=True)
    assert '"a": 100000.0' in props and '"c": 1e+16' in props
    assert '"d": 0.0001' in props and '"e": 1e-05' in props

    props, _, _, _, _, _ = get("falsyprops")
    assert props == "{}"
    assert get("falsytime") is not None  # imported, stamped now
    assert get("lz") is None             # invalid JSON → skipped
    assert get("feb30") is None          # impossible date → skipped
    props, _, _, _, _, _ = get("negzero")
    assert props == '{"v": 0}'
    _, _, _, _, tags, _ = get("dicttags")
    assert tags == '[{"b": 1, "a": 2}]'  # insertion order kept
    conn.close()


def test_native_import_speed_sanity(tmp_path):
    """The fast path must actually import a bulk file (count integrity at
    a non-trivial size; speed is what chip_smoke.py's phase 10 times)."""
    f = tmp_path / "bulk.jsonl"
    n = 20_000
    with open(f, "w") as fh:
        for i in range(n):
            fh.write(json.dumps({
                "event": "rate", "entityType": "user",
                "entityId": str(i % 500), "targetEntityType": "item",
                "targetEntityId": str(i % 300),
                "properties": {"rating": float(1 + i % 5)},
                "eventTime": "2024-01-01T00:00:00Z"}) + "\n")
    db = tmp_path / "bulk.db"
    st, _ = _mk_storage(db)
    imported, skipped = transfer.file_to_events(str(f), "ImpApp", storage=st)
    assert (imported, skipped) == (n, 0)
    assert len(st.l_events().find(app_id=1, limit=n + 1)) == n
    st.close()


def test_stamped_times_are_distinct_and_ordered(tmp_path):
    """Events missing eventTime/creationTime get per-line 'now' stamps
    that advance monotonically — a single shared stamp
    would tie every such event in ORDER BY event_time, creation_time."""
    path = tmp_path / "stamped.json"
    with open(path, "w") as f:
        for i in range(50):
            f.write(json.dumps({"event": "sign-up", "entityType": "user",
                                "entityId": f"u{i}"}) + "\n")
    storage, app_id = _mk_storage(tmp_path / "stamped.db")
    try:
        imported, skipped = transfer.file_to_events(
            str(path), "ImpApp", storage=storage)
        assert (imported, skipped) == (50, 0)
        conn = sqlite3.connect(tmp_path / "stamped.db")
        times = [r[0] for r in conn.execute(
            "SELECT event_time FROM events ORDER BY rowid").fetchall()]
        conn.close()
        assert len(set(times)) == 50  # all distinct
        assert times == sorted(times)  # file order preserved
    finally:
        storage.close()


def test_bulk_path_preserves_user_created_indexes(tmp_path):
    """The fresh-table bulk load drops/rebuilds only the _SCHEMA-owned
    idx_events_* indexes; a user-created index must survive untouched."""
    db = tmp_path / "uidx.db"
    storage, app_id = _mk_storage(db)
    try:
        conn = sqlite3.connect(db)
        conn.execute("CREATE INDEX user_custom_idx ON events (pr_id)")
        conn.commit()
        conn.close()
        path = tmp_path / "bulk.json"
        with open(path, "w") as f:
            for i in range(100):
                f.write(json.dumps(
                    {"event": "rate", "entityType": "user",
                     "entityId": f"u{i}", "targetEntityType": "item",
                     "targetEntityId": "i1",
                     "properties": {"rating": 3.0}}) + "\n")
        imported, _ = transfer.file_to_events(str(path), "ImpApp",
                                              storage=storage)
        assert imported == 100
        conn = sqlite3.connect(db)
        names = {r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type='index' "
            "AND tbl_name='events'").fetchall()}
        conn.close()
        assert "user_custom_idx" in names
        assert any(n.startswith("idx_events_") for n in names)  # rebuilt
    finally:
        storage.close()


# -- the reference's tests/test_native_export.py ------------------------------

def _python_export(storage, out_path, app_name, channel=None):
    """Force the Python path (the byte-fidelity reference)."""
    orig = transfer._native_export
    transfer._native_export = lambda *a, **k: None
    try:
        return transfer.events_to_file(str(out_path), app_name,
                                       channel_name=channel,
                                       storage=storage)
    finally:
        transfer._native_export = orig


DIVERSE = [
    {"event": "rate", "entityType": "user", "entityId": "u1",
     "targetEntityType": "item", "targetEntityId": "i1",
     "properties": {"rating": 4.5, "nested": {"a": [1, None, True]},
                    "uni": "héllo 🎉", "big": 1e300, "neg": -0.5},
     "eventTime": "2024-03-01T10:20:30.123Z"},
    {"event": "$set", "entityType": "user", "entityId": "we\"ird\\id\n",
     "properties": {}, "tags": ["t2", "t1"], "prId": "pr-1"},
    {"event": "buy", "entityType": "user", "entityId": "u2",
     "properties": {"é": "キー", "z": 0.1},
     "eventTime": "2024-12-31T23:59:59.999999+05:30"},
    {"event": "$delete", "entityType": "user", "entityId": "gone"},
]


def test_native_export_matches_python_bytes(tmp_path):
    """Rows written via BOTH ingestion paths (Python insert and C++
    import) export byte-identically through the C++ writer."""
    from datetime import datetime, timezone

    from predictionio_torch.data.datamap import DataMap
    from predictionio_torch.data.events import Event

    db = tmp_path / "e.db"
    storage, app_id = _mk_storage(db, "ExpApp")
    try:
        # path 1: C++ importer
        src_file = tmp_path / "in.json"
        with open(src_file, "w") as f:
            for obj in DIVERSE:
                f.write(json.dumps(obj) + "\n")
        imported, skipped = transfer.file_to_events(str(src_file), "ExpApp",
                                                    storage=storage)
        assert (imported, skipped) == (len(DIVERSE), 0)
        # path 2: Python storage insert
        storage.l_events().insert_batch(
            [Event(event="view", entity_type="user", entity_id="py1",
                   target_entity_type="item", target_entity_id="i9",
                   properties=DataMap({"múlti": [1, {"k": None}]}),
                   tags=["x"], pr_id="p2",
                   event_time=datetime(2025, 6, 7, 8, 9, 10, 11,
                                       tzinfo=timezone.utc))],
            app_id)

        n_native = transfer.events_to_file(str(tmp_path / "n.json"),
                                           "ExpApp", storage=storage)
        n_python = _python_export(storage, tmp_path / "p.json", "ExpApp")
        assert n_native == n_python == len(DIVERSE) + 1
        a = (tmp_path / "n.json").read_bytes()
        b = (tmp_path / "p.json").read_bytes()
        assert a == b
        # and the export round-trips through the importer
        db2 = tmp_path / "rt.db"
        storage2, _ = _mk_storage(db2, "RtApp")
        try:
            n, sk = transfer.file_to_events(str(tmp_path / "n.json"),
                                            "RtApp", storage=storage2)
            assert (n, sk) == (n_native, 0)
        finally:
            storage2.close()
    finally:
        storage.close()


def test_native_export_channel_filter(tmp_path):
    from predictionio_torch.data.datamap import DataMap
    from predictionio_torch.data.events import Event

    db = tmp_path / "c.db"
    storage, app_id = _mk_storage(db, "ExpApp")
    try:
        ch_id = storage.meta_channels().insert(
            Channel(id=0, name="mobile", app_id=app_id))
        le = storage.l_events()
        le.insert(Event(event="a", entity_type="u", entity_id="1",
                        properties=DataMap({})), app_id)
        le.insert(Event(event="b", entity_type="u", entity_id="2",
                        properties=DataMap({})), app_id, channel_id=ch_id)

        n_default = transfer.events_to_file(str(tmp_path / "d.json"),
                                            "ExpApp", storage=storage)
        n_mobile = transfer.events_to_file(str(tmp_path / "m.json"),
                                           "ExpApp", channel_name="mobile",
                                           storage=storage)
        assert (n_default, n_mobile) == (1, 1)
        assert json.loads((tmp_path / "d.json").read_text())["event"] == "a"
        assert json.loads((tmp_path / "m.json").read_text())["event"] == "b"
        # byte-parity on the channel view too
        _python_export(storage, tmp_path / "mp.json", "ExpApp",
                       channel="mobile")
        assert (tmp_path / "m.json").read_bytes() \
            == (tmp_path / "mp.json").read_bytes()
    finally:
        storage.close()


def test_memory_backend_uses_python_path(tmp_path):
    from predictionio_torch.data.datamap import DataMap
    from predictionio_torch.data.events import Event

    src = SourceConfig(name="M", type="memory")
    storage = Storage(StorageConfig(metadata=src, modeldata=src,
                                    eventdata=src))
    try:
        app_id = storage.meta_apps().insert(App(id=0, name="MemApp"))
        storage.l_events().insert(
            Event(event="e", entity_type="u", entity_id="1",
                  properties=DataMap({})), app_id)
        n = transfer.events_to_file(str(tmp_path / "mem.json"), "MemApp",
                                    storage=storage)
        assert n == 1  # Python fallback served it
    finally:
        storage.close()


# -- across the two packages -------------------------------------------------

def _ref_storage(db_path, app_name):
    from predictionio_tpu.storage.base import App as RefApp
    from predictionio_tpu.storage.registry import (
        SourceConfig as RefSource,
        Storage as RefStorage,
        StorageConfig as RefConfig,
    )

    src = RefSource(name="R", type="sqlite", path=str(db_path))
    storage = RefStorage(RefConfig(metadata=src, modeldata=src,
                                   eventdata=src))
    app_id = storage.meta_apps().insert(RefApp(id=0, name=app_name))
    return storage, app_id


def _read_back(path):
    """An export's events without what a store gives each event anew
    (its id and creation time)."""
    out = []
    with open(path) as f:
        for line in f:
            d = json.loads(line)
            d.pop("eventId")
            d.pop("creationTime")
            out.append(d)
    return out


@pytest.mark.parametrize("exporter", ["port", "reference"])
def test_a_file_exported_by_one_package_imports_into_the_other(tmp_path,
                                                               exporter):
    """DIVERSE (and the import LINES) exported by one package's native
    writer import through the other's native importer; the other's
    export then reads back equal, event for event."""
    from predictionio_tpu import native as ref_native
    from predictionio_tpu.tools import transfer as ref_transfer

    if not ref_native.native_available():
        pytest.skip("the reference's native library did not build")
    src = tmp_path / "in.jsonl"
    with open(src, "w") as f:
        for obj in DIVERSE + [o for o in LINES if o is not None]:
            f.write(json.dumps(obj) + "\n")
    packages = {"port": (_mk_storage, transfer),
                "reference": (_ref_storage, ref_transfer)}
    other = "reference" if exporter == "port" else "port"
    mk_a, tr_a = packages[exporter]
    mk_b, tr_b = packages[other]
    st_a, _ = mk_a(tmp_path / "a.db", "A")
    st_b, _ = mk_b(tmp_path / "b.db", "B")
    try:
        n_in, skipped = tr_a.file_to_events(str(src), "A", storage=st_a)
        assert skipped == 0
        exported = tmp_path / "a.jsonl"
        assert tr_a.events_to_file(str(exported), "A",
                                   storage=st_a) == n_in
        assert tr_b.file_to_events(str(exported), "B",
                                   storage=st_b) == (n_in, 0)
        back = tmp_path / "b.jsonl"
        assert tr_b.events_to_file(str(back), "B", storage=st_b) == n_in
        assert _read_back(back) == _read_back(exported)
    finally:
        st_a.close()
        st_b.close()


def test_find_by_entity_right_after_a_native_bulk_import(tmp_path):
    """A native import into an empty store drops idx_events_* for the
    bulk load; `find` by entity and by target (which name
    idx_events_entity / idx_events_target) answer right after, and equal
    what the Python import gives."""
    path = tmp_path / "bulk.jsonl"
    with open(path, "w") as f:
        for i in range(300):
            f.write(json.dumps({
                "event": "view", "entityType": "user",
                "entityId": f"u{i % 17}", "targetEntityType": "item",
                "targetEntityId": f"i{i % 23}",
                "eventTime": f"2024-01-01T00:{i // 60:02d}:{i % 60:02d}Z"})
                + "\n")
    found = {}
    for tier in ("native", "python"):
        storage, app_id = _mk_storage(tmp_path / f"{tier}.db")
        try:
            calls = []
            real = native.import_events_native
            native.import_events_native = (
                lambda *a, **k: calls.append(1) or (
                    real(*a, **k) if tier == "native" else None))
            try:
                assert transfer.file_to_events(
                    str(path), "ImpApp", storage=storage) == (300, 0)
            finally:
                native.import_events_native = real
            assert calls == [1]
            conn = sqlite3.connect(tmp_path / f"{tier}.db")
            names = {r[0] for r in conn.execute(
                "SELECT name FROM sqlite_master WHERE type='index'")}
            conn.close()
            assert {"idx_events_entity", "idx_events_target"} <= names
            le = storage.l_events()
            by_user = le.find(app_id=app_id, entity_type="user",
                              entity_id="u3")
            by_item = le.find(app_id=app_id, target_entity_type="item",
                              target_entity_id="i5", reversed=True,
                              limit=4)
            found[tier] = (
                [(e.event_time, e.target_entity_id) for e in by_user],
                [(e.event_time, e.entity_id) for e in by_item])
        finally:
            storage.close()
    assert len(found["native"][0]) == 18 and len(found["native"][1]) == 4
    assert found["native"] == found["python"]
