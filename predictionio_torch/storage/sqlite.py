"""SQLite storage backend — own copy of the reference's
``predictionio_tpu/storage/sqlite.py``, with its schema and row encoding
unchanged: a ``pio.db`` written by either package reads back in the
other. `find_columnar` and `aggregate_properties_columnar` try the C++
readers first (``predictionio_torch/native``: ``pio_scan.cpp`` and
``pio_aggprops.cpp``, on file databases), as the reference does, and fall
back to the reference's pure-SQL tier; `find_columnar`'s SQL tier
computes event times exactly, as the C++ reader does (see `_sql_epoch`),
so both tiers return the same columns bit for bit.

One file (or ``:memory:``) holds metadata + events + model blobs. Connections
are per-thread (servers are multi-threaded); WAL mode keeps readers
and the single writer from blocking each other.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import random
import sqlite3
import threading
import time
import uuid
from datetime import datetime
from typing import Iterable, Optional, Sequence

from predictionio_torch.data.datamap import DataMap
from predictionio_torch.data.events import Event, format_time, parse_time
from predictionio_torch.storage import base
from predictionio_torch.telemetry import lineage
from predictionio_torch.utils import faults
from predictionio_torch.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    Model,
)

log = logging.getLogger(__name__)

_DEFAULT_BUSY_TIMEOUT_MS = 30000


def _busy_timeout_ms() -> int:
    """PIO_SQLITE_BUSY_TIMEOUT_MS — how long a connection waits on a
    competing writer before SQLITE_BUSY. The default matches the audited
    30 s posture; the chaos/repro tests set 0 to make lock contention
    fail fast instead of parking the suite on the handler."""
    raw = os.environ.get("PIO_SQLITE_BUSY_TIMEOUT_MS")
    if raw is None:
        return _DEFAULT_BUSY_TIMEOUT_MS
    try:
        return max(0, int(raw))
    except ValueError:
        log.warning("ignoring unparseable PIO_SQLITE_BUSY_TIMEOUT_MS=%r", raw)
        return _DEFAULT_BUSY_TIMEOUT_MS


_LOCK_RETRIES = 8
_LOCKED_MARKERS = ("database is locked", "database table is locked", "busy")


def _is_locked_error(exc: BaseException) -> bool:
    return isinstance(exc, sqlite3.OperationalError) and any(
        m in str(exc).lower() for m in _LOCKED_MARKERS)


def _retry_locked(fn):
    """Bounded retry for transient SQLITE_BUSY on write paths.

    The PRAGMA busy_timeout handler only covers waits INSIDE one sqlite
    call; a writer that loses the race at COMMIT (or at the first write
    of a deferred transaction) still surfaces "database is locked" to
    Python once the timeout lapses — observed in production as a 500 on
    /events.json when a group commit straddled a checkpoint. Each
    attempt re-runs the whole repository method on a rolled-back
    connection (event ids are assigned on first attempt and reused, so
    retries are idempotent). Backoff: 5 ms · 2^attempt, ±50% jitter,
    capped; anything that is not a locked/busy OperationalError — and
    the last attempt's failure — propagates unchanged.

    `functools.wraps` keeps the undecorated method on `__wrapped__`,
    which is how the regression test reproduces the original failure
    before asserting the wrapped path survives it."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        delay_s = 0.005
        for attempt in range(_LOCK_RETRIES):
            try:
                return fn(*args, **kwargs)
            except sqlite3.OperationalError as e:
                if not _is_locked_error(e) or attempt == _LOCK_RETRIES - 1:
                    raise
                log.debug("%s: database locked (attempt %d/%d) — retrying",
                          fn.__qualname__, attempt + 1, _LOCK_RETRIES)
                time.sleep(delay_s * (0.5 + random.random()))
                delay_s = min(delay_s * 2, 0.25)
        raise AssertionError("unreachable")

    return wrapper


_SCHEMA = """
CREATE TABLE IF NOT EXISTS apps (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT UNIQUE NOT NULL,
    description TEXT NOT NULL DEFAULT ''
);
CREATE TABLE IF NOT EXISTS access_keys (
    key TEXT PRIMARY KEY,
    app_id INTEGER NOT NULL,
    events TEXT NOT NULL DEFAULT '[]'
);
CREATE TABLE IF NOT EXISTS channels (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL,
    app_id INTEGER NOT NULL,
    UNIQUE(app_id, name)
);
CREATE TABLE IF NOT EXISTS engine_instances (
    id TEXT PRIMARY KEY,
    status TEXT NOT NULL,
    start_time TEXT NOT NULL,
    end_time TEXT NOT NULL,
    engine_id TEXT NOT NULL,
    engine_version TEXT NOT NULL,
    engine_variant TEXT NOT NULL,
    engine_factory TEXT NOT NULL,
    batch TEXT NOT NULL DEFAULT '',
    env TEXT NOT NULL DEFAULT '{}',
    data_source_params TEXT NOT NULL DEFAULT '{}',
    preparator_params TEXT NOT NULL DEFAULT '{}',
    algorithms_params TEXT NOT NULL DEFAULT '[]',
    serving_params TEXT NOT NULL DEFAULT '{}'
);
CREATE TABLE IF NOT EXISTS evaluation_instances (
    id TEXT PRIMARY KEY,
    status TEXT NOT NULL,
    start_time TEXT NOT NULL,
    end_time TEXT NOT NULL,
    evaluation_class TEXT NOT NULL,
    engine_params_generator_class TEXT NOT NULL,
    batch TEXT NOT NULL DEFAULT '',
    env TEXT NOT NULL DEFAULT '{}',
    evaluator_results TEXT NOT NULL DEFAULT '',
    evaluator_results_html TEXT NOT NULL DEFAULT '',
    evaluator_results_json TEXT NOT NULL DEFAULT ''
);
CREATE TABLE IF NOT EXISTS models (
    id TEXT PRIMARY KEY,
    models BLOB NOT NULL
);
CREATE TABLE IF NOT EXISTS events (
    id TEXT PRIMARY KEY,
    app_id INTEGER NOT NULL,
    channel_id INTEGER,
    event TEXT NOT NULL,
    entity_type TEXT NOT NULL,
    entity_id TEXT NOT NULL,
    target_entity_type TEXT,
    target_entity_id TEXT,
    properties TEXT NOT NULL DEFAULT '{}',
    event_time TEXT NOT NULL,
    tags TEXT NOT NULL DEFAULT '[]',
    pr_id TEXT,
    creation_time TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_events_scan
    ON events (app_id, channel_id, event_time);
CREATE INDEX IF NOT EXISTS idx_events_entity
    ON events (app_id, channel_id, entity_type, entity_id);
CREATE INDEX IF NOT EXISTS idx_events_target
    ON events (app_id, channel_id, target_entity_type, target_entity_id);
"""


class SQLiteBackend(base.StorageBackend):
    # uniqueness-violation exception classes
    integrity_errors: tuple = (sqlite3.IntegrityError,)

    def __init__(self, path: str = ":memory:"):
        self._init_conn_state(path)
        # :memory: must share one connection across threads (each connection
        # would otherwise get its own private database), serialized by a lock.
        # File databases get one connection per thread; WAL handles them.
        if path == ":memory:":
            self._shared = self._connect()
        self._init_schema()

    @_retry_locked
    def _init_schema(self) -> None:
        # several processes (pool workers, tools) may open one file at
        # once; the CREATE IF NOT EXISTS script is idempotent, so a
        # lock collision on first open just retries
        with self._cursor() as cur:
            cur.executescript(_SCHEMA)

    def _init_conn_state(self, path: str) -> None:
        """Connection bookkeeping."""
        self.path = path
        self._local = threading.local()
        self._shared = None  # set → one shared connection, lock-serialized
        self._shared_lock = threading.RLock()
        self._all_conns: list = []
        self._thread_conns: list = []  # (owner thread, conn) for reaping
        self._conns_lock = threading.Lock()

    def _connect(self) -> sqlite3.Connection:
        busy_ms = _busy_timeout_ms()
        conn = sqlite3.connect(self.path, check_same_thread=False,
                               timeout=busy_ms / 1000.0)
        conn.row_factory = sqlite3.Row
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=NORMAL")
        # busy_timeout mirrors the connect(timeout=...) handler at the
        # database level, so other connections to the file (another
        # process, the sqlite3 CLI) inherit the same patience instead of
        # an instant SQLITE_BUSY; wal_autocheckpoint=4000 moves checkpoint
        # work off the commit path 4× less often, for a worst-case -wal
        # file of 16 MB instead of 4 MB
        conn.execute(f"PRAGMA busy_timeout={busy_ms}")
        conn.execute("PRAGMA wal_autocheckpoint=4000")
        with self._conns_lock:
            # reap dead threads' connections HERE, where new ones are
            # born: per-thread conns live in threading.local, but
            # _all_conns' strong reference kept a dead handler thread's
            # connection (and its db+wal fds) alive forever — in a
            # long-lived server whose HTTP layer spawns a thread per
            # client connection, that's an unbounded fd leak (~2 fds per
            # /reload; found by the round-5 10-minute soak drill)
            dead = [(t, c) for t, c in self._thread_conns
                    if not t.is_alive() and c is not self._shared]
            for t, c in dead:
                self._thread_conns.remove((t, c))
                try:
                    self._all_conns.remove(c)
                except ValueError:
                    pass
                try:
                    c.close()
                except Exception:
                    pass
            self._all_conns.append(conn)
            self._thread_conns.append((threading.current_thread(), conn))
        return conn

    def _conn(self) -> sqlite3.Connection:
        if self._shared is not None:
            return self._shared
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._connect()
            self._local.conn = conn
        return conn

    class _Cursor:
        def __init__(self, backend: "SQLiteBackend"):
            self._b = backend
            # Only the shared :memory: connection needs cross-thread
            # serialization; file DBs use per-thread connections + WAL.
            self._locked = backend._shared is not None

        def __enter__(self) -> sqlite3.Cursor:
            if self._locked:
                self._b._shared_lock.acquire()
            self._cur = self._b._conn().cursor()
            return self._cur

        def __exit__(self, exc_type, exc, tb):
            try:
                if exc_type is None:
                    try:
                        # `sqlite.pre_commit` fault site: delay: holds the
                        # write lock across the sleep (the transaction is
                        # open) — the lever the locked-database regression
                        # test uses to stage a real writer collision
                        faults.inject("sqlite.pre_commit")
                        self._cur.connection.commit()
                    except Exception:
                        # a busy COMMIT leaves the transaction open on
                        # this connection; roll it back so the caller's
                        # bounded retry (_retry_locked) re-runs clean
                        self._cur.connection.rollback()
                        raise
                else:
                    self._cur.connection.rollback()
                self._cur.close()
            finally:
                if self._locked:
                    self._b._shared_lock.release()

    def _cursor(self) -> "_Cursor":
        return SQLiteBackend._Cursor(self)

    # -- columnar-scan SQL fragments ---------------------------------------
    def _sql_epoch(self, col: str) -> str:
        """Float unix seconds from an event-time column (stored as
        fixed-width UTC ISO-8601 text, `YYYY-MM-DDTHH:MM:SS.ffffffZ`):
        whole seconds and microseconds as one integer, divided once, so
        the value equals Python's `datetime.timestamp()` bit for bit. (The
        reference's SQL tier takes julianday, ~20 µs off at today's
        dates; its C++ reader is exact, and this matches it.)"""
        return (f"((CAST(strftime('%s', substr({col}, 1, 19)) AS INTEGER)"
                f" * 1000000 + CAST(substr({col}, 21, 6) AS INTEGER))"
                f" / 1000000.0)")

    def _sql_json_num(self, col: str) -> str:
        """Numeric value of a JSON property; every `?` receives
        `_json_key_param(key)` (see `_json_num_param_count`). NULL when
        absent or non-numeric: json_type gates the CAST so a non-numeric
        text value becomes missing (NaN downstream) instead of CAST's
        silent 0.0 — matching the generic fallback
        (data/columnar.py::numeric_or_none)."""
        t = f"json_type({col}, ?)"
        v = f"json_extract({col}, ?)"
        return (
            f"CASE {t} "
            f"WHEN 'integer' THEN {v} "
            f"WHEN 'real' THEN {v} "
            f"WHEN 'true' THEN 1.0 "
            f"WHEN 'false' THEN 0.0 "
            f"WHEN 'text' THEN (CASE WHEN {v} GLOB '[0-9]*' "
            f"OR {v} GLOB '[+-][0-9]*' OR {v} GLOB '.[0-9]*' "
            f"OR {v} GLOB '[+-].[0-9]*' THEN CAST({v} AS REAL) END) "
            f"END"
        )

    #: how many times `_json_key_param(key)` must be bound for one
    #: `_sql_json_num` expression (count of `?` in it)
    _json_num_param_count = 8

    def _json_key_param(self, key: str) -> str:
        return "$." + key

    def _sql_inf(self) -> str:
        """A +infinity literal (missing-value sentinel; JSON cannot encode
        infinity, so it cannot collide with a stored property value)."""
        return "9e999"

    def _begin_snapshot(self, cur) -> None:
        """Open a read transaction pinning one snapshot for the columnar
        scan's multiple SELECTs (id-uniques + coded rows must agree —
        concurrent ingestion between them would shift every dense_rank
        code). sqlite in WAL: a plain BEGIN pins the snapshot."""
        cur.execute("BEGIN")

    def _native_scan_path(self) -> Optional[str]:
        """DB path for the C++ columnar readers (pio_scan.cpp,
        pio_aggprops.cpp), or None when they can't apply: :memory:/URI
        databases a second connection can't see."""
        if self.path == ":memory:" or self.path.startswith("file:"):
            return None
        return self.path

    # -- property-aggregation pushdown SQL fragments -----------------------
    def _agg_json_each(self, tbl: str) -> str:
        """Table-valued join clause exploding `{tbl}.properties` into one
        row per top-level key, exposing je.key / je.value / je.id (id =
        document order, the duplicate-key tiebreak)."""
        return f"json_each({tbl}.properties) je"

    def _agg_value_expr(self) -> str:
        """JSON text of je's value, type-exact: booleans as true/false
        (json_quote would give 1/0), reals re-extracted through the `->`
        operator for shortest-roundtrip precision (json_quote renders
        %.15g, dropping the 16th/17th digit), arrays and objects as the
        JSON text json_each gives them (from sqlite 3.45 that text comes
        without the JSON subtype, and json_quote would turn a list into a
        string). `-> fullkey` is NULL for
        keys containing '"' or '\\' (sqlite's path parser rejects its own
        escaping) — the query surfaces that as nbail > 0 and the caller
        falls back to the per-event Python fold rather than lose a ULP."""
        return ("CASE je.type WHEN 'real' THEN s.properties -> je.fullkey "
                "WHEN 'true' THEN 'true' WHEN 'false' THEN 'false' "
                "WHEN 'array' THEN je.value WHEN 'object' THEN je.value "
                "ELSE json_quote(je.value) END")

    def _agg_group_object(self) -> str:
        """Aggregate winners (w.k, w.jv JSON text) into one JSON object."""
        return "json_group_object(w.k, json(w.jv))"

    # repository accessors
    def apps(self) -> "SQLiteApps":
        return SQLiteApps(self)

    def access_keys(self) -> "SQLiteAccessKeys":
        return SQLiteAccessKeys(self)

    def channels(self) -> "SQLiteChannels":
        return SQLiteChannels(self)

    def engine_instances(self) -> "SQLiteEngineInstances":
        return SQLiteEngineInstances(self)

    def evaluation_instances(self) -> "SQLiteEvaluationInstances":
        return SQLiteEvaluationInstances(self)

    def models(self) -> "SQLiteModels":
        return SQLiteModels(self)

    def events(self) -> "SQLiteLEvents":
        return SQLiteLEvents(self)

    def close(self) -> None:
        with self._conns_lock:
            for conn in self._all_conns:
                try:
                    conn.close()
                except Exception:
                    # a close error must not leak the remaining
                    # connections
                    pass
            self._all_conns.clear()
            self._thread_conns.clear()
        self._shared = None
        self._local = threading.local()


class SQLiteApps(base.Apps):
    def __init__(self, backend: SQLiteBackend):
        self._b = backend

    def insert(self, app: App) -> Optional[int]:
        try:
            with self._b._cursor() as cur:
                cur.execute(
                    "INSERT INTO apps (name, description) VALUES (?, ?)",
                    (app.name, app.description),
                )
                return cur.lastrowid
        except self._b.integrity_errors:
            return None

    def get(self, app_id: int) -> Optional[App]:
        with self._b._cursor() as cur:
            row = cur.execute("SELECT * FROM apps WHERE id=?", (app_id,)).fetchone()
        return App(row["id"], row["name"], row["description"]) if row else None

    def get_by_name(self, name: str) -> Optional[App]:
        with self._b._cursor() as cur:
            row = cur.execute("SELECT * FROM apps WHERE name=?", (name,)).fetchone()
        return App(row["id"], row["name"], row["description"]) if row else None

    def get_all(self) -> list[App]:
        with self._b._cursor() as cur:
            rows = cur.execute("SELECT * FROM apps ORDER BY id").fetchall()
        return [App(r["id"], r["name"], r["description"]) for r in rows]

    def update(self, app: App) -> bool:
        with self._b._cursor() as cur:
            cur.execute(
                "UPDATE apps SET name=?, description=? WHERE id=?",
                (app.name, app.description, app.id),
            )
            return cur.rowcount > 0

    def delete(self, app_id: int) -> bool:
        with self._b._cursor() as cur:
            cur.execute("DELETE FROM apps WHERE id=?", (app_id,))
            return cur.rowcount > 0


class SQLiteAccessKeys(base.AccessKeys):
    def __init__(self, backend: SQLiteBackend):
        self._b = backend

    def insert(self, access_key: AccessKey) -> Optional[str]:
        try:
            with self._b._cursor() as cur:
                cur.execute(
                    "INSERT INTO access_keys (key, app_id, events) VALUES (?, ?, ?)",
                    (access_key.key, access_key.app_id, json.dumps(access_key.events)),
                )
            return access_key.key
        except self._b.integrity_errors:
            return None

    def get(self, key: str) -> Optional[AccessKey]:
        with self._b._cursor() as cur:
            row = cur.execute("SELECT * FROM access_keys WHERE key=?", (key,)).fetchone()
        if row is None:
            return None
        return AccessKey(row["key"], row["app_id"], json.loads(row["events"]))

    def get_by_app_id(self, app_id: int) -> list[AccessKey]:
        with self._b._cursor() as cur:
            rows = cur.execute("SELECT * FROM access_keys WHERE app_id=?", (app_id,)).fetchall()
        return [AccessKey(r["key"], r["app_id"], json.loads(r["events"])) for r in rows]

    def delete(self, key: str) -> bool:
        with self._b._cursor() as cur:
            cur.execute("DELETE FROM access_keys WHERE key=?", (key,))
            return cur.rowcount > 0


class SQLiteChannels(base.Channels):
    def __init__(self, backend: SQLiteBackend):
        self._b = backend

    def insert(self, channel: Channel) -> Optional[int]:
        if not Channel.is_valid_name(channel.name):
            return None
        try:
            with self._b._cursor() as cur:
                cur.execute(
                    "INSERT INTO channels (name, app_id) VALUES (?, ?)",
                    (channel.name, channel.app_id),
                )
                return cur.lastrowid
        except self._b.integrity_errors:
            return None

    def get(self, channel_id: int) -> Optional[Channel]:
        with self._b._cursor() as cur:
            row = cur.execute("SELECT * FROM channels WHERE id=?", (channel_id,)).fetchone()
        return Channel(row["id"], row["name"], row["app_id"]) if row else None

    def get_by_app_id(self, app_id: int) -> list[Channel]:
        with self._b._cursor() as cur:
            rows = cur.execute(
                "SELECT * FROM channels WHERE app_id=? ORDER BY id", (app_id,)
            ).fetchall()
        return [Channel(r["id"], r["name"], r["app_id"]) for r in rows]

    def delete(self, channel_id: int) -> bool:
        with self._b._cursor() as cur:
            cur.execute("DELETE FROM channels WHERE id=?", (channel_id,))
            return cur.rowcount > 0


def _ei_from_row(row: sqlite3.Row) -> EngineInstance:
    return EngineInstance(
        id=row["id"],
        status=row["status"],
        start_time=parse_time(row["start_time"]),
        end_time=parse_time(row["end_time"]),
        engine_id=row["engine_id"],
        engine_version=row["engine_version"],
        engine_variant=row["engine_variant"],
        engine_factory=row["engine_factory"],
        batch=row["batch"],
        env=json.loads(row["env"]),
        data_source_params=row["data_source_params"],
        preparator_params=row["preparator_params"],
        algorithms_params=row["algorithms_params"],
        serving_params=row["serving_params"],
    )


class SQLiteEngineInstances(base.EngineInstances):
    def __init__(self, backend: SQLiteBackend):
        self._b = backend

    # training status writes race serving-side readers and the event
    # writer on one file; a transient lock here would fail a whole train
    @_retry_locked
    def insert(self, instance: EngineInstance) -> str:
        iid = instance.id or uuid.uuid4().hex
        instance.id = iid
        with self._b._cursor() as cur:
            cur.execute(
                "INSERT INTO engine_instances VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                (
                    iid,
                    instance.status,
                    format_time(instance.start_time),
                    format_time(instance.end_time),
                    instance.engine_id,
                    instance.engine_version,
                    instance.engine_variant,
                    instance.engine_factory,
                    instance.batch,
                    json.dumps(instance.env),
                    instance.data_source_params,
                    instance.preparator_params,
                    instance.algorithms_params,
                    instance.serving_params,
                ),
            )
        return iid

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        with self._b._cursor() as cur:
            row = cur.execute(
                "SELECT * FROM engine_instances WHERE id=?", (instance_id,)
            ).fetchone()
        return _ei_from_row(row) if row else None

    def get_all(self) -> list[EngineInstance]:
        with self._b._cursor() as cur:
            rows = cur.execute(
                "SELECT * FROM engine_instances ORDER BY start_time DESC"
            ).fetchall()
        return [_ei_from_row(r) for r in rows]

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[EngineInstance]:
        with self._b._cursor() as cur:
            row = cur.execute(
                "SELECT * FROM engine_instances WHERE status='COMPLETED' "
                "AND engine_id=? AND engine_version=? AND engine_variant=? "
                "ORDER BY start_time DESC LIMIT 1",
                (engine_id, engine_version, engine_variant),
            ).fetchone()
        return _ei_from_row(row) if row else None

    @_retry_locked
    def update(self, instance: EngineInstance) -> None:
        with self._b._cursor() as cur:
            cur.execute(
                "UPDATE engine_instances SET status=?, start_time=?, end_time=?, "
                "engine_id=?, engine_version=?, engine_variant=?, engine_factory=?, "
                "batch=?, env=?, data_source_params=?, preparator_params=?, "
                "algorithms_params=?, serving_params=? WHERE id=?",
                (
                    instance.status,
                    format_time(instance.start_time),
                    format_time(instance.end_time),
                    instance.engine_id,
                    instance.engine_version,
                    instance.engine_variant,
                    instance.engine_factory,
                    instance.batch,
                    json.dumps(instance.env),
                    instance.data_source_params,
                    instance.preparator_params,
                    instance.algorithms_params,
                    instance.serving_params,
                    instance.id,
                ),
            )

    def delete(self, instance_id: str) -> bool:
        with self._b._cursor() as cur:
            cur.execute("DELETE FROM engine_instances WHERE id=?", (instance_id,))
            return cur.rowcount > 0


class SQLiteEvaluationInstances(base.EvaluationInstances):
    def __init__(self, backend: SQLiteBackend):
        self._b = backend

    def insert(self, instance: EvaluationInstance) -> str:
        iid = instance.id or uuid.uuid4().hex
        instance.id = iid
        with self._b._cursor() as cur:
            cur.execute(
                "INSERT INTO evaluation_instances VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                (
                    iid,
                    instance.status,
                    format_time(instance.start_time),
                    format_time(instance.end_time),
                    instance.evaluation_class,
                    instance.engine_params_generator_class,
                    instance.batch,
                    json.dumps(instance.env),
                    instance.evaluator_results,
                    instance.evaluator_results_html,
                    instance.evaluator_results_json,
                ),
            )
        return iid

    def _from_row(self, row: sqlite3.Row) -> EvaluationInstance:
        return EvaluationInstance(
            id=row["id"],
            status=row["status"],
            start_time=parse_time(row["start_time"]),
            end_time=parse_time(row["end_time"]),
            evaluation_class=row["evaluation_class"],
            engine_params_generator_class=row["engine_params_generator_class"],
            batch=row["batch"],
            env=json.loads(row["env"]),
            evaluator_results=row["evaluator_results"],
            evaluator_results_html=row["evaluator_results_html"],
            evaluator_results_json=row["evaluator_results_json"],
        )

    def get(self, instance_id: str) -> Optional[EvaluationInstance]:
        with self._b._cursor() as cur:
            row = cur.execute(
                "SELECT * FROM evaluation_instances WHERE id=?", (instance_id,)
            ).fetchone()
        return self._from_row(row) if row else None

    def get_completed(self) -> list[EvaluationInstance]:
        with self._b._cursor() as cur:
            rows = cur.execute(
                "SELECT * FROM evaluation_instances WHERE status='EVALCOMPLETED' "
                "ORDER BY start_time DESC"
            ).fetchall()
        return [self._from_row(r) for r in rows]

    def update(self, instance: EvaluationInstance) -> None:
        with self._b._cursor() as cur:
            cur.execute(
                "UPDATE evaluation_instances SET status=?, start_time=?, end_time=?, "
                "evaluation_class=?, engine_params_generator_class=?, batch=?, env=?, "
                "evaluator_results=?, evaluator_results_html=?, evaluator_results_json=? "
                "WHERE id=?",
                (
                    instance.status,
                    format_time(instance.start_time),
                    format_time(instance.end_time),
                    instance.evaluation_class,
                    instance.engine_params_generator_class,
                    instance.batch,
                    json.dumps(instance.env),
                    instance.evaluator_results,
                    instance.evaluator_results_html,
                    instance.evaluator_results_json,
                    instance.id,
                ),
            )

    def delete(self, instance_id: str) -> bool:
        with self._b._cursor() as cur:
            cur.execute("DELETE FROM evaluation_instances WHERE id=?", (instance_id,))
            return cur.rowcount > 0


class SQLiteModels(base.Models):
    def __init__(self, backend: SQLiteBackend):
        self._b = backend

    @_retry_locked
    def insert(self, model: Model) -> None:
        with self._b._cursor() as cur:
            cur.execute(
                "INSERT OR REPLACE INTO models (id, models) VALUES (?, ?)",
                (model.id, model.models),
            )

    def get(self, model_id: str) -> Optional[Model]:
        with self._b._cursor() as cur:
            row = cur.execute("SELECT * FROM models WHERE id=?", (model_id,)).fetchone()
        return Model(row["id"], row["models"]) if row else None

    def delete(self, model_id: str) -> bool:
        with self._b._cursor() as cur:
            cur.execute("DELETE FROM models WHERE id=?", (model_id,))
            return cur.rowcount > 0


class SQLiteLEvents(base.LEvents):
    def __init__(self, backend: SQLiteBackend):
        self._b = backend

    @property
    def integrity_errors(self) -> tuple:
        # the backend's, for API-level duplicate handling
        return self._b.integrity_errors

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        return True  # single events table; nothing to create per app

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self._b._cursor() as cur:
            if channel_id is None:
                cur.execute("DELETE FROM events WHERE app_id=? AND channel_id IS NULL", (app_id,))
            else:
                cur.execute(
                    "DELETE FROM events WHERE app_id=? AND channel_id=?", (app_id, channel_id)
                )
        return True

    @staticmethod
    def _row_of(event: Event, app_id: int, channel_id: Optional[int]) -> tuple:
        eid = event.event_id or uuid.uuid4().hex
        event.event_id = eid
        # The causal-lineage context (attached by the event server after
        # validate_event, which rejects client-supplied pio_* property
        # keys) rides inside the properties JSON — no schema change, and
        # _event_from_row strips it symmetrically on every read path.
        ctx = getattr(event, "lineage_ctx", None)
        if ctx is None:
            props_json = event.properties.to_json()
        else:
            props = event.properties.to_dict()
            props[lineage.ENVELOPE_KEY] = ctx.to_dict()
            props_json = json.dumps(props, sort_keys=True)
        return (
            eid,
            app_id,
            channel_id,
            event.event,
            event.entity_type,
            event.entity_id,
            event.target_entity_type,
            event.target_entity_id,
            props_json,
            format_time(event.event_time),
            json.dumps(event.tags),
            event.pr_id,
            format_time(event.creation_time),
        )

    _INSERT_SQL = "INSERT INTO events VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)"

    # the three event-write entry points retry transient lock collisions
    # (see _retry_locked); _row_of assigns event ids on the FIRST attempt
    # and reuses them, so a retried insert cannot duplicate an event
    @_retry_locked
    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        row = self._row_of(event, app_id, channel_id)
        with self._b._cursor() as cur:
            cur.execute(self._INSERT_SQL, row)
        return row[0]

    @_retry_locked
    def insert_batch(
        self, events: list[Event], app_id: int,
        channel_id: Optional[int] = None,
    ) -> list[str]:
        """One transaction + executemany: a per-event insert pays a commit
        per row, capping bulk import at ~9k events/s; batched import runs
        the whole chunk under one commit."""
        rows = [self._row_of(e, app_id, channel_id) for e in events]
        with self._b._cursor() as cur:
            cur.executemany(self._INSERT_SQL, rows)
            faults.inject("events.batch.pre_commit")
        return [r[0] for r in rows]

    @_retry_locked
    def insert_grouped(
        self, items: "list[tuple[Event, int, Optional[int]]]",
    ) -> list[str]:
        """Group commit for the ingest write plane: heterogeneous
        (event, app_id, channel_id) rows from concurrent single-event
        requests land under ONE transaction — one WAL append + fsync for
        the whole group instead of one per request. Returning implies
        durability (the `_Cursor` context commits before this returns),
        which is what lets the write plane acknowledge every caller's
        201 at once."""
        rows = [self._row_of(e, a, c) for e, a, c in items]
        with self._b._cursor() as cur:
            cur.executemany(self._INSERT_SQL, rows)
            faults.inject("events.group.pre_commit")
        return [r[0] for r in rows]

    @staticmethod
    def _event_from_row(row: sqlite3.Row) -> Event:
        properties = DataMap.from_json(row["properties"])
        ctx = None
        if lineage.ENVELOPE_KEY in properties:
            ctx = lineage.CausalContext.from_dict(
                properties[lineage.ENVELOPE_KEY])
            properties = properties.drop((lineage.ENVELOPE_KEY,))
        event = Event(
            event=row["event"],
            entity_type=row["entity_type"],
            entity_id=row["entity_id"],
            target_entity_type=row["target_entity_type"],
            target_entity_id=row["target_entity_id"],
            properties=properties,
            event_time=parse_time(row["event_time"]),
            tags=json.loads(row["tags"]),
            pr_id=row["pr_id"],
            creation_time=parse_time(row["creation_time"]),
            event_id=row["id"],
        )
        if ctx is not None:
            event.lineage_ctx = ctx
        return event

    @staticmethod
    def _channel_clause(channel_id: Optional[int]) -> tuple[str, list]:
        if channel_id is None:
            return "channel_id IS NULL", []
        return "channel_id=?", [channel_id]

    def get(
        self, event_id: str, app_id: int, channel_id: Optional[int] = None
    ) -> Optional[Event]:
        ch_sql, ch_params = self._channel_clause(channel_id)
        with self._b._cursor() as cur:
            row = cur.execute(
                f"SELECT * FROM events WHERE id=? AND app_id=? AND {ch_sql}",
                [event_id, app_id, *ch_params],
            ).fetchone()
        return self._event_from_row(row) if row else None

    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool:
        ch_sql, ch_params = self._channel_clause(channel_id)
        with self._b._cursor() as cur:
            cur.execute(
                f"DELETE FROM events WHERE id=? AND app_id=? AND {ch_sql}",
                [event_id, app_id, *ch_params],
            )
            return cur.rowcount > 0

    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str | Sequence[str]] = None,
        event_names: Optional[list[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str | Sequence[str]] = None,
        limit: Optional[int] = None,
        reversed: bool = False,
    ) -> Iterable[Event]:
        clauses = ["app_id=?"]
        params: list = [app_id]
        if channel_id is None:
            clauses.append("channel_id IS NULL")
        else:
            clauses.append("channel_id=?")
            params.append(channel_id)
        if start_time is not None:
            clauses.append("event_time>=?")
            params.append(format_time(start_time))
        if until_time is not None:
            clauses.append("event_time<?")
            params.append(format_time(until_time))
        if entity_type is not None:
            clauses.append("entity_type=?")
            params.append(entity_type)
        # entity filters accept one id or a batch of ids (one IN query
        # instead of N point lookups — the online fold plane's cold
        # fetches would otherwise convoy on the GIL/store lock)
        for col, want in (("entity_id", entity_id),
                          ("target_entity_id", target_entity_id)):
            if want is None:
                continue
            if isinstance(want, str):
                clauses.append(f"{col}=?")
                params.append(want)
            else:
                ids = list(want)
                if not ids:
                    return []
                clauses.append(f"{col} IN ({','.join('?' * len(ids))})")
                params.extend(ids)
        if target_entity_type is not None:
            clauses.append("target_entity_type=?")
            params.append(target_entity_type)
        if event_names:
            clauses.append(f"event IN ({','.join('?' * len(event_names))})")
            params.extend(event_names)
        order = "DESC" if reversed else "ASC"
        # a lookup by entity seeks that entity's index: left to itself,
        # sqlite walks idx_events_scan to skip the ORDER BY's sort, which
        # reads every event of the app for one user's few
        index = ""
        if entity_type is not None and entity_id is not None:
            index = " INDEXED BY idx_events_entity"
        elif target_entity_type is not None and target_entity_id is not None:
            index = " INDEXED BY idx_events_target"
        sql = (
            f"SELECT * FROM events{index} WHERE {' AND '.join(clauses)} "
            f"ORDER BY event_time {order}, creation_time {order}, id {order}"
        )
        if limit is not None and limit >= 0:
            sql += " LIMIT ?"
            params.append(limit)
        with self._b._cursor() as cur:
            rows = cur.execute(sql, params).fetchall()
        return [self._event_from_row(r) for r in rows]

    def find_columnar(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
        entity_type: Optional[str] = None,
        target_entity_type: Optional[str] = None,
        event_names: Optional[list[str]] = None,
        value_key: Optional[str] = None,
        ordered: bool = True,
    ):
        """Pushed-down columnar scan (the reference's `HBPEvents`
        TableInputFormat-scan role) — no per-event Python objects. On a
        file database the C++ reader (native/pio_scan.cpp) walks the rows
        once and fills the columns; otherwise, or when it is unavailable
        or bails, string→int coding via `dense_rank()` windows, values via
        `json_extract`, so the only per-row Python work is one numeric
        tuple.

        `ordered=False` skips the (event_time, creation_time, id) output sort
        — order-invariant consumers like ALS save a full-table sort.

        BiMap codes follow sorted distinct-id order: SQLite's BINARY
        collation is bytewise, which equals Python's codepoint sort for
        valid UTF-8, so `dense_rank() OVER (ORDER BY entity_id)` agrees
        with `BiMap.string_int(sorted(ids))` on every input.
        """
        from predictionio_torch.data.bimap import BiMap
        from predictionio_torch.data.columnar import (
            SPECIAL_EVENTS,
            EventColumns,
            columns_from_numeric_rows,
        )

        b = self._b
        clauses = ["app_id=?"]
        where_params: list = [app_id]
        if channel_id is None:
            clauses.append("channel_id IS NULL")
        else:
            clauses.append("channel_id=?")
            where_params.append(channel_id)
        if start_time is not None:
            clauses.append("event_time>=?")
            where_params.append(format_time(start_time))
        if until_time is not None:
            clauses.append("event_time<?")
            where_params.append(format_time(until_time))
        if entity_type is not None:
            clauses.append("entity_type=?")
            where_params.append(entity_type)
        if target_entity_type is not None:
            clauses.append("target_entity_type=?")
            where_params.append(target_entity_type)

        if event_names is None:
            marks = ",".join("?" * len(SPECIAL_EVENTS))
            with b._cursor() as cur:
                event_names = [r[0] for r in cur.execute(
                    f"SELECT DISTINCT event FROM events "
                    f"WHERE {' AND '.join(clauses)} AND event NOT IN ({marks}) "
                    f"ORDER BY event",
                    [*where_params, *SPECIAL_EVENTS]).fetchall()]
        if not event_names:
            # empty (passed or discovered): selects nothing — never fall
            # through to an unfiltered scan that would leak special events
            return columns_from_numeric_rows([], [], [], [])
        clauses.append(f"event IN ({','.join('?' * len(event_names))})")
        where_params.extend(event_names)
        where = " AND ".join(clauses)

        native_path = b._native_scan_path()
        if native_path is not None:
            from predictionio_torch import native as native_mod

            raw_sql = (
                "SELECT entity_id, target_entity_id, event, properties, "
                f"event_time FROM events WHERE {where}"
            )
            if ordered:
                raw_sql += " ORDER BY event_time, creation_time, id"
            out = native_mod.columnar_scan_native(
                native_path, raw_sql, where_params, value_key, event_names)
            if out is not None:
                ent, tgt, ev, val, tim, ent_ids, tgt_ids = out
                return EventColumns(
                    entity_ids=ent, target_ids=tgt, event_codes=ev,
                    values=val, times=tim,
                    entity_bimap=BiMap.string_int(ent_ids),
                    target_bimap=BiMap.string_int(tgt_ids),
                    event_names=list(event_names),
                )

        with b._cursor() as cur:
            # one snapshot for uniques + coded rows: a concurrent insert
            # between these statements would otherwise shift dense_rank
            # codes relative to the BiMap built from the uniques
            b._begin_snapshot(cur)
            entity_uniques = [r[0] for r in cur.execute(
                f"SELECT DISTINCT entity_id FROM events WHERE {where} "
                f"ORDER BY entity_id", where_params).fetchall()]
            target_uniques = [r[0] for r in cur.execute(
                f"SELECT DISTINCT target_entity_id FROM events WHERE {where} "
                f"AND target_entity_id IS NOT NULL ORDER BY target_entity_id",
                where_params).fetchall()]

            event_case = "CASE event " + " ".join(
                f"WHEN ? THEN {i}" for i in range(len(event_names))
            ) + " ELSE -1 END" if event_names else "-1"
            if value_key is not None:
                value_expr = (f"COALESCE({b._sql_json_num('properties')}, "
                              f"{b._sql_inf()})")
                value_params = ([b._json_key_param(value_key)]
                                * b._json_num_param_count)
            else:
                value_expr = b._sql_inf()
                value_params = []
            sql = (
                "SELECT dense_rank() OVER (ORDER BY entity_id) - 1, "
                "CASE WHEN target_entity_id IS NULL THEN -1 ELSE "
                "dense_rank() OVER (ORDER BY target_entity_id NULLS LAST) - 1 "
                "END, "
                f"{event_case}, {value_expr}, "
                f"{b._sql_epoch('event_time')} "
                f"FROM events WHERE {where}"
            )
            if ordered:
                sql += " ORDER BY event_time, creation_time, id"
            rows = cur.execute(
                sql, [*event_names, *value_params, *where_params]).fetchall()
        return columns_from_numeric_rows(
            rows, entity_uniques, target_uniques, event_names)

    def aggregate_properties_columnar(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None,
        entity_type: Optional[str] = None,
        required: Optional[list] = None,
    ):
        """Pushed-down `$set/$unset/$delete` fold (the
        «aggregateProperties» HBase-scan role) — the property-path sibling
        of `find_columnar`. No per-EVENT Python object; the host parses one
        JSON object per surviving ENTITY. Three tiers, identical results:

        - C++ reader (native/pio_aggprops.cpp): streams rows once via
          the sqlite3 C API, folds with raw JSON value spans, hands back
          a packed per-entity blob (file-backed DBs).
        - Pure SQL: window functions assign a (event_time,
          creation_time) sequence, `json_each` explodes $set/$unset
          bags, latest-set-wins per (entity, key) with $unset/$delete
          tombstones resolved by sequence comparison, and
          `json_group_object` re-assembles each entity server-side. The
          `required` filter is pushed into the query.
        - Returns None when neither tier can run or keep a value exact
          (no toolchain AND float-valued keys containing '"', where
          sqlite's `-> fullkey` extraction fails); the caller then falls
          back to the per-event Python fold, the semantics oracle.

        Returns dict[entity_id, (fields_dict, first_updated,
        last_updated)] or None.
        """
        b = self._b
        clauses = ["app_id=?"]
        params: list = [app_id]
        if channel_id is None:
            clauses.append("channel_id IS NULL")
        else:
            clauses.append("channel_id=?")
            params.append(channel_id)
        if start_time is not None:
            clauses.append("event_time>=?")
            params.append(format_time(start_time))
        if until_time is not None:
            clauses.append("event_time<?")
            params.append(format_time(until_time))
        if entity_type is not None:
            clauses.append("entity_type=?")
            params.append(entity_type)
        clauses.append("event IN ('$set','$unset','$delete')")
        where = " AND ".join(clauses)

        native_path = b._native_scan_path()
        if native_path is not None:
            from predictionio_torch import native as native_mod

            raw_sql = (
                "SELECT entity_id, event, properties, event_time "
                f"FROM events WHERE {where} "
                "ORDER BY event_time, creation_time, id"
            )
            rows = native_mod.agg_props_native(
                native_path, raw_sql, params, required)
            if rows is not None:
                out = self._agg_rows_to_dict(rows)
                if out is not None:
                    return out

        # dedupe: the oracle's `all(k in p for k in required)` is
        # set-semantics, but the HAVING below counts DISTINCT winner rows
        # — a duplicated required key (e.g. labelAttribute repeated in
        # attributes) would make COUNT(*) == len(required) unsatisfiable
        # and silently drop every entity
        req = list(dict.fromkeys(required or []))
        req_cte = ""
        req_join = ""
        req_params: list = []
        if req:
            # winners has at most one row per (entity, key), so a plain
            # COUNT suffices; an INNER JOIN keeps only complete entities
            marks = ",".join("?" * len(req))
            req_cte = (
                ", reqok AS ("
                f"  SELECT w.entity_id FROM winners w WHERE w.k IN ({marks})"
                "  GROUP BY w.entity_id HAVING COUNT(*) = ?"
                ")"
            )
            req_join = " JOIN reqok ON e.entity_id=reqok.entity_id"
            req_params = [*req, len(req)]
        sql = (
            "WITH ev AS MATERIALIZED ("
            "  SELECT entity_id, event, properties, event_time,"
            "         row_number() OVER (ORDER BY event_time, creation_time, id)"
            "           AS seq"
            f"  FROM events WHERE {where}"
            # tombstone resolution as ONE window pass: a join against a
            # per-entity MAX($delete seq) table nested-loops here (sqlite
            # doesn't auto-index that join shape — measured quadratic at
            # 2M events), while the window is one sort
            "), live AS MATERIALIZED ("
            "  SELECT entity_id, event, properties, event_time, seq FROM ("
            "    SELECT ev.*, MAX(CASE WHEN event='$delete' THEN seq END)"
            "           OVER (PARTITION BY entity_id) AS dseq FROM ev)"
            "  WHERE dseq IS NULL OR seq > dseq"
            "), ent AS ("
            "  SELECT entity_id, MIN(seq) AS cseq, MIN(event_time) AS first_up"
            "  FROM live WHERE event='$set' GROUP BY entity_id"
            "), lastu AS ("
            "  SELECT l.entity_id, MAX(l.event_time) AS last_up"
            "  FROM live l JOIN ent e ON l.entity_id=e.entity_id"
            "  WHERE l.event='$set' OR (l.event='$unset' AND l.seq > e.cseq)"
            "  GROUP BY l.entity_id"
            "), setkv AS MATERIALIZED ("
            f"  SELECT s.entity_id, je.key AS k, s.seq AS seq, je.id AS nid,"
            f"         {b._agg_value_expr()} AS jv"
            f"  FROM live s, {b._agg_json_each('s')}"
            "  WHERE s.event='$set'"
            "), unsetk AS ("
            "  SELECT u.entity_id, je.key AS k, MAX(u.seq) AS useq"
            f"  FROM live u, {b._agg_json_each('u')}"
            "  WHERE u.event='$unset'"
            "  GROUP BY u.entity_id, je.key"
            "), ranked AS ("
            "  SELECT entity_id, k, jv, seq,"
            "         row_number() OVER (PARTITION BY entity_id, k"
            "                            ORDER BY seq DESC, nid DESC) AS rn"
            "  FROM setkv"
            "), winners AS MATERIALIZED ("
            "  SELECT r.entity_id, r.k, r.jv, r.seq"
            "  FROM ranked r LEFT JOIN unsetk un"
            "    ON r.entity_id=un.entity_id AND r.k=un.k"
            "  WHERE r.rn=1 AND (un.useq IS NULL OR un.useq < r.seq)"
            "), bail AS ("
            "  SELECT COUNT(*) AS nbail FROM setkv WHERE jv IS NULL"
            "), folded AS ("
            f"  SELECT w.entity_id, {b._agg_group_object()} AS js"
            "  FROM winners w GROUP BY w.entity_id"
            f"){req_cte} "
            "SELECT e.entity_id, e.first_up, l.last_up,"
            "       COALESCE(f.js, '{}'), b.nbail "
            "FROM ent e JOIN lastu l ON e.entity_id=l.entity_id"
            " LEFT JOIN folded f ON e.entity_id=f.entity_id"
            f" CROSS JOIN bail b{req_join} ORDER BY e.entity_id"
        )
        try:
            with b._cursor() as cur:
                rows = cur.execute(sql, [*params, *req_params]).fetchall()
        except Exception as e:  # JSON corner → per-event fallback
            log.info("aggregate pushdown failed (%s: %s) — per-event "
                     "Python fallback", type(e).__name__, e)
            return None
        if rows and rows[0][4]:
            log.info("aggregate pushdown: %d un-extractable real value(s) "
                     "(key contains '\"' or '\\\\') — per-event Python "
                     "fallback", rows[0][4])
            return None
        return self._agg_rows_to_dict([tuple(r)[:4] for r in rows])

    @staticmethod
    def _agg_rows_to_dict(rows):
        """(entity_id, first_text, last_text, json_text) rows → the
        wrapper's result dict; None on undecodable JSON (→ fallback)."""
        out = {}
        try:
            for eid, first, last, js in rows:
                out[eid] = (json.loads(js), parse_time(first),
                            parse_time(last))
        except (ValueError, TypeError) as e:
            log.warning("aggregate pushdown: bad folded payload (%s) — "
                        "per-event Python fallback", e)
            return None
        return out
