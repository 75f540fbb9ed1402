"""The port's group-commit writer (`ingest/writer.py`) held to the
reference's writer tests (tests/test_ingest_writer.py: the config, the
inline lone submit, coalescing, the grouped-failure redo, shedding,
grouping off, close, read-after-ack on a sqlite file), each a case of a
test parametrised by implementation; and the bus messages both writers
publish for the same commits.

The reference's tests hold a writer busy with a blocked insert and
release it after a short sleep; here every such step waits on the
writer's own state (its queue depth, its admitted count) instead, so
each bar is an order or a count, not a host time.
"""

import threading
import time

import pytest

from predictionio_tpu.data.datamap import DataMap as RefDataMap
from predictionio_tpu.data.events import Event as RefEvent
from predictionio_tpu.ingest import invalidation as ref_invalidation
from predictionio_tpu.ingest import writer as ref_writer
from predictionio_tpu.storage.sqlite import SQLiteBackend as RefSQLiteBackend
from predictionio_torch.data.datamap import DataMap
from predictionio_torch.data.events import Event
from predictionio_torch.ingest import invalidation
from predictionio_torch.ingest import writer
from predictionio_torch.storage.sqlite import SQLiteBackend

IMPLS = {
    "reference": (ref_writer, RefEvent, RefDataMap, RefSQLiteBackend,
                  ref_invalidation),
    "port": (writer, Event, DataMap, SQLiteBackend, invalidation),
}


@pytest.fixture(params=list(IMPLS))
def impl(request):
    mod, event_cls, map_cls, backend, bus_mod = IMPLS[request.param]

    class Impl:
        GroupCommitWriter = mod.GroupCommitWriter
        IngestConfig = mod.IngestConfig
        IngestOverload = mod.IngestOverload
        SQLite = backend
        bus = bus_mod.BUS
        DataMap = map_cls

        @staticmethod
        def event(i, **kw):
            return event_cls(event="rate", entity_type="user",
                             entity_id=f"u{i}", target_entity_type="item",
                             target_entity_id=f"i{i}", **kw)

    return Impl


class _RecordingStore:
    """In-memory LEvents stand-in recording how commits arrived."""

    def __init__(self):
        self.lock = threading.Lock()
        self.rows: dict = {}
        self.single_calls: list = []
        self.grouped_calls: list = []

    def insert(self, event, app_id, channel_id=None):
        eid = event.event_id or f"id-{event.entity_id}"
        with self.lock:
            self.single_calls.append((event, app_id, channel_id))
            self.rows[eid] = event
        return eid

    def insert_grouped(self, items):
        with self.lock:
            self.grouped_calls.append(list(items))
            ids = []
            for event, _app_id, _channel_id in items:
                eid = event.event_id or f"id-{event.entity_id}"
                self.rows[eid] = event
                ids.append(eid)
        return ids


def _writer(impl, store, insert=None, grouped=None, **cfg):
    return impl.GroupCommitWriter(
        insert_fn=insert or store.insert,
        grouped_fn=grouped or store.insert_grouped,
        config=impl.IngestConfig(**cfg), name="test")


def _until(cond, timeout=10.0):
    """Wait for the writer state `cond` describes (polled)."""
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "the writer never got there"
        time.sleep(0.001)


def _blocking(store, started, release, poison=None):
    """An insert that blocks the inline occupier (u0) until `release`,
    and raises for the entity `poison`."""
    def insert(event, app_id, channel_id=None):
        if event.entity_id == "u0":
            started.set()
            assert release.wait(10)
        if event.entity_id == poison:
            raise ValueError("poisoned event")
        return store.insert(event, app_id, channel_id)
    return insert


# -- config --------------------------------------------------------------------

def test_config_defaults(impl):
    cfg = impl.IngestConfig()
    assert cfg.grouping and cfg.max_group == 64
    assert cfg.max_wait_ms > 0 and cfg.max_queue > 0
    assert cfg.retry_after_s > 0


def test_config_from_env_overrides(impl, monkeypatch):
    monkeypatch.setenv("PIO_INGEST_GROUPING", "0")
    monkeypatch.setenv("PIO_INGEST_MAX_GROUP", "17")
    monkeypatch.setenv("PIO_INGEST_MAX_WAIT_MS", "7.5")
    monkeypatch.setenv("PIO_INGEST_MAX_QUEUE", "99")
    monkeypatch.setenv("PIO_INGEST_RETRY_AFTER_S", "2.5")
    cfg = impl.IngestConfig.from_env()
    assert cfg.grouping is False
    assert cfg.max_group == 17
    assert cfg.max_wait_ms == 7.5
    assert cfg.max_queue == 99
    assert cfg.retry_after_s == 2.5


def test_config_from_env_unparseable_falls_back(impl, monkeypatch):
    monkeypatch.setenv("PIO_INGEST_MAX_GROUP", "lots")
    cfg = impl.IngestConfig.from_env()
    assert cfg.max_group == impl.IngestConfig().max_group


def test_the_port_config_equals_the_references(monkeypatch):
    assert vars(writer.IngestConfig()) == vars(ref_writer.IngestConfig())
    monkeypatch.setenv("PIO_INGEST_GROUPING", "off")
    monkeypatch.setenv("PIO_INGEST_MAX_WAIT_MS", "0")
    assert (vars(writer.IngestConfig.from_env())
            == vars(ref_writer.IngestConfig.from_env()))


# -- the writer ----------------------------------------------------------------

def test_lone_submit_commits_inline(impl):
    store = _RecordingStore()
    w = _writer(impl, store)
    try:
        eid = w.submit(impl.event(1), app_id=1)
    finally:
        w.close()
    assert eid in store.rows
    # a lone request never pays the queue: single insert, no group
    assert len(store.single_calls) == 1
    assert store.grouped_calls == []


@pytest.mark.parametrize("max_wait_ms", [0.0, 50.0])
def test_concurrent_submits_coalesce_into_one_commit(impl, max_wait_ms):
    """Four submits that arrive while a commit runs leave as ONE shared
    transaction, whatever the hold (0: opportunistic only)."""
    store = _RecordingStore()
    started, release = threading.Event(), threading.Event()
    w = _writer(impl, store, insert=_blocking(store, started, release),
                max_wait_ms=max_wait_ms)
    results: dict = {}

    def submit(i):
        results[i] = w.submit(impl.event(i), app_id=1)

    threads = [threading.Thread(target=submit, args=(0,))]
    try:
        threads[0].start()
        assert started.wait(5)  # occupies the writer inline
        threads += [threading.Thread(target=submit, args=(i,))
                    for i in range(1, 5)]
        for t in threads[1:]:
            t.start()
        _until(lambda: len(w._queue) == 4)
        release.set()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
    finally:
        release.set()
        w.close()
    assert len(results) == 5
    assert set(results.values()) <= set(store.rows)
    assert len(store.grouped_calls) == 1
    assert len(store.grouped_calls[0]) == 4


def test_grouped_failure_redoes_per_item(impl):
    store = _RecordingStore()
    started, release = threading.Event(), threading.Event()

    def grouped_always_fails(items):
        raise RuntimeError("shared transaction rolled back")

    w = _writer(impl, store,
                insert=_blocking(store, started, release, poison="u3"),
                grouped=grouped_always_fails, max_wait_ms=50.0)
    results: dict = {}
    errors: dict = {}

    def submit(i):
        try:
            results[i] = w.submit(impl.event(i), app_id=1)
        except BaseException as e:  # noqa: BLE001
            errors[i] = e

    threads = [threading.Thread(target=submit, args=(0,))]
    try:
        threads[0].start()
        assert started.wait(5)
        threads += [threading.Thread(target=submit, args=(i,))
                    for i in range(1, 5)]
        for t in threads[1:]:
            t.start()
        _until(lambda: len(w._queue) == 4)
        release.set()
        for t in threads:
            t.join(timeout=10)
    finally:
        release.set()
        w.close()
    # one poisoned event answers its own error; the innocent three from
    # its group (plus the inline occupier) all landed
    assert set(errors) == {3}
    assert isinstance(errors[3], ValueError)
    assert set(results) == {0, 1, 2, 4}
    for i in (1, 2, 4):
        assert results[i] in store.rows


def test_bounded_queue_sheds_with_retry_after(impl):
    store = _RecordingStore()
    started, release = threading.Event(), threading.Event()
    w = _writer(impl, store, insert=_blocking(store, started, release),
                max_queue=1, retry_after_s=2.0)
    try:
        t = threading.Thread(target=lambda: w.submit(impl.event(0), 1))
        t.start()
        assert started.wait(5)  # budget now full
        with pytest.raises(impl.IngestOverload) as exc:
            w.submit(impl.event(1), app_id=1)
        assert exc.value.retry_after_s == 2.0
        assert "1/1 in flight" in str(exc.value)
        release.set()
        t.join(timeout=10)
        # the budget frees with the ack: the next submit is admitted
        assert w.submit(impl.event(2), app_id=1) in store.rows
    finally:
        release.set()
        w.close()


def test_grouping_off_is_direct_but_still_bounded(impl):
    store = _RecordingStore()
    w = _writer(impl, store, grouping=False, max_queue=1)
    try:
        assert w.submit(impl.event(1), app_id=1) in store.rows
        assert store.grouped_calls == []
        assert w._thread is None  # no committer thread at all
    finally:
        w.close()


def test_close_fails_queued_and_rejects_new(impl):
    store = _RecordingStore()
    started, release = threading.Event(), threading.Event()
    w = _writer(impl, store, insert=_blocking(store, started, release),
                max_wait_ms=50.0)
    errors: list = []

    def submit_queued():
        try:
            w.submit(impl.event(1), app_id=1)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    t0 = threading.Thread(target=lambda: w.submit(impl.event(0), 1))
    t0.start()
    assert started.wait(5)
    tq = threading.Thread(target=submit_queued)
    tq.start()
    _until(lambda: len(w._queue) == 1)
    w.close(timeout=1.0)
    release.set()
    t0.join(timeout=10)
    tq.join(timeout=10)
    assert errors and isinstance(errors[0], RuntimeError)
    with pytest.raises(RuntimeError):
        w.submit(impl.event(2), app_id=1)


def test_ids_readable_immediately_after_submit(impl, tmp_path):
    """Concurrency + read-your-writes against the sqlite backend: the id
    `submit()` returns is already a committed row when the call
    returns."""
    backend = impl.SQLite(str(tmp_path / "ingest.db"))
    le = backend.events()
    w = impl.GroupCommitWriter(insert_fn=le.insert,
                               grouped_fn=le.insert_grouped,
                               config=impl.IngestConfig(max_wait_ms=2.0),
                               name="test")
    failures: list = []

    def client(base):
        try:
            for i in range(12):
                eid = w.submit(impl.event(base * 1000 + i), app_id=1)
                if le.get(eid, 1) is None:
                    failures.append(eid)
        except BaseException as e:  # noqa: BLE001
            failures.append(e)

    try:
        threads = [threading.Thread(target=client, args=(b,))
                   for b in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        w.close()
        backend.close()
    assert failures == []


def test_committed_events_are_published_on_the_bus(impl):
    """Unscoped ids for every committed event; a `$reward` with a variant
    published scoped to it; nothing for a failed commit."""
    store = _RecordingStore()
    got: list = []

    def listener(ids, variant=None):
        got.append((sorted(ids), variant))

    impl.bus.subscribe(listener)
    w = _writer(impl, store)
    try:
        w.submit(impl.event(1), app_id=1)
        reward = impl.event(2)
        reward.event = "$reward"
        reward.properties = impl.DataMap({"variant": "b", "reward": 1.0})
        w.submit(reward, app_id=1)
        w.insert_fn = lambda *a: (_ for _ in ()).throw(ValueError("x"))
        with pytest.raises(ValueError):
            w.submit(impl.event(3), app_id=1)
    finally:
        w.close()
        impl.bus.unsubscribe(listener)
    assert got == [(["u1"], None), (["u2"], "b")]
