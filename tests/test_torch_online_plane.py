"""The port's online plane (`online/plane.py`, `online/swap.py`,
`ingest/invalidation.py`) and the deployed server's served-state table,
`/reload` and `/metrics` (`workflow/create_server.py`), on the CPU with
the kernels' plain versions:

- the reference's bars, run against the port: tests/test_online.py
  `TestDeltaSwapper` (the cache half of its third case waits for the
  port's result cache; its bus half is kept), `TestOnlinePlaneEndToEnd`
  (through `PredictionServer.predict`) and `TestOnlineConfig`;
  tests/test_hotpath_caches.py `TestInvalidationBus` and the
  concurrent-unsubscribe case;
- the port's plane against the reference's on the same events and the
  same trained model (carried across with `convert.als_model_from_arrays`):
  folded rows, cold-start order, top-k ids and the gathered histories;
- the HTTP routes on port 0.

Every server is built with its plane stopped straight after construction
(polls are driven by hand) and closed in teardown.
"""

import contextlib
import json
import threading
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from predictionio_tpu.data.datamap import DataMap as RefDataMap
from predictionio_tpu.data.events import Event as RefEvent
from predictionio_tpu.storage.base import App as RefApp
from predictionio_torch import convert
from predictionio_torch.controller import WorkflowContext
from predictionio_torch.data.datamap import DataMap
from predictionio_torch.data.events import Event
from predictionio_torch.ingest.invalidation import BUS, InvalidationBus
from predictionio_torch.online import (
    DeltaSwapper,
    OnlineConfig,
    OnlinePlane,
    StaleState,
)
from predictionio_torch.storage.base import App, EngineInstance, Model
from predictionio_torch.storage.registry import (
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_torch.telemetry.registry import REGISTRY
from predictionio_torch.utils.faults import FaultInjected
from predictionio_torch.workflow.core_workflow import (
    CoreWorkflow,
    write_model_file,
)
from predictionio_torch.workflow.create_server import PredictionServer
from predictionio_torch.workflow.workflow_utils import (
    EngineVariant,
    engine_params_to_json,
    extract_engine_params,
    get_engine,
)

# one intra-op thread: these tests use small tensors, and the suite's
# parallel workers share the machine's cores with timing-sensitive tests
torch.set_num_threads(1)

FACTORY = "predictionio_torch.templates.recommendation.RecommendationEngine"
VARIANT = "rec-test"


def _variant_dict(seed=1, iters=15):
    """The reference's tests/test_recommendation_template.py
    `variant_dict`, for the port's engine."""
    return {
        "id": VARIANT, "engineFactory": FACTORY,
        "datasource": {"params": {"appName": "RecApp"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 4, "numIterations": iters, "lambda": 0.05,
            "seed": seed}}],
    }


def _ingest(storage, app_cls=App, event_cls=Event, map_cls=DataMap,
            n_users=12, n_items=8):
    """The reference's `ingest_ratings`, through either package's classes:
    even users love even items, odd users odd ones, one held-out liked
    item each, and one "buy" (the implicit 4.0 path)."""
    app_id = storage.meta_apps().insert(app_cls(id=0, name="RecApp"))
    le = storage.l_events()
    t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)

    def rate(u, i, r):
        le.insert(event_cls(
            event="rate", entity_type="user", entity_id=f"u{u}",
            target_entity_type="item", target_entity_id=f"i{i}",
            properties=map_cls({"rating": r}), event_time=t0), app_id)

    for u in range(n_users):
        liked = [i for i in range(n_items) if i % 2 == u % 2]
        disliked = [i for i in range(n_items) if i % 2 != u % 2]
        holdout = liked[(u // 2) % len(liked)]
        for i in liked:
            if i != holdout:
                rate(u, i, 5.0)
        for i in disliked[: len(disliked) // 2]:
            rate(u, i, 1.0)
    le.insert(event_cls(event="buy", entity_type="user", entity_id="u0",
                        target_entity_type="item", target_entity_id="i2",
                        event_time=t0), app_id)
    return app_id


def _parts(seed=1, iters=15):
    variant = EngineVariant.from_dict(_variant_dict(seed, iters))
    engine = get_engine(variant.engine_factory)
    return variant, engine, extract_engine_params(engine, variant)


def _train(storage, seed=1):
    """One train of the rec-test engine into `storage` on the CPU."""
    variant, engine, ep = _parts(seed)
    return CoreWorkflow.run_train(
        engine, ep, variant,
        WorkflowContext(device="cpu", storage=storage, seed=1))


@pytest.fixture()
def storage():
    src = SourceConfig(name="TEST", type="memory")
    s = Storage(StorageConfig(metadata=src, modeldata=src, eventdata=src))
    yield s
    s.close()


@pytest.fixture()
def engine_json(tmp_path):
    path = tmp_path / "engine.json"
    path.write_text(json.dumps(_variant_dict()))
    return str(path)


@contextlib.contextmanager
def online_server(storage, engine_json, **online_kw):
    server = PredictionServer(engine_json, ip="127.0.0.1", port=0,
                              device="cpu", storage=storage,
                              online=OnlineConfig(**online_kw))
    try:
        # polls are driven by hand in every test: deterministic batches
        server.online.stop()
        yield server
    finally:
        server.server_close()


def _rate(storage, user, item, rating=5.0):
    app_id = storage.meta_apps().get_by_name("RecApp").id
    storage.l_events().insert(Event(
        event="rate", entity_type="user", entity_id=user,
        target_entity_type="item", target_entity_id=item,
        properties=DataMap({"rating": rating})), app_id)


def _items(server, user, num=3):
    return [s["item"] for s in
            server.predict({"user": user, "num": num})["itemScores"]]


# -- the invalidation bus (tests/test_hotpath_caches.py) ----------------------

class TestInvalidationBus:
    def test_publish_reaches_subscribers(self):
        bus = InvalidationBus()
        got = []
        bus.subscribe(got.append)
        assert bus.has_subscribers
        bus.publish(["u1", "u2"])
        assert got == [["u1", "u2"]]
        bus.unsubscribe(got.append)
        assert not bus.has_subscribers

    def test_subscriber_exception_contained(self):
        bus = InvalidationBus()
        got = []

        def boom(_ids):
            raise RuntimeError("subscriber bug")

        bus.subscribe(boom)
        bus.subscribe(got.append)
        bus.publish(["u1"])  # must not raise, must reach the healthy sub
        assert got == [["u1"]]


def test_bus_unsubscribe_under_concurrent_publish():
    """Copy-on-write subscriber list: unsubscribing mid-publish-storm
    must neither deadlock nor raise."""
    bus = InvalidationBus()
    seen = []
    bus.subscribe(seen.append)
    stop = threading.Event()

    def storm():
        while not stop.is_set():
            bus.publish(["u"])

    t = threading.Thread(target=storm)
    t.start()
    try:
        for _ in range(50):
            bus.subscribe(len)  # churn the list
            bus.unsubscribe(len)
    finally:
        stop.set()
        t.join(5)
    assert not t.is_alive()
    assert seen  # publishes reached the stable subscriber


# -- the delta swapper (tests/test_online.py TestDeltaSwapper) -----------------

class TestDeltaSwapper:
    class _Bus:
        def __init__(self):
            self.published = []

        def publish(self, entity_ids, variant=None):
            self.published.append((list(entity_ids), variant))

    def test_swap_replaces_state_and_publishes_touched_users(self):
        state = SimpleNamespace(models=["old"], instance="inst-1")
        states = {"v": state}
        bus = self._Bus()
        swapper = DeltaSwapper(states, threading.Lock(), bus=bus)
        new_state = swapper.swap("v", state, ["new"],
                                 touched_users={"u2", "u1"})
        assert states["v"] is new_state and new_state is not state
        assert new_state.models == ["new"]
        assert new_state.instance == "inst-1"  # everything else copied
        assert state.models == ["old"]  # old immutable state untouched
        assert bus.published == [(["u1", "u2"], "v")]  # sorted, scoped

    def test_stale_swap_is_refused(self):
        state = SimpleNamespace(models=["old"])
        states = {"v": state}
        bus = self._Bus()
        swapper = DeltaSwapper(states, threading.Lock(), bus=bus)
        reloaded = SimpleNamespace(models=["reloaded"])
        states["v"] = reloaded  # a full /reload landed mid-fold
        with pytest.raises(StaleState):
            swapper.swap("v", state, ["folded"], touched_users=["u1"])
        assert states["v"] is reloaded  # the reload was NOT clobbered
        assert bus.published == []  # no invalidation for a refused swap

    def test_swap_publishes_scoped_ids_on_the_process_bus(self):
        """The bus half of the reference's per-user invalidation case:
        the default bus carries exactly the touched users, scoped to the
        swapped variant, to a variant-aware subscriber and the bare ids
        to a one-argument one."""
        scoped, bare = [], []

        def on_commit(entity_ids, variant):
            scoped.append((list(entity_ids), variant))

        BUS.subscribe(on_commit)
        BUS.subscribe(bare.append)
        try:
            state = SimpleNamespace(models=["m"])
            swapper = DeltaSwapper({"a": state}, threading.Lock())
            swapper.swap("a", state, ["m2"], touched_users=["u1"])
        finally:
            BUS.unsubscribe(on_commit)
            BUS.unsubscribe(bare.append)
        assert scoped == [(["u1"], "a")]
        assert bare == [["u1"]]


# -- the plane end to end (tests/test_online.py TestOnlinePlaneEndToEnd) -------

class TestOnlinePlaneEndToEnd:
    def test_never_seen_user_is_servable_after_one_poll(self, storage,
                                                        engine_json):
        _ingest(storage)
        _train(storage)
        with online_server(storage, engine_json, interval_s=0.05) as server:
            assert server.online is not None
            # u99 lands in the odd-item block; i7 is the odd item they
            # have not rated yet
            for i in (1, 3, 5):
                _rate(storage, "u99", f"i{i}")
            assert server.online.poll_once() == 3
            items = _items(server, "u99")
            assert items, "folded user got no recommendations"
            assert "i7" in items, f"expected the unrated odd item, got {items}"
            assert not {"i1", "i3", "i5"} & set(items), \
                "seen-exclusion lost the folded ratings"
            assert server.online.poll_once() == 0  # watermark advanced

    def test_crash_between_fold_and_watermark_replays_idempotently(
            self, storage, engine_json, monkeypatch):
        _ingest(storage)
        _train(storage)
        # item folds OFF: the opposing factors are fixed across the
        # replay, so recovered factors must be bit-identical
        with online_server(storage, engine_json, interval_s=0.05,
                           fold_items=False) as server:
            for i in (1, 3, 5):
                _rate(storage, "crash1", f"i{i}")
            monkeypatch.setenv("PIO_FAULTS", "online.pre_watermark=error")
            with pytest.raises(FaultInjected):
                server.online.poll_once()
            # the fold and swap landed BEFORE the crash window...
            model = server._states[VARIANT].models[0]
            row0 = model.user_ids.get("crash1")
            assert row0 is not None, "fold did not land before the crash"
            pre = np.array(np.asarray(model.user_factors)[row0], copy=True)
            # ...and the watermark did not: recovery replays the batch
            monkeypatch.setenv("PIO_FAULTS", "")
            assert server.online.poll_once() == 3
            model2 = server._states[VARIANT].models[0]
            row = model2.user_ids.get("crash1")
            assert np.array_equal(np.asarray(model2.user_factors)[row], pre)
            assert server.online.poll_once() == 0  # settled
            assert _items(server, "crash1"), "event lost across the crash"

    def test_reload_rebases_the_plane_and_folding_continues(self, storage,
                                                            engine_json):
        _ingest(storage)
        _train(storage)
        with online_server(storage, engine_json, interval_s=0.05) as server:
            _rate(storage, "u50", "i2")
            assert server.online.poll_once() == 1
            first = server.state.instance.id
            second = _train(storage, seed=2).id
            server.reload()  # rebases tailers onto the new instance
            assert server.state.instance.id == second != first
            # the plane must keep folding against the NEW state
            _rate(storage, "u51", "i3")
            assert server.online.poll_once() >= 1
            assert _items(server, "u51")

    def test_parity_check_bounds_drift(self, storage, engine_json):
        _ingest(storage)
        _train(storage)
        with online_server(storage, engine_json, interval_s=0.05,
                           fold_items=False) as server:
            _rate(storage, "u1", "i7", rating=4.0)
            server.online.poll_once()
            stats = server.online.parity_check()
            assert VARIANT in stats
            s = stats[VARIANT]
            assert s["rows"] > 0
            assert s["rel_max"] <= 0.05, (
                f"served factors drift {s['rel_max']:.3f} (rel max) from "
                f"a fresh half-epoch")

    def test_snapshot(self, storage, engine_json):
        _ingest(storage)
        _train(storage)
        with online_server(storage, engine_json, interval_s=0.05) as server:
            snap = server.online.snapshot()
            assert snap == {"variants": [VARIANT], "eventsFolded": 0,
                            "watermark": snap["watermark"]}
            start = server.state.instance.start_time
            for i in (1, 3, 5):
                _rate(storage, "u99", f"i{i}")
            assert server.online.poll_once() == 3
            snap = server.online.snapshot()
            assert snap["variants"] == [VARIANT]
            assert snap["eventsFolded"] == 3
            assert datetime.fromisoformat(snap["watermark"]) > start


# -- the knobs and families (tests/test_online.py TestOnlineConfig) ------------

class TestOnlineConfig:
    def test_env_gating_and_knobs(self, monkeypatch):
        monkeypatch.delenv("PIO_ONLINE", raising=False)
        assert OnlineConfig.from_env() is None
        monkeypatch.setenv("PIO_ONLINE", "1")
        assert OnlineConfig.from_env() == OnlineConfig()
        monkeypatch.setenv("PIO_ONLINE_INTERVAL_S", "0.1")
        monkeypatch.setenv("PIO_ONLINE_MAX_BATCH", "256")
        monkeypatch.setenv("PIO_ONLINE_FOLD_ITEMS", "0")
        monkeypatch.setenv("PIO_ONLINE_PARITY_EVERY_S", "30")
        monkeypatch.setenv("PIO_ONLINE_APP_ID", "7")
        cfg = OnlineConfig.from_env()
        assert cfg == OnlineConfig(interval_s=0.1, max_batch=256,
                                   fold_items=False, parity_every_s=30.0,
                                   app_id=7)

    def test_telemetry_families_render(self):
        text = REGISTRY.render()
        for family in ("online_events_folded_total",
                       "online_rows_folded_total",
                       "online_cold_start_rows_total",
                       "online_swaps_total",
                       "online_event_to_servable_seconds",
                       "online_lag_seconds",
                       "online_parity_drift",
                       "storage_op_seconds"):
            assert f"# TYPE {family} " in text


# -- held against the reference's plane ----------------------------------------

def _strip(hist):
    """A gathered history as (entity, [(opposing id, value)]) pairs."""
    return {k: [(o, v) for o, v, _ in triples] for k, triples in hist.items()}


def _recording(plane, log):
    """Record every `_gather_histories` result of `plane`."""
    inner = plane._gather_histories

    def gather(*args):
        user_hist, item_hist = inner(*args)
        log.append((_strip(user_hist), _strip(item_hist)))
        return user_hist, item_hist

    plane._gather_histories = gather


def _untied_equal(want, got, tol=1e-5):
    """Top-k ids equal wherever the scores are not tied."""
    assert len(want) == len(got)
    scores = np.asarray([s for _, s in want])
    gaps = np.abs(np.diff(scores)) < tol
    tied = np.zeros(len(want), bool)
    tied[:-1] |= gaps
    tied[1:] |= gaps
    for pos in np.nonzero(~tied)[0]:
        assert got[pos][0] == want[pos][0], (pos, want, got)


def test_plane_folds_the_reference_batch(memory_storage, storage, tmp_path,
                                         monkeypatch):
    """The reference's trained model carried into the port's store; the
    reference's plane and the port's poll the same events. Folded rows
    within rtol 2e-3 / atol 1e-5 (test_fold_model_matches_the_reference's
    bar), cold ids appended in the same order, untied top-k ids equal, and
    the gathered histories equal exactly across three polls: new users
    and a new item, a re-rating that crashes before the watermark, and
    its replay."""
    from tests.test_experiment import train_variant
    from tests.test_online import online_server as ref_online_server

    _ingest(memory_storage, RefApp, RefEvent, RefDataMap)
    ref_instance = train_variant(memory_storage, iters=15)
    _ingest(storage)
    with ref_online_server(memory_storage, interval_s=0.05) as ref_server:
        ref_model = ref_server._states[VARIANT].models[0]
        seen = [(row, int(i)) for row in range(len(ref_model.user_ids))
                for i in ref_model.seen.get(row, [])]
        model = convert.als_model_from_arrays(
            ref_model.user_factors, ref_model.item_factors,
            ref_model.user_ids.to_dict(), ref_model.item_ids.to_dict(),
            np.asarray([u for u, _ in seen]), np.asarray([i for _, i in seen]))
        # the port's store holds the carried model as a completed instance
        # that began when the reference's did (the tailers' watermark)
        _, engine, ep = _parts()
        instance = EngineInstance(
            id="", status="COMPLETED", start_time=ref_instance.start_time,
            end_time=ref_instance.end_time, engine_id=VARIANT,
            engine_version="1", engine_variant=VARIANT,
            engine_factory=FACTORY, **engine_params_to_json(ep))
        instance.id = storage.meta_engine_instances().insert(instance)
        storage.model_data_models().insert(
            Model(id=instance.id, models=engine.serialize_models([model])))
        engine_json = tmp_path / "engine.json"
        engine_json.write_text(json.dumps(_variant_dict()))
        with online_server(storage, str(engine_json),
                           interval_s=0.05) as server:
            logs = {"ref": [], "port": []}
            _recording(ref_server.online, logs["ref"])
            _recording(server.online, logs["port"])
            app_ids = {
                "ref": memory_storage.meta_apps().get_by_name("RecApp").id,
                "port": storage.meta_apps().get_by_name("RecApp").id}
            t0 = ref_instance.start_time + timedelta(seconds=1)

            def write(rows):
                for n, (u, i, r) in enumerate(rows):
                    when = t0 + timedelta(seconds=len(written) + n)
                    for side, (store, ev, dm) in {
                            "ref": (memory_storage, RefEvent, RefDataMap),
                            "port": (storage, Event, DataMap)}.items():
                        store.l_events().insert(ev(
                            event="rate", entity_type="user", entity_id=u,
                            target_entity_type="item", target_entity_id=i,
                            properties=dm({"rating": r}), event_time=when),
                            app_ids[side])
                written.extend(rows)

            written = []
            # poll 1: two never-seen users (one rating a never-seen item)
            # and two existing users re-rating
            write([("n2", "i3", 5.0), ("n1", "i1", 5.0), ("n1", "i5", 4.0),
                   ("n2", "inew", 3.0), ("u4", "i1", 2.0), ("u3", "i6", 1.5)])
            assert ref_server.online.poll_once() == 6
            assert server.online.poll_once() == 6
            # poll 2: a re-rating, the pre-watermark crash on both sides
            write([("n1", "i1", 1.0), ("u3", "i3", 4.5)])
            monkeypatch.setenv("PIO_FAULTS", "online.pre_watermark=error")
            with pytest.raises(Exception, match="online.pre_watermark"):
                ref_server.online.poll_once()
            with pytest.raises(FaultInjected):
                server.online.poll_once()
            # poll 3: the replay
            monkeypatch.setenv("PIO_FAULTS", "")
            assert ref_server.online.poll_once() == 2
            assert server.online.poll_once() == 2

            assert len(logs["port"]) == len(logs["ref"]) == 3
            assert logs["port"] == logs["ref"]
            assert logs["port"][2] == logs["port"][1]  # the replay's

            ref_folded = ref_server._states[VARIANT].models[0]
            folded = server._states[VARIANT].models[0]
            n_users, n_items = len(ref_model.user_ids), len(ref_model.item_ids)
            assert (list(folded.user_ids.keys())[n_users:]
                    == list(ref_folded.user_ids.keys())[n_users:]
                    == ["n1", "n2"])
            assert (list(folded.item_ids.keys())[n_items:]
                    == list(ref_folded.item_ids.keys())[n_items:]
                    == ["inew"])
            assert folded.user_ids.to_dict() == ref_folded.user_ids.to_dict()
            for side, ids, dirty in (
                    ("user_factors", folded.user_ids, ["n1", "n2", "u3",
                                                       "u4"]),
                    ("item_factors", folded.item_ids, ["i1", "i3", "i5",
                                                       "i6", "inew"])):
                rows = [ids[e] for e in dirty]
                np.testing.assert_allclose(
                    np.asarray(getattr(folded, side))[rows],
                    np.asarray(getattr(ref_folded, side))[rows],
                    rtol=2e-3, atol=1e-5)
            for user in ("n1", "n2", "u3", "u4", "u0"):
                _untied_equal(ref_folded.recommend_products(user, 5),
                              folded.recommend_products(user, 5))
                assert ([s["item"] for s in server.predict(
                    {"user": user, "num": 5})["itemScores"]]
                    == [i for i, _ in folded.recommend_products(user, 5)])


# -- the routes over HTTP -------------------------------------------------------

def _http(url, data=None):
    req = urllib.request.Request(url, data=data)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


@contextlib.contextmanager
def _serving(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.port}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def test_http_reload_metrics_and_status(storage, engine_json):
    _ingest(storage)
    first = _train(storage).id
    server = PredictionServer(engine_json, ip="127.0.0.1", port=0,
                              device="cpu", storage=storage,
                              online=OnlineConfig())
    server.online.stop()
    with _serving(server) as url:
        code, _, body = _http(url + "/")
        status = json.loads(body)
        assert code == 200 and status["engineInstanceId"] == first
        assert status["online"]["variants"] == [VARIANT]
        assert status["online"]["eventsFolded"] == 0
        _rate(storage, "u77", "i2")
        assert server.online.poll_once() == 1
        code, ctype, body = _http(url + "/metrics")
        text = body.decode()
        assert code == 200 and ctype.startswith("text/plain")
        for family in ("online_events_folded_total",
                       "online_foldin_seconds",
                       "online_event_to_servable_seconds",
                       "online_swaps_total", "storage_op_seconds"):
            assert f"# TYPE {family} " in text, family
        assert 'storage_op_seconds_count{repo="l_events",op="find"}' in text
        assert f'online_swaps_total{{variant="{VARIANT}"}}' in text
        second = _train(storage, seed=2).id
        code, _, body = _http(url + "/reload", data=b"")
        assert code == 200, body
        assert json.loads(body) == {"message": "Reloaded",
                                    "engineInstanceId": second}
        code, _, body = _http(url + "/")
        status = json.loads(body)
        assert status["engineInstanceId"] == second
        assert status["online"]["eventsFolded"] == 1
    assert server.online._tailers[0]._thread is None


def test_model_file_deploy_has_no_store(tmp_path, storage, engine_json):
    """A deploy from a model file can neither reload nor run the plane:
    `/reload` answers an error and keeps serving, and asking for the
    plane raises at construction."""
    _ingest(storage)
    instance = _train(storage)
    blob = storage.model_data_models().get(instance.id).models
    model_path = str(tmp_path / "model.pio")
    _, engine, _ = _parts()
    write_model_file(model_path, instance, engine.deserialize_models(blob))
    with pytest.raises(ValueError, match="online plane"):
        PredictionServer(engine_json, model_path, ip="127.0.0.1", port=0,
                         device="cpu", online=OnlineConfig())
    server = PredictionServer(engine_json, model_path, ip="127.0.0.1",
                              port=0, device="cpu")
    assert server.online is None and server.storage is None
    with _serving(server) as url:
        code, _, body = _http(url + "/reload", data=b"")
        assert code == 500 and "model file" in json.loads(body)["message"]
        code, _, body = _http(url + "/")
        assert code == 200 and "online" not in json.loads(body)
        assert json.loads(body)["engineInstanceId"] == instance.id


def test_failed_reload_keeps_the_served_instance(storage, engine_json):
    _ingest(storage)
    first = _train(storage).id
    with online_server(storage, engine_json) as server:
        storage.model_data_models().delete(first)
        with pytest.raises(RuntimeError, match="missing"):
            server.reload()
        assert server.state.instance.id == first
        assert _items(server, "u0")


def test_plane_with_an_unknown_app_serves_on(storage, engine_json, caplog):
    """The reference's contract: a variant whose app is not in the store
    is skipped with its log line, and the server serves without folds."""
    app_id = _ingest(storage)
    _train(storage)
    storage.meta_apps().delete(app_id)
    with online_server(storage, engine_json) as server:
        assert isinstance(server.online, OnlinePlane)
        assert server.online.snapshot()["variants"] == []
        assert server.online.poll_once() == 0
        assert _items(server, "u0")
    assert "not found" in caplog.text


def test_a_port_in_use_fails_as_a_bind_error(storage, engine_json):
    """A failed bind closes the socket before the plane exists: the
    caller sees the OSError the console reports as "Cannot bind"."""
    _ingest(storage)
    _train(storage)
    with online_server(storage, engine_json) as server:
        with pytest.raises(OSError):
            PredictionServer(engine_json, ip="127.0.0.1", port=server.port,
                             device="cpu", storage=storage)
