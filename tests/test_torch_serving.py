"""The port's serving plane (`predictionio_torch/serving/`) and the
deployed server's `/queries.json` through it, on the CPU:

- the reference's bars, run against the port: tests/test_serving_batcher.py
  (bucket ladder, padding invisible bitwise, admitted-aware fill,
  deadlines, poison isolation at the original tier, count mismatch, a
  closed batcher); its ≤ 5 % host-timing bar becomes a check that a lone
  request dispatches inline on the calling thread and never queues;
  tests/test_serving_admission.py (deadline header, budget, `from_env`,
  the saturation drill over HTTP, metrics, degraded to popularity);
  tests/test_hotpath_caches.py's result-cache cases; tests/test_online.py's
  per-user invalidation cases through the port's real wiring
  (`DeltaSwapper` → `BUS` → the plane's cache); and
  tests/test_prediction_server.py's 32-connection burst;
- the port's plane against the reference's plane on one model carried
  into both packages with `convert.py`: item ids equal wherever the
  scores are not tied, scores within rtol 1e-5; degraded answers equal;
  the bucket ladder, the deadline header and the cache key equal.

Every server and plane a test builds is closed in the test (no dispatcher
thread or bus subscriber outlives it), and every wait has a timeout.
"""

import contextlib
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from predictionio_tpu.data.bimap import BiMap as RefBiMap
from predictionio_tpu.models.als_model import ALSModel as RefALSModel
from predictionio_tpu.models.als_model import SeenItems as RefSeenItems
from predictionio_tpu.serving import admission as ref_admission
from predictionio_tpu.serving import batcher as ref_batcher
from predictionio_tpu.serving.plane import ServingConfig as RefServingConfig
from predictionio_tpu.serving.plane import ServingPlane as RefServingPlane
from predictionio_tpu.serving.result_cache import ResultCache as RefResultCache
from predictionio_tpu.templates.recommendation.engine import (
    PopularityModel as RefPopularityModel,
)
from predictionio_tpu.workflow.workflow_utils import (
    EngineVariant as RefEngineVariant,
)
from predictionio_tpu.workflow.workflow_utils import (
    extract_engine_params as ref_extract_engine_params,
)
from predictionio_tpu.workflow.workflow_utils import get_engine as ref_get_engine
from predictionio_torch import convert
from predictionio_torch.controller import WorkflowContext
from predictionio_torch.ingest.invalidation import BUS
from predictionio_torch.online import DeltaSwapper, OnlineConfig
from predictionio_torch.serving import (
    AdmissionConfig,
    AdmissionController,
    BatcherConfig,
    DeadlineExceeded,
    MicroBatcher,
    ServingConfig,
    ServingPlane,
    ShedLoad,
    deadline_from_headers,
)
from predictionio_torch.serving import batcher as batcher_mod
from predictionio_torch.serving.admission import DEADLINE_HEADER
from predictionio_torch.serving.batcher import bucket_ladder
from predictionio_torch.serving.result_cache import MISS, ResultCache
from predictionio_torch.storage.registry import (
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_torch.workflow.core_workflow import CoreWorkflow
from predictionio_torch.workflow.create_server import PredictionServer
from predictionio_torch.workflow.workflow_utils import (
    EngineVariant,
    extract_engine_params,
    get_engine,
)
from tests.test_torch_online_plane import _ingest, _rate, _variant_dict

# one intra-op thread: these tests use small tensors, and the suite's
# parallel workers share the machine's cores
torch.set_num_threads(1)

FACTORY = "predictionio_torch.templates.recommendation.RecommendationEngine"
REF_FACTORY = "predictionio_tpu.templates.recommendation.RecommendationEngine"
JOIN_S = 30.0


def _multi_variant_dict(factory=FACTORY):
    """The reference's tests/test_recommendation_template.py
    `multi_algo_variant`: ALS and popularity, blended 0.8 / 0.2."""
    return {
        "id": "rec-multi", "engineFactory": factory,
        "datasource": {"params": {"appName": "RecApp"}},
        "algorithms": [
            {"name": "als", "params": {"rank": 4, "numIterations": 15,
                                       "lambda": 0.05, "seed": 1}},
            {"name": "popular", "params": {}}],
        "serving": {"name": "weighted", "params": {"weights": [0.8, 0.2]}},
    }


@pytest.fixture()
def storage():
    src = SourceConfig(name="TEST", type="memory")
    s = Storage(StorageConfig(metadata=src, modeldata=src, eventdata=src))
    yield s
    s.close()


def _train(storage, d, seed=1):
    variant = EngineVariant.from_dict(d)
    engine = get_engine(variant.engine_factory)
    ep = extract_engine_params(engine, variant)
    instance = CoreWorkflow.run_train(
        engine, ep, variant,
        WorkflowContext(device="cpu", storage=storage, seed=seed))
    return engine, ep, instance


@pytest.fixture()
def rec_engine(storage):
    """A trained ALS engine and its resolved serving pieces."""
    _ingest(storage)
    engine, ep, instance = _train(storage, _variant_dict())
    blob = storage.model_data_models().get(instance.id).models
    return engine, ep, engine.deserialize_models(blob), engine.components(ep)


def _engine_json(tmp_path, d):
    path = tmp_path / f"{d['id']}.json"
    path.write_text(json.dumps(d))
    return str(path)


@contextlib.contextmanager
def deployed(storage, tmp_path, d, serving_config=None):
    """A trained engine served on port 0 with the plane `serving_config`
    configures; shut down and closed on exit."""
    _ingest(storage)
    _train(storage, d)
    server = PredictionServer(_engine_json(tmp_path, d), ip="127.0.0.1",
                              port=0, device="cpu", storage=storage,
                              serving_config=serving_config)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=JOIN_S)
        assert not thread.is_alive()
        assert not server.serving.batcher or \
            not server.serving.batcher._thread.is_alive()


def call_raw(port, method, path, body=None, headers=None):
    """Status, JSON body and response headers (Retry-After and
    X-PIO-Degraded are part of the serving contract)."""
    url = f"http://127.0.0.1:{port}{path}"
    data = json.dumps(body).encode() if body is not None else None
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    req = urllib.request.Request(url, data=data, method=method, headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=15) as resp:
            raw = resp.read()
            ctype = resp.headers.get("Content-Type", "")
            return (resp.status, json.loads(raw or b"null")
                    if "json" in ctype else raw.decode(), resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null"), e.headers


def _join_all(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a thread hung"


# -- tests/test_serving_batcher.py --------------------------------------------

class TestBucketLadder:
    def test_powers_of_two_capped(self):
        assert bucket_ladder(32) == (1, 2, 4, 8, 16, 32)
        assert bucket_ladder(1) == (1,)
        assert bucket_ladder(24) == (1, 2, 4, 8, 16, 24)

    def test_batcher_pads_to_the_ladder_of_max_batch(self):
        b = MicroBatcher(lambda qs: qs, BatcherConfig(max_batch=24))
        try:
            assert b._buckets == bucket_ladder(24)
        finally:
            b.close()


class TestBatchedParity:
    """A query's result must not depend on which batch it arrived in:
    batched dispatch bitwise-equal to sequential predicts for every
    bucket size, padding rows included."""

    def test_engine_predict_batch_matches_sequential(self, rec_engine):
        engine, ep, models, components = rec_engine
        queries = [{"user": f"u{i % 12}", "num": 3 + (i % 4)}
                   for i in range(33)]
        sequential = [engine.predict(ep, models, q, components=components)
                      for q in queries]
        # every bucket size of the default ladder, plus one past max_batch
        for size in (1, 2, 3, 4, 7, 8, 16, 32, 33):
            batched = engine.predict_batch(ep, models, queries[:size],
                                           components=components)
            assert batched == sequential[:size], f"batch size {size}"

    def test_padding_rows_are_invisible(self, rec_engine):
        """A batch of 3 pads to bucket 4: the dispatch sees 4 queries, the
        callers see 3 results, bitwise equal to sequential."""
        engine, ep, models, components = rec_engine
        queries = [{"user": f"u{i}", "num": 3} for i in range(3)]
        sequential = [engine.predict(ep, models, q, components=components)
                      for q in queries]
        seen_sizes = []

        def dispatch(qs):
            seen_sizes.append(len(qs))
            return engine.predict_batch(ep, models, qs,
                                        components=components)

        # three admitted: the batch goes out once all three are queued
        b = MicroBatcher(dispatch, BatcherConfig(max_batch=4,
                                                 max_wait_ms=500.0),
                         pending_fn=lambda: 3)
        try:
            results = [None] * 3
            ts = [threading.Thread(target=lambda i=i: results.__setitem__(
                i, b.submit(queries[i]))) for i in range(3)]
            for t in ts:
                t.start()
            _join_all(ts)
        finally:
            b.close()
        assert seen_sizes == [4]  # 3 live + 1 padding row
        assert results == sequential


class TestAdmittedAwareFill:
    """The fill hold is adaptive: `max_wait_ms` caps the wait for
    admitted-but-not-yet-queued requests, it is not a fixed stall."""

    def test_lone_request_is_never_held(self):
        """With a deliberately huge cap (5s), a lone request must still
        answer immediately — admitted == 1 means nobody else is coming."""
        seen = []

        def dispatch(qs):
            seen.append(len(qs))
            return list(qs)

        plane = ServingPlane(
            dispatch,
            config=ServingConfig(batcher=BatcherConfig(max_wait_ms=5000.0)))
        try:
            t0 = time.perf_counter()
            result, degraded = plane.handle_query("q")
            elapsed = time.perf_counter() - t0
        finally:
            plane.close()
        assert result == "q" and degraded is False
        assert seen == [1]
        assert elapsed < 1.0, f"lone request stalled {elapsed:.3f}s"

    def test_concurrent_admitted_requests_coalesce(self):
        """Overlapping admitted requests leave as (a) shared batch(es),
        not one dispatch each."""
        seen = []

        def dispatch(qs):
            seen.append(len(qs))
            time.sleep(0.05)  # hold the dispatch so the rest overlap
            return list(qs)

        plane = ServingPlane(
            dispatch,
            config=ServingConfig(batcher=BatcherConfig(max_wait_ms=5000.0)))
        results = {}
        start = threading.Barrier(4)

        def run(i):
            start.wait(timeout=JOIN_S)
            results[i] = plane.handle_query(f"q{i}")[0]

        try:
            ts = [threading.Thread(target=run, args=(i,)) for i in range(4)]
            for t in ts:
                t.start()
            _join_all(ts)
        finally:
            plane.close()
        assert results == {i: f"q{i}" for i in range(4)}
        # dispatch sizes are bucket-padded, so compare counts, not sums
        assert len(seen) < 4, f"no coalescing happened: {seen}"
        assert max(seen) >= 2, f"no multi-query batch formed: {seen}"


def test_lone_request_dispatches_inline_and_never_queues():
    """What the reference's ≤ 5 % overhead bar protects, without its
    wall-clock bound: a lone request's dispatch runs on the calling
    thread, is one batch of one, and never reaches the queue (the queue
    wait histogram does not count it)."""
    callers = []

    def dispatch(qs):
        callers.append(threading.get_ident())
        return list(qs)

    plane = ServingPlane(dispatch, config=ServingConfig(
        admission=AdmissionConfig(max_queue=64)))
    waits = batcher_mod._QUEUE_WAIT.count
    sizes = batcher_mod._BATCH_SIZE.count
    batches = batcher_mod._BATCHES.value
    try:
        for i in range(50):
            assert plane.handle_query(i, {DEADLINE_HEADER: "1000"}) == (i,
                                                                        False)
    finally:
        plane.close()
    assert callers == [threading.get_ident()] * 50
    assert batcher_mod._QUEUE_WAIT.count == waits
    assert batcher_mod._BATCH_SIZE.count == sizes + 50
    assert batcher_mod._BATCHES.value == batches + 50
    assert plane.admission.admitted == 0


class TestDeadlines:
    def test_expired_while_queued_never_dispatched(self):
        """A request whose deadline lapses in the queue gets
        DeadlineExceeded (→ 503) and its query NEVER reaches the dispatch
        function."""
        dispatched = []
        release = threading.Event()

        def slow(qs):
            dispatched.append(list(qs))
            release.wait(10)
            return qs

        b = MicroBatcher(slow, BatcherConfig(max_batch=4))
        try:
            blocker = threading.Thread(target=lambda: b.submit("blocker"))
            blocker.start()
            deadline = time.monotonic() + 5
            while not dispatched and time.monotonic() < deadline:
                time.sleep(0.005)
            assert dispatched, "blocker never dispatched"
            with pytest.raises(DeadlineExceeded):
                b.submit("late", deadline=time.monotonic() + 0.02)
            release.set()
            blocker.join(timeout=10)
            assert not blocker.is_alive()
            # drain: give the dispatcher a beat to process the queue
            time.sleep(0.1)
        finally:
            release.set()
            b.close()
        assert not any("late" in batch for batch in dispatched), dispatched

    def test_expired_before_dispatch_inline(self):
        b = MicroBatcher(lambda qs: qs)
        try:
            with pytest.raises(DeadlineExceeded):
                b.submit("q", deadline=time.monotonic() - 1)
        finally:
            b.close()


class TestIsolation:
    def test_poison_query_fails_alone(self):
        """One malformed query must answer its own error, not 400 the
        innocent queries it was co-batched with."""

        def dispatch(qs):
            if any(q == "poison" for q in qs):
                raise ValueError("bad query")
            return [q.upper() for q in qs]

        b = MicroBatcher(dispatch, BatcherConfig(max_batch=8,
                                                 max_wait_ms=500.0))
        try:
            results = {}

            def run(q):
                try:
                    results[q] = b.submit(q)
                except ValueError as e:
                    results[q] = e
            ts = [threading.Thread(target=run, args=(q,))
                  for q in ("a", "poison", "b")]
            for t in ts:
                t.start()
            _join_all(ts)
        finally:
            b.close()
        assert results["a"] == "A" and results["b"] == "B"
        assert isinstance(results["poison"], ValueError)

    def test_poisoned_full_bucket_retries_at_original_tier(self):
        """Every retry of a failed batch arrives at the ORIGINAL padded
        size (the query repeated to fill it), and survivors still get
        correct answers."""
        calls = []
        release = threading.Event()

        def dispatch(qs):
            calls.append(list(qs))
            if qs[0] == "blocker":
                release.wait(10)
                return list(qs)
            if any(q == "poison" for q in qs):
                raise ValueError("bad sequence")
            return [q.upper() for q in qs]

        b = MicroBatcher(dispatch, BatcherConfig(max_batch=4))
        results = {}

        def run(q):
            try:
                results[q] = b.submit(q)
            except ValueError as e:
                results[q] = e

        try:
            blocker = threading.Thread(target=run, args=("blocker",))
            blocker.start()
            deadline = time.monotonic() + 5
            while not calls and time.monotonic() < deadline:
                time.sleep(0.005)
            assert calls, "blocker never dispatched"
            ts = [threading.Thread(target=run, args=(q,))
                  for q in ("a", "poison", "b", "c")]
            for t in ts:
                t.start()
            # hold the blocker until the full bucket is queued, so the
            # poison is deterministically co-batched with 3 survivors
            deadline = time.monotonic() + 5
            while len(b._queue) < 4 and time.monotonic() < deadline:
                time.sleep(0.005)
            assert len(b._queue) == 4, "bucket never filled"
            release.set()
            _join_all(ts + [blocker])
        finally:
            release.set()
            b.close()
        assert results["a"] == "A" and results["b"] == "B" \
            and results["c"] == "C"
        assert isinstance(results["poison"], ValueError)
        grouped = calls[1]  # [0] is the blocker
        assert sorted(grouped) == ["a", "b", "c", "poison"]
        retries = calls[2:]
        assert len(retries) == 4  # one per member, in batch order
        for retry in retries:
            # repeated to the original bucket size — never re-padded
            # down onto a fresh (smaller) tier mid-incident
            assert len(retry) == len(grouped)
            assert set(retry) == {retry[0]}

    def test_dispatch_result_count_mismatch_is_an_error(self):
        b = MicroBatcher(lambda qs: [])
        try:
            with pytest.raises(RuntimeError, match="0 results"):
                b.submit("q")
        finally:
            b.close()

    def test_closed_batcher_rejects(self):
        b = MicroBatcher(lambda qs: qs)
        b.close()
        assert not b._thread.is_alive()
        with pytest.raises(RuntimeError, match="shut down"):
            b.submit("q")


# -- tests/test_serving_admission.py ------------------------------------------

class TestDeadlineHeader:
    CFG = AdmissionConfig()

    def test_no_headers_no_default_means_no_deadline(self):
        assert deadline_from_headers(None, self.CFG) is None
        assert deadline_from_headers({}, self.CFG) is None

    def test_header_becomes_absolute_monotonic_deadline(self):
        before = time.monotonic()
        d = deadline_from_headers({DEADLINE_HEADER: "1000"}, self.CFG)
        after = time.monotonic()
        assert before + 0.9 < d < after + 1.1

    def test_unparseable_header_is_ignored_not_rejected(self):
        assert deadline_from_headers({DEADLINE_HEADER: "soon"},
                                     self.CFG) is None

    def test_nonpositive_means_no_deadline(self):
        assert deadline_from_headers({DEADLINE_HEADER: "0"}, self.CFG) is None
        assert deadline_from_headers({DEADLINE_HEADER: "-5"}, self.CFG) is None

    def test_default_applies_when_header_absent(self):
        cfg = AdmissionConfig(default_deadline_ms=50.0)
        d = deadline_from_headers({}, cfg)
        assert d is not None and d - time.monotonic() < 0.06

    def test_clamped_to_max_deadline(self):
        cfg = AdmissionConfig(max_deadline_ms=100.0)
        d = deadline_from_headers({DEADLINE_HEADER: "3600000"}, cfg)
        assert d - time.monotonic() <= 0.11


class TestAdmissionController:
    def test_budget_bounds_concurrent_admissions(self):
        c = AdmissionController(AdmissionConfig(max_queue=2,
                                                retry_after_s=0.5))
        c.admit()
        c.admit()
        with pytest.raises(ShedLoad) as ei:
            c.admit()
        assert ei.value.retry_after_s == 0.5
        c.release()
        c.admit()  # slot freed → admitted again
        assert c.admitted == 2

    def test_expired_deadline_rejected_at_the_door(self):
        c = AdmissionController(AdmissionConfig(max_queue=4))
        with pytest.raises(DeadlineExceeded):
            c.admit(deadline=time.monotonic() - 0.01)
        assert c.admitted == 0  # no slot leaked


class TestServingConfigFromEnv:
    def test_defaults_without_env(self, monkeypatch):
        for k in ("PIO_SERVING_BATCHING", "PIO_SERVING_MAX_BATCH",
                  "PIO_SERVING_MAX_WAIT_MS", "PIO_SERVING_MAX_QUEUE",
                  "PIO_SERVING_DEFAULT_DEADLINE_MS",
                  "PIO_SERVING_RETRY_AFTER_S"):
            monkeypatch.delenv(k, raising=False)
        cfg = ServingConfig.from_env()
        assert cfg.batching is True
        assert cfg.batcher.max_batch == 32
        assert cfg.batcher.max_wait_ms == 5.0
        assert cfg.admission.max_queue == 256

    def test_env_overrides(self, monkeypatch):
        monkeypatch.setenv("PIO_SERVING_BATCHING", "off")
        monkeypatch.setenv("PIO_SERVING_MAX_BATCH", "8")
        monkeypatch.setenv("PIO_SERVING_MAX_WAIT_MS", "2.5")
        monkeypatch.setenv("PIO_SERVING_MAX_QUEUE", "16")
        monkeypatch.setenv("PIO_SERVING_DEFAULT_DEADLINE_MS", "250")
        monkeypatch.setenv("PIO_SERVING_RETRY_AFTER_S", "3")
        cfg = ServingConfig.from_env()
        assert cfg.batching is False
        assert cfg.batcher.max_batch == 8
        assert cfg.batcher.max_wait_ms == 2.5
        assert cfg.admission.max_queue == 16
        assert cfg.admission.default_deadline_ms == 250.0
        assert cfg.admission.retry_after_s == 3.0

    def test_unparseable_env_falls_back_to_default(self, monkeypatch):
        monkeypatch.setenv("PIO_SERVING_MAX_QUEUE", "lots")
        assert ServingConfig.from_env().admission.max_queue == 256

    def test_deploy_reads_the_env(self, monkeypatch, storage, tmp_path):
        monkeypatch.setenv("PIO_SERVING_BATCHING", "0")
        monkeypatch.setenv("PIO_SERVING_MAX_QUEUE", "7")
        with deployed(storage, tmp_path, _variant_dict()) as server:
            assert server.serving.batcher is None
            assert server.serving.config.admission.max_queue == 7
            status, body, _ = call_raw(server.port, "POST", "/queries.json",
                                       {"user": "u0", "num": 3})
            assert status == 200 and len(body["itemScores"]) == 3


class TestSaturationDrill:
    """A saturated server returns explicit 429/503 — no hangs, no 5xx
    storms — and the shed shows up on /metrics."""

    def test_zero_budget_sheds_429_with_retry_after(self, storage,
                                                      tmp_path):
        with deployed(storage, tmp_path, _variant_dict(), ServingConfig(
                admission=AdmissionConfig(max_queue=0,
                                          retry_after_s=2.0))) as server:
            status, body, headers = call_raw(
                server.port, "POST", "/queries.json", {"user": "u0", "num": 3})
        # the als-only engine has no degraded-capable algorithm, so a
        # shed is answered as an honest 429
        assert status == 429
        assert headers.get("Retry-After") == "2"
        assert "saturated" in body["message"]

    def test_expired_deadline_answers_503(self, storage, tmp_path):
        with deployed(storage, tmp_path, _variant_dict(),
                      ServingConfig()) as server:
            status, _, headers = call_raw(
                server.port, "POST", "/queries.json", {"user": "u0", "num": 3},
                headers={DEADLINE_HEADER: "0.0001"})
        assert status == 503
        assert float(headers.get("Retry-After")) > 0

    def test_burst_on_tiny_budget_never_hangs_or_500s(self, storage,
                                                       tmp_path):
        statuses = []
        lock = threading.Lock()

        def client(port, i):
            # a mix of deadline-carrying and plain requests
            hdrs = ({DEADLINE_HEADER: "5000"} if i % 2 else None)
            for _ in range(4):
                s, _, _ = call_raw(port, "POST", "/queries.json",
                                   {"user": f"u{i % 12}", "num": 3},
                                   headers=hdrs)
                with lock:
                    statuses.append(s)

        with deployed(storage, tmp_path, _variant_dict(), ServingConfig(
                admission=AdmissionConfig(max_queue=1))) as server:
            threads = [threading.Thread(target=client,
                                        args=(server.port, i))
                       for i in range(12)]
            for t in threads:
                t.start()
            _join_all(threads)
        assert len(statuses) == 48
        assert set(statuses) <= {200, 429, 503}, sorted(set(statuses))
        assert 200 in statuses  # the admitted fraction was actually served

    def test_shed_and_deadline_metrics_exposed(self, storage, tmp_path):
        with deployed(storage, tmp_path, _variant_dict(), ServingConfig(
                admission=AdmissionConfig(max_queue=0))) as server:
            call_raw(server.port, "POST", "/queries.json",
                     {"user": "u0", "num": 3})
            status, _, _ = call_raw(server.port, "GET", "/")
            assert status == 200
            _, text, _ = call_raw(server.port, "GET", "/metrics")
        for family in ("serving_shed_total", "serving_deadline_misses_total",
                       "serving_admitted_in_flight", "serving_batch_size",
                       "serving_queue_depth", "serving_queue_wait_seconds",
                       "serving_batches_total", "serving_padded_rows_total",
                       "serving_degraded_total", "engine_predict_seconds",
                       "engine_queries_failed_total",
                       "http_result_cache_hits_total"):
            assert f"# TYPE {family} " in text, family
        assert 'serving_shed_total{reason="queue_full"}' in text


class TestDegradedMode:
    def test_shed_degrades_to_popularity_with_header(self, storage,
                                                     tmp_path):
        """With the weighted als+popular engine, a shed request is
        answered by the popularity model (no per-user work) with 200 +
        X-PIO-Degraded: 1 instead of a 429."""
        with deployed(storage, tmp_path, _multi_variant_dict(), ServingConfig(
                admission=AdmissionConfig(max_queue=0))) as server:
            status, body, headers = call_raw(
                server.port, "POST", "/queries.json", {"user": "u0", "num": 3})
            st = server.state
            popular = st.engine.degraded_predict(
                st.engine_params, st.models, {"user": "u0", "num": 3},
                components=st.components)
        assert status == 200
        assert headers.get("X-PIO-Degraded") == "1"
        assert body == popular and body["itemScores"]

    def test_normal_requests_are_not_degraded(self, storage, tmp_path):
        with deployed(storage, tmp_path, _multi_variant_dict(),
                      ServingConfig()) as server:
            status, body, headers = call_raw(
                server.port, "POST", "/queries.json", {"user": "u0", "num": 3})
            want = server.predict({"user": "u0", "num": 3})
        assert status == 200
        assert headers.get("X-PIO-Degraded") is None
        assert body == want and body["itemScores"]

    def test_a_failing_dispatch_is_never_degraded(self, storage, tmp_path,
                                                  monkeypatch):
        """Degraded mode is not a fallback for errors: a dispatch that
        raises answers 500 (an injected fault) or 400, never the
        popularity answer."""
        with deployed(storage, tmp_path, _multi_variant_dict(),
                      ServingConfig()) as server:
            monkeypatch.setenv("PIO_FAULTS", "serving.pre_dispatch=error")
            status, body, headers = call_raw(
                server.port, "POST", "/queries.json", {"user": "u0", "num": 3})
            monkeypatch.setenv("PIO_FAULTS", "")
            assert status == 500 and "serving.pre_dispatch" in body["message"]
            assert headers.get("X-PIO-Degraded") is None
            status, body, _ = call_raw(server.port, "POST", "/queries.json",
                                       {"num": 3})
            assert status == 400 and "user" in body["message"]


# -- tests/test_hotpath_caches.py: the result cache ---------------------------

class TestResultCache:
    def test_hit_miss_and_user_keying(self):
        c = ResultCache(max_entries=8, ttl_s=60.0)
        q1 = {"user": "u1", "num": 3}
        assert c.get(q1) is MISS
        c.put(q1, {"r": 1})
        assert c.get(q1) == {"r": 1}
        # a different query (even same user) is its own entry
        assert c.get({"user": "u1", "num": 4}) is MISS

    def test_ttl_expiry(self):
        c = ResultCache(max_entries=8, ttl_s=0.01)
        q = {"user": "u1"}
        c.put(q, "r")
        time.sleep(0.03)
        assert c.get(q) is MISS

    def test_lru_eviction_bounded(self):
        c = ResultCache(max_entries=3, ttl_s=60.0)
        for i in range(5):
            c.put({"user": f"u{i}"}, i)
        assert len(c) == 3
        assert c.get({"user": "u0"}) is MISS          # evicted
        assert c.get({"user": "u4"}) == 4             # newest survives

    def test_invalidate_entities_is_per_user(self):
        c = ResultCache(max_entries=8, ttl_s=60.0)
        c.put({"user": "u1", "num": 3}, "a")
        c.put({"user": "u1", "num": 4}, "b")
        c.put({"user": "u2", "num": 3}, "c")
        c.invalidate_entities(["u1"])
        assert c.get({"user": "u1", "num": 3}) is MISS
        assert c.get({"user": "u1", "num": 4}) is MISS
        assert c.get({"user": "u2", "num": 3}) == "c"

    def test_anonymous_entries_invalidated_by_any_commit(self):
        # a query with no user key can depend on any entity → any
        # notification must drop it
        c = ResultCache(max_entries=8, ttl_s=60.0)
        c.put({"num": 10}, "top10")
        c.invalidate_entities(["whoever"])
        assert c.get({"num": 10}) is MISS

    def test_unencodable_query_never_cached(self):
        c = ResultCache(max_entries=8, ttl_s=60.0)
        q = {"user": "u1", "weird": object()}
        c.put(q, "r")          # silently uncacheable
        assert c.get(q) is MISS

    def test_put_after_an_invalidation_of_its_user_is_not_stored(self):
        c = ResultCache(max_entries=8, ttl_s=60.0)
        q1, q2 = {"user": "u1", "num": 3}, {"user": "u2", "num": 3}
        t1, t2 = c.token(), c.token()
        c.invalidate_entities(["u1"])  # nothing cached yet to drop
        c.put(q1, "before the fold", token=t1)
        c.put(q2, "r2", token=t2)  # another user: stored
        assert c.get(q1) is MISS
        assert c.get(q2) == "r2"
        c.put(q1, "after the fold", token=c.token())
        assert c.get(q1) == "after the fold"

    def test_put_after_a_variant_invalidation_or_clear_is_not_stored(self):
        c = ResultCache(max_entries=8, ttl_s=60.0)
        q = {"user": "u1"}
        token = c.token()
        c.invalidate_variant("a")
        c.put(q, "stale", "a", token)
        c.put(q, "other variant", "b", token)
        assert c.get(q, "a") is MISS and c.get(q, "b") == "other variant"
        token = c.token()
        c.clear()
        c.put(q, "stale", "b", token)
        assert c.get(q, "b") is MISS

    def test_pruned_epochs_refuse_older_puts_only(self):
        c = ResultCache(max_entries=1, ttl_s=60.0)
        token = c.token()
        for n in range(8):  # past 4 × max_entries users: pruned
            c.invalidate_entities([f"v{n}"])
        c.put({"user": "u1"}, "stale", token=token)
        assert c.get({"user": "u1"}) is MISS
        c.put({"user": "u1"}, "fresh", token=c.token())
        assert c.get({"user": "u1"}) == "fresh"


def test_cache_from_env(monkeypatch):
    from predictionio_torch.serving.result_cache import cache_from_env

    monkeypatch.delenv("PIO_HTTP_RESULT_CACHE", raising=False)
    assert cache_from_env() is None
    monkeypatch.setenv("PIO_HTTP_RESULT_CACHE", "1")
    monkeypatch.setenv("PIO_HTTP_RESULT_CACHE_SIZE", "12")
    monkeypatch.setenv("PIO_HTTP_RESULT_CACHE_TTL_S", "600")
    cache = cache_from_env()
    assert (cache.max_entries, cache.ttl_s) == (12, 600.0)


# -- tests/test_online.py: invalidation through the real wiring ----------------

def test_per_user_invalidation_spares_other_users_and_variants():
    """A delta-swap must drop exactly the touched users' cache entries —
    not the whole variant (that's /reload's job) and never another
    variant's — and a closed plane leaves the bus."""
    subscribers = len(BUS._subs)
    planes = {
        v: ServingPlane(lambda qs: [{"v": q["user"]} for q in qs],
                        config=ServingConfig(batching=False),
                        result_cache=ResultCache(max_entries=64,
                                                 ttl_s=600.0),
                        variant=v)
        for v in ("a", "b")
    }
    try:
        q1, q2 = {"user": "u1", "num": 3}, {"user": "u2", "num": 3}
        for plane in planes.values():
            plane.handle_query(q1, {})
            plane.handle_query(q2, {})
        for v, plane in planes.items():
            assert plane.result_cache.get(q1, v) is not MISS
            assert plane.result_cache.get(q2, v) is not MISS

        state = SimpleNamespace(models=["m"])
        swapper = DeltaSwapper({"a": state}, threading.Lock())
        swapper.swap("a", state, ["m2"], touched_users=["u1"])
        cache_a, cache_b = (planes[v].result_cache for v in ("a", "b"))
        assert cache_a.get(q1, "a") is MISS  # folded user dropped
        assert cache_a.get(q2, "a") is not MISS  # cross-user survival
        assert cache_b.get(q1, "b") is not MISS  # other variant intact
        assert cache_b.get(q2, "b") is not MISS
        # the full-reload path still drops the whole variant
        cache_a.invalidate_variant("a")
        assert cache_a.get(q2, "a") is MISS
    finally:
        for plane in planes.values():
            plane.close()
    assert len(BUS._subs) == subscribers


@pytest.mark.parametrize("swap", ["fold", "reload"])
def test_a_swap_during_the_dispatch_keeps_its_answer_out(swap):
    """A fold published on the bus (or a reload's variant drop) while a
    miss is being dispatched on the old state: the answer it computed
    is returned but not cached, so the next query dispatches again."""
    states = {"a": "old"}
    cache = ResultCache(max_entries=8, ttl_s=600.0)

    def dispatch(qs):
        answers = [{"state": states["a"]} for _ in qs]
        states["a"] = "new"  # the swap lands after the state was read
        if swap == "fold":
            BUS.publish([q["user"] for q in qs], variant="a")
        else:
            cache.invalidate_variant("a")
        return answers

    plane = ServingPlane(dispatch, config=ServingConfig(batching=False),
                         result_cache=cache, variant="a")
    try:
        q = {"user": "u1", "num": 3}
        assert plane.handle_query(q, {}) == ({"state": "old"}, False)
        assert len(cache) == 0
        assert plane.handle_query(q, {}) == ({"state": "new"}, False)
    finally:
        plane.close()


def test_delta_swap_invalidates_only_the_folded_user(storage, tmp_path,
                                                     monkeypatch):
    """Through the port's real wiring: fold → DeltaSwapper → BUS → the
    served plane's subscription → per-user drop; /reload keeps its
    full-variant drop; closing the server leaves the bus."""
    monkeypatch.setenv("PIO_HTTP_RESULT_CACHE", "1")
    # pin the TTL high so expiry can't fake the invalidation
    monkeypatch.setenv("PIO_HTTP_RESULT_CACHE_TTL_S", "600")
    subscribers = len(BUS._subs)
    _ingest(storage)
    _train(storage, _variant_dict())
    server = PredictionServer(_engine_json(tmp_path, _variant_dict()),
                              ip="127.0.0.1", port=0, device="cpu",
                              storage=storage,
                              online=OnlineConfig(interval_s=0.05))
    try:
        server.online.stop()  # polls are driven by hand
        cache = server.serving.result_cache
        assert cache is not None and len(BUS._subs) == subscribers + 1
        q0, q2 = {"user": "u0", "num": 3}, {"user": "u2", "num": 3}
        server.serving.handle_query(q0, {})
        server.serving.handle_query(q2, {})
        assert cache.get(q0, "rec-test") is not MISS
        assert cache.get(q2, "rec-test") is not MISS
        _rate(storage, "u0", "i6")
        assert server.online.poll_once() == 1
        assert cache.get(q0, "rec-test") is MISS, \
            "folded user's cached answer survived the swap"
        assert cache.get(q2, "rec-test") is not MISS, \
            "delta-swap dropped an untouched user's entry"
        # the fresh answer reflects the fold: i6 is now seen
        fresh, _ = server.serving.handle_query(q0, {})
        assert "i6" not in [s["item"] for s in fresh["itemScores"]]
        assert fresh == server.predict(q0)
        # full /reload: EVERY answer changed, whole variant drops
        server.reload()
        assert cache.get(q0, "rec-test") is MISS
        assert cache.get(q2, "rec-test") is MISS
    finally:
        server.server_close()
    assert len(BUS._subs) == subscribers
    assert not server.serving.batcher._thread.is_alive()


# -- tests/test_prediction_server.py and /reload over HTTP ----------------------

def test_32_simultaneous_connects_all_served(storage, tmp_path):
    """A 32-socket burst must fully connect and every connection must
    answer a query."""
    with deployed(storage, tmp_path, _variant_dict()) as server:
        socks = []
        try:
            # connect all 32 BEFORE any handler thread reads a request —
            # the queue, not handler speed, is what's under test
            for _ in range(32):
                socks.append(socket.create_connection(
                    ("127.0.0.1", server.port), timeout=10))
            body = json.dumps({"user": "u1", "num": 1}).encode()
            req = (b"POST /queries.json HTTP/1.1\r\n"
                   b"Host: x\r\nContent-Type: application/json\r\n"
                   b"Content-Length: " + str(len(body)).encode() +
                   b"\r\nConnection: close\r\n\r\n" + body)
            for s in socks:
                s.sendall(req)
            for s in socks:
                s.settimeout(30)
                first = s.recv(64)
                assert b"200" in first.split(b"\r\n")[0], first
        finally:
            for s in socks:
                s.close()


def cache_hits() -> float:
    from predictionio_torch.serving import result_cache

    return result_cache._HITS.value


def test_reload_drops_the_variants_cached_answers(storage, tmp_path,
                                                  monkeypatch):
    monkeypatch.setenv("PIO_HTTP_RESULT_CACHE", "1")
    monkeypatch.setenv("PIO_HTTP_RESULT_CACHE_TTL_S", "600")
    with deployed(storage, tmp_path, _variant_dict()) as server:
        cache = server.serving.result_cache
        q = {"user": "u0", "num": 3}
        first = call_raw(server.port, "POST", "/queries.json", q)[1]
        hits = cache_hits()
        assert call_raw(server.port, "POST", "/queries.json", q)[1] == first
        assert cache_hits() == hits + 1
        assert len(cache) == 1
        second = _train(storage, _variant_dict(), seed=2)[2].id
        status, body, _ = call_raw(server.port, "POST", "/reload")
        assert status == 200 and body["engineInstanceId"] == second
        assert len(cache) == 0 and cache.get(q, "rec-test") is MISS
        answer = call_raw(server.port, "POST", "/queries.json", q)[1]
        assert answer == server.predict(q)
        assert cache_hits() == hits + 1


# -- held against the reference's plane ----------------------------------------

N_USERS, N_ITEMS, RANK = 40, 60, 8


def _seeded_arrays(seed=13):
    """A model made with numpy: factors, id maps, seen pairs, popularity."""
    rng = np.random.default_rng(seed)
    users = {f"u{i}": i for i in range(N_USERS)}
    items = {f"i{i}": i for i in range(N_ITEMS)}
    uf = rng.normal(size=(N_USERS, RANK)).astype(np.float32)
    itf = rng.normal(size=(N_ITEMS, RANK)).astype(np.float32)
    seen_u = rng.integers(0, N_USERS, 300).astype(np.int32)
    seen_i = rng.integers(0, N_ITEMS, 300).astype(np.int32)
    counts = np.zeros(N_ITEMS, np.float32)
    np.add.at(counts, seen_i, 1.0)
    counts += rng.random(N_ITEMS).astype(np.float32) * 0.5  # no ties
    order = np.argsort(-counts, kind="stable").astype(np.int32)
    return users, items, uf, itf, seen_u, seen_i, counts, order


def _ref_models(arrays):
    users, items, uf, itf, seen_u, seen_i, counts, order = arrays
    als = RefALSModel(user_factors=uf, item_factors=itf,
                      user_ids=RefBiMap(dict(users)),
                      item_ids=RefBiMap(dict(items)),
                      seen=RefSeenItems(seen_u, seen_i, N_USERS))
    pop = RefPopularityModel(user_ids=RefBiMap(dict(users)),
                             item_ids=RefBiMap(dict(items)), counts=counts,
                             order=order,
                             seen=RefSeenItems(seen_u, seen_i, N_USERS))
    return [als, pop]


def _port_models(arrays):
    users, items, uf, itf, seen_u, seen_i, counts, order = arrays
    return [convert.als_model_from_arrays(uf, itf, users, items, seen_u,
                                          seen_i),
            convert.popularity_model_from_arrays(counts, order, users, items,
                                                 seen_u, seen_i)]


def _engine_fns(port=True, seed=13):
    """(dispatch, degraded) of one package's Recommendation engine over
    the numpy-seeded model, with the als + popular blend."""
    arrays = _seeded_arrays(seed)
    if port:
        factory, get, extract, variant_cls, models = (
            FACTORY, get_engine, extract_engine_params, EngineVariant,
            _port_models(arrays))
    else:
        factory, get, extract, variant_cls, models = (
            REF_FACTORY, ref_get_engine, ref_extract_engine_params,
            RefEngineVariant, _ref_models(arrays))
    variant = variant_cls.from_dict(_multi_variant_dict(factory))
    engine = get(variant.engine_factory)
    ep = extract(engine, variant)
    comp = engine.components(ep)
    return (lambda qs: engine.predict_batch(ep, models, qs, components=comp),
            lambda q: engine.degraded_predict(ep, models, q, components=comp))


def _planes(config, ref_config):
    """The reference's plane over its Engine.predict_batch and the port's
    over its own, one model in both."""
    return [plane_cls(*_engine_fns(port), config=cfg, variant="rec-multi")
            for plane_cls, port, cfg in ((RefServingPlane, False, ref_config),
                                         (ServingPlane, True, config))]


def _untied_equal(want, got, rtol=1e-5):
    """Item ids equal wherever the scores are not tied; scores within
    rtol 1e-5 (the two packages' products differ in the last bits)."""
    want, got = want["itemScores"], got["itemScores"]
    assert len(want) == len(got)
    ws = np.asarray([s["score"] for s in want], np.float64)
    gs = np.asarray([s["score"] for s in got], np.float64)
    np.testing.assert_allclose(gs, ws, rtol=rtol, atol=1e-6)
    gaps = np.abs(np.diff(ws)) < rtol * np.maximum(np.abs(ws[1:]), 1.0)
    tied = np.zeros(len(ws), bool)
    tied[:-1] |= gaps
    tied[1:] |= gaps
    for pos in np.nonzero(~tied)[0]:
        assert got[pos]["item"] == want[pos]["item"], (pos, want, got)


def _queries():
    rng = np.random.default_rng(5)
    qs = [{"user": f"u{int(u)}", "num": int(n)}
          for u, n in zip(rng.integers(0, N_USERS, 40),
                          rng.integers(1, 12, 40))]
    return qs + [{"user": "stranger", "num": 4}]


def _concurrently(plane, queries):
    """Each query from its own thread, started together."""
    out = [None] * len(queries)
    start = threading.Barrier(len(queries))

    def run(i):
        start.wait(timeout=JOIN_S)
        out[i] = plane.handle_query(queries[i], {})

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(queries))]
    for t in ts:
        t.start()
    _join_all(ts)
    return out


@pytest.mark.parametrize("batching", [True, False])
def test_port_plane_matches_the_reference_plane(batching):
    ref, port = _planes(ServingConfig(batching=batching),
                        RefServingConfig(batching=batching))
    try:
        queries = _queries()
        for q, (want, got) in zip(queries, zip(_concurrently(ref, queries),
                                               _concurrently(port, queries))):
            assert want[1] is got[1] is False
            _untied_equal(want[0], got[0])
            assert got[0]["itemScores"] or q["user"] == "stranger"
    finally:
        ref.close()
        port.close()


def test_degraded_answers_equal_the_references():
    shed = dict(max_queue=0, retry_after_s=3.0)
    ref, port = _planes(ServingConfig(admission=AdmissionConfig(**shed)),
                        RefServingConfig(
                            admission=ref_admission.AdmissionConfig(**shed)))
    try:
        for q in _queries():
            want, got = ref.handle_query(q, {}), port.handle_query(q, {})
            assert got == want and got[1] is True
            assert got[0]["itemScores"]  # popularity ranks every user
    finally:
        ref.close()
        port.close()


def test_serving_contract_equals_the_references():
    """The bucket ladder, the deadline header's reading, the admission
    defaults and the result cache's key of a query are the reference's."""
    for n in range(1, 130):
        assert bucket_ladder(n) == ref_batcher.bucket_ladder(n)
        # the reference pads to its config's default ladder
        assert (bucket_ladder(n)
                == ref_batcher.BatcherConfig(max_batch=n).resolved_buckets())
    assert ((BatcherConfig().max_batch, BatcherConfig().max_wait_ms)
            == (ref_batcher.BatcherConfig().max_batch,
                ref_batcher.BatcherConfig().max_wait_ms))
    assert (AdmissionConfig().__dict__
            == ref_admission.AdmissionConfig().__dict__)
    cfg, ref_cfg = AdmissionConfig(default_deadline_ms=30.0,
                                   max_deadline_ms=500.0), \
        ref_admission.AdmissionConfig(default_deadline_ms=30.0,
                                      max_deadline_ms=500.0)
    for headers in (None, {}, {DEADLINE_HEADER: "250"},
                    {DEADLINE_HEADER: "0"}, {DEADLINE_HEADER: "-1"},
                    {DEADLINE_HEADER: "soon"}, {DEADLINE_HEADER: "1e9"},
                    {DEADLINE_HEADER: "0.0001"}):
        for a, b in ((AdmissionConfig(), ref_admission.AdmissionConfig()),
                     (cfg, ref_cfg)):
            t_got = time.monotonic()
            got = deadline_from_headers(headers, a)
            t_want = time.monotonic()
            want = ref_admission.deadline_from_headers(headers, b)
            assert (got is None) == (want is None), headers
            if got is not None:
                # the same budget from the moment of each call
                assert abs((got - t_got) - (want - t_want)) < 0.05, headers
    for q in ({"user": "u1", "num": 3}, {"num": 3, "user": "u1"},
              {"user": "é ü", "num": 2, "x": [1.5, None, True]},
              {"user": 7}, [1, 2], "q", {"items": ["i1"], "score": 1e-9}):
        for variant in ("", "rec-multi"):
            assert (ResultCache._key(q, variant)
                    == RefResultCache._key(q, variant)), (q, variant)
            assert ResultCache._user(q) == RefResultCache._user(q)


@pytest.mark.parametrize("max_batch", [8, 32, 64])
def test_batched_equals_single_bitwise_within_the_port(max_batch):
    """At max_batch ≤ SERVE_HOST_MAX_BATCH every batch scores on the
    host, one gemv a user: a query's answer through any batch equals its
    answer alone, bit for bit."""
    dispatch, _ = _engine_fns()
    queries = _queries() * 2
    alone = [dispatch([q])[0] for q in queries]
    sizes = []
    plane = None

    def gated(qs):
        # the first dispatch waits until every other query is queued, so
        # the rest leave in full batches
        if not sizes:
            deadline = time.monotonic() + 10
            while (len(plane.batcher._queue) + len(qs) < len(queries)
                   and time.monotonic() < deadline):
                time.sleep(0.001)
        sizes.append(len(qs))
        return dispatch(qs)

    plane = ServingPlane(gated, config=ServingConfig(batcher=BatcherConfig(
        max_batch=max_batch, max_wait_ms=50.0)))
    try:
        together = _concurrently(plane, queries)
    finally:
        plane.close()
    assert [r for r, _ in together] == alone
    assert max(sizes) == max_batch, sizes  # full batches formed
    assert dispatch(queries[:max_batch]) == alone[:max_batch]
