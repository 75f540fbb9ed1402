"""The port's online session fold (`online/session.py`) and the online
plane's session branch, on the CPU:

- every case of the reference's tests/test_online_session.py, run on the
  port: the window rule, the fold (rebuilt window and embedding, a
  re-viewed item moving to the end, cold items dropped and counted,
  replay bit-identical, untouched users kept), the plane end to end and
  the crash replay at `online.pre_watermark`, and the telemetry families;
- the port's `SessionFold` beside the reference's on the same seeded
  histories (250 users, cold items, time ties, re-views): the same
  windows, the same `FoldStats`, `session_vecs` equal bit for bit;
- the folded model's device copy: its own dict of the old model's
  tensors, and the old model's answers unchanged by the fold.
"""

import contextlib
import dataclasses
import json
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from predictionio_tpu.data.bimap import BiMap as RefBiMap
from predictionio_tpu.models.session_model import (
    SessionRecModel as RefSessionRecModel,
)
from predictionio_tpu.online.session import SessionFold as RefSessionFold
from predictionio_torch import convert
from predictionio_torch.controller import WorkflowContext
from predictionio_torch.data.bimap import BiMap
from predictionio_torch.data.datamap import DataMap
from predictionio_torch.data.events import Event
from predictionio_torch.models.session_model import (
    SessionRecModel,
    recent_window,
)
from predictionio_torch.online import (
    ALSFold,
    FoldModel,
    OnlineConfig,
    SessionFold,
)
from predictionio_torch.online.metrics import (
    ONLINE_FAMILY_FRESHNESS,
    SESSION_COLD_ITEMS,
    SESSION_WINDOWS_FOLDED,
)
from predictionio_torch.storage.registry import (
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_torch.telemetry.registry import REGISTRY
from predictionio_torch.templates.sessionrec import engine as sessionrec
from predictionio_torch.utils.faults import FaultInjected
from predictionio_torch.workflow.core_workflow import CoreWorkflow
from predictionio_torch.workflow.create_server import PredictionServer
from predictionio_torch.workflow.workflow_utils import (
    EngineVariant,
    extract_engine_params,
    get_engine,
)
from tests.test_torch_sessionrec import ingest_views, variant_dict

torch.set_num_threads(1)

T0 = datetime(2026, 3, 1, tzinfo=timezone.utc)


def _view(user, item, t):
    return Event(event="view", entity_type="user", entity_id=user,
                 target_entity_type="item", target_entity_id=item,
                 properties=DataMap({}), event_time=t)


def _tiny_model():
    # 4 trained items + the pad row, 3-dim embeddings
    emb = np.arange(15, dtype=np.float32).reshape(5, 3)
    return SessionRecModel(
        params={"emb": emb},
        item_ids=BiMap.string_int([f"i{k}" for k in range(4)]),
        user_windows={}, session_vecs={}, max_seq_len=3, n_heads=1)


# -- the reference's cases --------------------------------------------------

class TestRecentWindow:
    """The one rule training and the online fold share."""

    def test_keep_last_and_time_order(self):
        pairs = [("a", T0), ("b", T0 + timedelta(seconds=1)),
                 ("a", T0 + timedelta(seconds=2))]
        # a's position is its LATEST event: it moves behind b
        assert recent_window(pairs, 10) == ["b", "a"]

    def test_caps_to_most_recent(self):
        pairs = [(f"x{k}", T0 + timedelta(seconds=k)) for k in range(5)]
        assert recent_window(pairs, 3) == ["x2", "x3", "x4"]

    def test_arrival_order_is_irrelevant(self):
        pairs = [("a", T0), ("b", T0 + timedelta(seconds=1)),
                 ("c", T0 + timedelta(seconds=2))]
        shuffled = [pairs[2], pairs[0], pairs[1]]
        assert recent_window(pairs, 10) == recent_window(shuffled, 10)

    def test_time_ties_break_by_item_id(self):
        assert recent_window([("b", T0), ("a", T0)], 10) == ["a", "b"]


class TestSessionFold:
    def test_is_a_fold_model(self):
        assert issubclass(SessionFold, FoldModel)
        assert SessionFold.family == "sessionrec"
        assert ALSFold.family == "als"

    def test_fold_rebuilds_window_and_embedding(self):
        m = _tiny_model()
        hist = {"u1": [("i0", 1.0, T0),
                       ("i2", 1.0, T0 + timedelta(seconds=2)),
                       ("i1", 1.0, T0 + timedelta(seconds=1))]}
        folded, stats = SessionFold(max_seq_len=3).fold(m, hist)
        assert folded is not m and m.user_windows == {}  # input untouched
        assert folded.user_windows["u1"] == ("i0", "i1", "i2")
        assert np.array_equal(folded.session_vecs["u1"],
                              m.session_vec_of(("i0", "i1", "i2")))
        assert stats.folded_users == 1 and stats.new_items == 0

    def test_rewatched_item_moves_to_the_end(self):
        m = _tiny_model()
        hist = {"u1": [("i0", 1.0, T0),
                       ("i1", 1.0, T0 + timedelta(seconds=1)),
                       ("i2", 1.0, T0 + timedelta(seconds=2)),
                       ("i0", 1.0, T0 + timedelta(seconds=3))]}
        folded, _ = SessionFold(max_seq_len=3).fold(m, hist)
        assert folded.user_windows["u1"] == ("i1", "i2", "i0")

    def test_cold_items_dropped_and_counted(self):
        m = _tiny_model()
        base = SESSION_COLD_ITEMS.value
        hist = {"u1": [("i1", 1.0, T0),
                       ("never-trained", 1.0, T0 + timedelta(seconds=1))]}
        folded, stats = SessionFold(max_seq_len=3).fold(m, hist)
        assert folded.user_windows["u1"] == ("i1",)
        assert stats.new_items == 1
        assert SESSION_COLD_ITEMS.value == base + 1

    def test_replay_is_bit_identical(self):
        # at-least-once safety: re-applying the same history is a no-op
        # because the fold recomputes from keep-last state, not appends
        m = _tiny_model()
        hist = {"u1": [("i3", 1.0, T0), ("i0", 1.0, T0)]}
        fold = SessionFold(max_seq_len=3)
        once, _ = fold.fold(m, hist)
        twice, _ = fold.fold(once, hist)
        assert twice.user_windows["u1"] == once.user_windows["u1"]
        assert np.array_equal(twice.session_vecs["u1"],
                              once.session_vecs["u1"])

    def test_untouched_users_keep_their_state(self):
        m = _tiny_model()
        first, _ = SessionFold(3).fold(m, {"u1": [("i0", 1.0, T0)]})
        second, _ = SessionFold(3).fold(first, {"u2": [("i1", 1.0, T0)]})
        assert second.user_windows["u1"] == first.user_windows["u1"]
        assert second.session_vecs["u1"] is first.session_vecs["u1"]


@pytest.fixture()
def storage():
    src = SourceConfig(name="SESSFOLD_TEST", type="memory")
    s = Storage(StorageConfig(metadata=src, modeldata=src, eventdata=src))
    yield s
    s.close()


def _train_session_variant(storage, engine_json_path):
    """ingest_views + one CPU train of the sess-test variant; returns the
    app id. The engine.json it writes is what the server deploys."""
    app_id = ingest_views(storage)
    spec = variant_dict()
    with open(engine_json_path, "w") as f:
        json.dump(spec, f)
    variant = EngineVariant.from_dict(spec)
    engine = get_engine(variant.engine_factory)
    CoreWorkflow.run_train(engine, extract_engine_params(engine, variant),
                           variant, WorkflowContext(device="cpu",
                                                    storage=storage, seed=1))
    return app_id


@contextlib.contextmanager
def session_server(storage, engine_json, **online_kw):
    server = PredictionServer(engine_json, ip="127.0.0.1", port=0,
                              device="cpu", storage=storage,
                              online=OnlineConfig(**online_kw))
    try:
        server.online.stop()  # polls are driven by hand
        yield server
    finally:
        server.server_close()


class TestSessionPlaneEndToEnd:
    def test_view_events_fold_to_servable(self, storage, tmp_path):
        engine_json = str(tmp_path / "engine.json")
        app_id = _train_session_variant(storage, engine_json)
        folded_base = SESSION_WINDOWS_FOLDED.value
        ch = ONLINE_FAMILY_FRESHNESS.labels(family="sessionrec")
        obs_base = ch.count
        with session_server(storage, engine_json, interval_s=0.05) as server:
            ctx = server.online._contexts[0]
            handles = [h for _, h in ctx.folds]
            assert any(isinstance(h, SessionFold) for h in handles)
            assert [h.max_seq_len for h in handles] == [16]  # maxSeqLen
            assert ctx.als == []  # compat view: no ALS arms here
            le = storage.l_events()
            # event times must be live (ahead of the tailer's since-
            # training watermark), strictly ordered to pin the window
            now = datetime.now(timezone.utc)
            for j, item in enumerate(("i1", "i3", "i5")):
                le.insert(_view("fresh-u", item,
                                now + timedelta(milliseconds=j)), app_id)
            assert server.online.poll_once() > 0
            model = server._states["sess-test"].models[0]
            assert model.user_windows["fresh-u"] == ("i1", "i3", "i5")
            assert np.array_equal(
                model.session_vecs["fresh-u"],
                model.session_vec_of(("i1", "i3", "i5")))
            result, _ = server.serving.handle_query(
                {"user": "fresh-u", "num": 3}, {})
            scores = result.get("itemScores")
            assert scores, "fresh session user should be servable"
            # seen-exclusion reflects the freshly folded window
            assert all(s["item"] not in ("i1", "i3", "i5") for s in scores)
            # batched ≡ single after the fold: the user's answer is its
            # window's answer
            assert result == server.predict(
                {"items": ["i1", "i3", "i5"], "num": 3})
        assert SESSION_WINDOWS_FOLDED.value > folded_base
        assert ch.count > obs_base  # per-family slice observed

    def test_crash_replay_is_bit_identical(self, storage, tmp_path,
                                           monkeypatch):
        engine_json = str(tmp_path / "engine.json")
        app_id = _train_session_variant(storage, engine_json)
        with session_server(storage, engine_json, interval_s=0.05) as server:
            le = storage.l_events()
            server.online.poll_once()  # drain any startup backlog
            now = datetime.now(timezone.utc)
            for j, item in enumerate(("i2", "i4", "i6")):
                le.insert(_view("crash-u", item,
                                now + timedelta(milliseconds=j)), app_id)
            monkeypatch.setenv("PIO_FAULTS", "online.pre_watermark=error")
            with pytest.raises(FaultInjected):
                server.online.poll_once()
            model = server._states["sess-test"].models[0]
            window = model.user_windows.get("crash-u")
            assert window == ("i2", "i4", "i6")  # fold landed pre-crash
            vec = np.array(model.session_vecs["crash-u"], copy=True)
            scores0, _ = server.serving.handle_query(
                {"user": "crash-u", "num": 3}, {})
            monkeypatch.setenv("PIO_FAULTS", "")
            assert server.online.poll_once() > 0  # unacked replays
            model2 = server._states["sess-test"].models[0]
            assert model2.user_windows["crash-u"] == window
            assert np.array_equal(model2.session_vecs["crash-u"], vec)
            scores1, _ = server.serving.handle_query(
                {"user": "crash-u", "num": 3}, {})
            assert scores0 == scores1
            assert server.online.poll_once() == 0  # nothing left


class TestSessionTelemetry:
    def test_session_families_render(self):
        text = REGISTRY.render()
        for family in ("online_family_event_to_servable_seconds",
                       "session_windows_folded_total",
                       "session_cold_items_total"):
            assert f"# TYPE {family} " in text


# -- the port beside the reference ------------------------------------------

N_ITEMS, N_COLD, N_USERS, MAX_LEN = 100, 20, 250, 16


def _params(seed=0):
    return sessionrec.init_params(N_ITEMS, 8, 1, 16,
                                  np.random.default_rng(seed))


def _histories(seed=1):
    """N_USERS users' keep-last histories of 1-40 views over N_ITEMS known
    and N_COLD cold items, times on a coarse grid (ties), items repeated
    (re-views), in shuffled arrival order."""
    rng = np.random.default_rng(seed)
    out = {}
    for u in range(N_USERS):
        n = int(rng.integers(1, 41))
        items = rng.integers(0, N_ITEMS + N_COLD, n)
        secs = rng.integers(0, 12, n)
        out[f"u{u}"] = [(f"i{int(i)}", float(rng.integers(1, 6)),
                         T0 + timedelta(seconds=int(s)))
                        for i, s in zip(items, secs)]
    return out


def test_port_fold_equals_reference_fold():
    params = _params()
    ids = {f"i{k}": k for k in range(N_ITEMS)}
    start = {f"u{u}": (f"i{u % N_ITEMS}",) for u in range(0, 400, 3)}
    port = convert.session_model_from_arrays(params, ids, start, MAX_LEN, 2)
    ref = RefSessionRecModel(
        params=params, item_ids=RefBiMap(dict(ids)),
        user_windows=dict(port.user_windows),
        session_vecs=dict(port.session_vecs), max_seq_len=MAX_LEN,
        n_heads=2)
    hist = _histories()
    assert sum(len(h) for h in hist.values()) > 4_000
    got, got_stats = SessionFold(MAX_LEN).fold(port, hist)
    want, want_stats = RefSessionFold(MAX_LEN).fold(ref, hist)
    assert dataclasses.asdict(got_stats) == dataclasses.asdict(want_stats)
    assert got_stats.folded_users == N_USERS and got_stats.new_items > 0
    assert got.user_windows == want.user_windows
    assert got.user_windows != port.user_windows
    assert set(got.session_vecs) == set(want.session_vecs)
    for u, vec in want.session_vecs.items():
        assert np.array_equal(got.session_vecs[u], vec), u
    # the inputs are untouched on both sides
    assert port.user_windows == ref.user_windows == {
        u: w for u, w in start.items()}
    # a replay lands on the same bits on both sides
    again, _ = SessionFold(MAX_LEN).fold(got, hist)
    assert again.user_windows == got.user_windows
    for u, vec in got.session_vecs.items():
        assert np.array_equal(again.session_vecs[u], vec)


def test_folded_model_owns_its_device_copy():
    """The folded model's `_on_device` is its own dict holding the old
    model's tensors (no re-upload), and the old model answers as before."""
    params = _params(seed=2)
    ids = {f"i{k}": k for k in range(N_ITEMS)}
    model = convert.session_model_from_arrays(
        params, ids, {"u1": ("i1", "i2", "i3"), "u2": ("i4",)}, MAX_LEN, 2)
    model.device = "cpu"
    algo = sessionrec.SessionRecAlgorithm(sessionrec.SessionRecParams(
        embedDim=8, numBlocks=1, numHeads=2, maxSeqLen=MAX_LEN))
    queries = [{"user": "u1", "num": 5}, {"user": "u2", "num": 5}]
    before = algo.batch_predict(model, queries)
    cpu = torch.device("cpu")
    on_device = model.device_params(cpu)
    folded, _ = SessionFold(MAX_LEN).fold(
        model, {"u1": [("i7", 1.0, T0), ("i8", 1.0, T0)]})
    assert folded._on_device is not model._on_device
    assert folded.device_params(cpu) is on_device  # the same tensors
    assert all(folded.device_params(cpu)[k] is v
               for k, v in on_device.items())
    folded._on_device.clear()  # the new model's dict alone
    assert model._on_device[str(cpu)] is on_device
    assert algo.batch_predict(model, queries) == before
    assert model.user_windows["u1"] == ("i1", "i2", "i3")
    after = algo.batch_predict(folded, queries)
    assert after[1] == before[1]  # u2 untouched
    assert after[0] == algo.batch_predict(
        model, [{"items": ["i7", "i8"], "num": 5}])[0]
