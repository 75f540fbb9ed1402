"""The port's sessionrec template on the CPU: the reference's cases
(tests/test_sessionrec_template.py) on the port's memory storage, the
train held against the reference's (the same initial params bit for bit,
each epoch's loss within rtol 1e-4, the params after 4 epochs within
max-abs 1e-4), a model the reference trained served through the port
(`convert.session_model_from_arrays`: the same top-k ids wherever they
are untied), and the template through the console (`template get`,
`build`, `train`, `deploy`, both query forms over HTTP, and `eval` of
SessionRecEvaluation).

The reference's `test_repeat_traffic_adds_zero_compiles` reads JAX's
compile counter and has no counterpart: the port runs eagerly, and its
metered dispatch comes with the device telemetry (ROADMAP item 11a)."""

import json
from datetime import datetime, timedelta, timezone

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.controller import WorkflowContext as RefContext
from predictionio_tpu.templates.sessionrec import engine as ref_engine
from predictionio_tpu.workflow.workflow_utils import (
    EngineVariant as RefEngineVariant,
    extract_engine_params as ref_extract_engine_params,
    get_engine as ref_get_engine,
)
from predictionio_torch import convert
from predictionio_torch.controller import WorkflowContext
from predictionio_torch.data.datamap import DataMap
from predictionio_torch.data.events import Event
from predictionio_torch.ops import session
from predictionio_torch.serving.batcher import (
    pad_to_seq_tier,
    seq_tier_ladder,
    seq_tiers_from_env,
)
from predictionio_torch.storage.base import App
from predictionio_torch.storage.registry import (
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_torch.templates.sessionrec.engine import (
    DataSource,
    DataSourceParams,
    TrainingData,
    _pad_batch_tier,
    _serve_tiers,
)
from predictionio_torch.tools import console
from predictionio_torch.workflow.core_workflow import CoreWorkflow
from predictionio_torch.workflow.workflow_utils import (
    EngineVariant,
    extract_engine_params,
    get_engine,
)
from tests.test_online_session import ingest_views as ref_ingest_views
from tests.test_torch_similarproduct import port_storage  # noqa: F401
from tests.test_torch_templates_registry import _deployed, _in_process, _post

FACTORY = "predictionio_torch.templates.sessionrec.SessionRecEngine"
T0 = datetime(2026, 3, 1, tzinfo=timezone.utc)

torch.set_num_threads(1)


def ingest_views(storage, n_users=6, n_items=8, per_user=4,
                 app_name="SessApp"):
    """Rotating runs of views per user, strictly time-ordered (the
    reference's tests/test_online_session.py::ingest_views)."""
    app_id = storage.meta_apps().insert(App(id=0, name=app_name))
    le = storage.l_events()
    for u in range(n_users):
        for k in range(per_user):
            le.insert(Event(event="view", entity_type="user",
                            entity_id=f"u{u}", target_entity_type="item",
                            target_entity_id=f"i{(u + k) % n_items}",
                            properties=DataMap({}),
                            event_time=T0 + timedelta(minutes=k)), app_id)
    return app_id


def variant_dict(app_name="SessApp", max_seq_len=16, epochs=4,
                 factory=FACTORY, embed_dim=8, n_blocks=1):
    return {
        "id": "sess-test",
        "engineFactory": factory,
        "datasource": {"params": {"appName": app_name}},
        "algorithms": [{"name": "attention", "params": {
            "embedDim": embed_dim, "numBlocks": n_blocks, "numHeads": 2,
            "maxSeqLen": max_seq_len, "epochs": epochs, "stepSize": 0.05,
            "seed": 1}}],
    }


@pytest.fixture(scope="module")
def trained():
    """One trained sessionrec engine on the port's memory storage, shared
    by the module (every test below only reads the model)."""
    src = SourceConfig(name="SESSREC_TEST", type="memory")
    storage = Storage(StorageConfig(metadata=src, modeldata=src,
                                    eventdata=src))
    Storage.reset(storage)
    try:
        ingest_views(storage)
        variant = EngineVariant.from_dict(variant_dict())
        engine = get_engine(variant.engine_factory)
        ep = extract_engine_params(engine, variant)
        ctx = WorkflowContext(device="cpu", storage=storage, seed=1)
        instance = CoreWorkflow.run_train(engine, ep, variant, ctx)
        assert instance.status == "COMPLETED"
        blob = storage.model_data_models().get(instance.id).models
        models = engine.deserialize_models(blob)
        yield engine, ep, models
    finally:
        storage.close()
        Storage.reset(None)


def _scores(result):
    return [(s["item"], s["score"]) for s in result["itemScores"]]


class TestSeqTierHelpers:
    def test_ladder_is_powers_of_two_covering_max(self):
        assert seq_tier_ladder(32) == (8, 16, 32)
        assert seq_tier_ladder(20) == (8, 16, 32)
        assert seq_tier_ladder(8) == (8,)
        assert seq_tier_ladder(2) == (8,)

    def test_env_override_sorted_deduped_covering(self, monkeypatch):
        monkeypatch.setenv("PIO_SERVING_SEQ_TIERS", "32, 8,8")
        assert seq_tiers_from_env(32) == (8, 32)
        # a ladder that undercuts the window length grows a top tier
        monkeypatch.setenv("PIO_SERVING_SEQ_TIERS", "8")
        assert seq_tiers_from_env(32) == (8, 32)
        monkeypatch.setenv("PIO_SERVING_SEQ_TIERS", "garbage")
        assert seq_tiers_from_env(32) == seq_tier_ladder(32)

    def test_pad_to_seq_tier(self):
        assert pad_to_seq_tier(3, (8, 16)) == 8
        assert pad_to_seq_tier(9, (8, 16)) == 16
        assert pad_to_seq_tier(40, (8, 16)) == 16  # callers truncate

    def test_batch_tier_is_power_of_two(self):
        assert [_pad_batch_tier(n) for n in (1, 2, 3, 5, 8)] == \
            [1, 2, 4, 8, 8]


class TestServeTiers:
    def test_env_ladder_clamped_to_positional_table(self, trained,
                                                    monkeypatch):
        _, _, models = trained
        model = models[0]
        monkeypatch.setenv("PIO_SERVING_SEQ_TIERS", "4,16,64")
        # 64 exceeds the trained positional table (16 rows): dropped
        assert _serve_tiers(model) == (4, 16)
        monkeypatch.setenv("PIO_SERVING_SEQ_TIERS", "64")
        # nothing servable survives the clamp → default ladder fallback
        assert _serve_tiers(model) == seq_tier_ladder(model.max_seq_len)


class TestTrainAndServe:
    def test_trained_model_serves_next_items(self, trained):
        engine, ep, models = trained
        result = engine.predict(ep, models, {"user": "u0", "num": 3})
        scores = result["itemScores"]
        assert scores
        window = set(models[0].user_windows["u0"])
        assert all(s["item"] not in window for s in scores)
        vals = [s["score"] for s in scores]
        assert vals == sorted(vals, reverse=True)

    def test_explicit_items_query_matches_served_window(self, trained):
        engine, ep, models = trained
        window = list(models[0].user_windows["u2"])
        by_user = engine.predict(ep, models, {"user": "u2", "num": 4})
        by_items = engine.predict(ep, models, {"items": window, "num": 4})
        assert _scores(by_user) == _scores(by_items)

    def test_unknown_user_and_empty_history_answer_empty(self, trained):
        engine, ep, models = trained
        assert engine.predict(ep, models, {"user": "nobody", "num": 3}) == \
            {"itemScores": []}
        assert engine.predict(ep, models, {"items": [], "num": 3}) == \
            {"itemScores": []}

    def test_model_file_holds_no_device_copy(self, trained):
        """The served device copy is made once per loaded model and is
        left out of the pickle; the params stay numpy arrays."""
        engine, ep, models = trained
        model = models[0]
        engine.predict(ep, models, {"user": "u1", "num": 2})
        cached = model.device_params(torch.device("cpu"))
        engine.predict(ep, models, {"user": "u3", "num": 2})
        assert model.device_params(torch.device("cpu")) is cached
        again = engine.deserialize_models(engine.serialize_models(models))[0]
        assert again._on_device == {}
        assert isinstance(again.params["emb"], np.ndarray)


class TestTierParity:
    """Bitwise invariance across tiers and batches, within the port."""

    def _histories(self):
        items = [f"i{k}" for k in range(8)]
        # lengths chosen to land on BOTH default tiers (8 and 16)
        return [items[:2], items[:5], items + items[:3]]

    def test_batched_vs_single_bitwise_at_every_tier(self, trained):
        engine, ep, models = trained
        model = models[0]
        queries = [{"items": h, "num": 4} for h in self._histories()]
        tiers = {pad_to_seq_tier(len(model.window_rows(h)),
                                 _serve_tiers(model))
                 for h in self._histories()}
        assert len(tiers) > 1 or max(
            len(model.window_rows(h)) for h in self._histories()) <= 8
        singles = [engine.predict(ep, models, q) for q in queries]
        batched = engine.predict_batch(ep, models, queries)
        for s, b in zip(singles, batched):
            assert _scores(s) == _scores(b)  # float-exact

    def test_same_history_scores_bitwise_on_a_different_ladder(
            self, trained, monkeypatch):
        # re-rung the ladder so the SAME 2-item history pads to 16 and to
        # 5 instead of 8: its scores must not move by a single bit
        engine, ep, models = trained
        q = {"items": ["i1", "i4"], "num": 5}
        default = engine.predict(ep, models, q)
        for ladder in ("16", "5,12"):
            monkeypatch.setenv("PIO_SERVING_SEQ_TIERS", ladder)
            assert _scores(engine.predict(ep, models, q)) == _scores(default)


class TestEvaluation:
    def test_read_eval_leaves_last_item_out(self, port_storage):
        ingest_views(port_storage)
        ds = DataSource(DataSourceParams(appName="SessApp", evalK=2))
        ctx = WorkflowContext(device="cpu", storage=port_storage, seed=1)
        full = ds.read_training(ctx).sequences
        folds = ds.read_eval(ctx)
        assert len(folds) == 2
        held_total = 0
        for td, qa in folds:
            assert qa
            held_total += len(qa)
            for q, actual in qa:
                prefix, (target,) = q["items"], actual["items"]
                u = next(u for u, s in full.items()
                         if s[:-1] == prefix and s[-1] == target)
                # the held-out user's training sequence dropped its last
                assert td.sequences[u] == prefix
        eligible = sum(1 for s in full.values() if len(s) >= 2)
        assert held_total == eligible  # every 2+ user held out once

    def test_sanity_check_requires_a_transition(self):
        with pytest.raises(ValueError):
            TrainingData(sequences={"u": ["i1"]}).sanity_check()
        TrainingData(sequences={"u": ["i1", "i2"]}).sanity_check()

    def test_canonical_rule_is_shared_with_training(self, port_storage):
        # the DataSource's sequences ARE recent_window over the event fold
        ingest_views(port_storage, n_users=1, n_items=4, per_user=6)
        ds = DataSource(DataSourceParams(appName="SessApp"))
        seqs = ds.read_training(WorkflowContext(
            device="cpu", storage=port_storage, seed=1)).sequences
        # user 0 views i0,i1,i2,i3,i0,i1 → keep-last: i2,i3,i0,i1
        assert seqs["u0"] == ["i2", "i3", "i0", "i1"]


# -- against the reference ---------------------------------------------------

def _engines(**kw):
    """((port engine, its params), (reference engine, its params))."""
    out = []
    for factory, variant_cls, get, extract in (
            (FACTORY, EngineVariant, get_engine, extract_engine_params),
            (FACTORY.replace("predictionio_torch.", "predictionio_tpu."),
             RefEngineVariant, ref_get_engine, ref_extract_engine_params)):
        variant = variant_cls.from_dict(variant_dict(factory=factory, **kw))
        engine = get(variant.engine_factory)
        out.append((engine, extract(engine, variant)))
    return out


def _both_stores(port_storage, memory_storage, **kw):
    """The same views in a memory store of each package: the reference's
    ingest_views and the port's."""
    ingest_views(port_storage, **kw)
    ref_ingest_views(memory_storage, **kw)


STORE = dict(n_users=24, n_items=30, per_user=9)


def _ref_ctx(storage):
    return RefContext(mesh_shape={"data": 1, "model": 1}, seed=1,
                      storage=storage)


@pytest.mark.parametrize("embed_dim,n_blocks", [(16, 1), (8, 2)])
def test_train_matches_reference(port_storage, memory_storage, embed_dim,
                                 n_blocks):
    """The same sequences, item rows and initial params (bit for bit: the
    same draws in the same order); each of 4 epochs' losses within rtol
    1e-4 of the reference's `_train_step`; the trained params within
    max-abs 1e-4; served windows and pooled vectors equal."""
    _both_stores(port_storage, memory_storage, **STORE)
    kw = dict(embed_dim=embed_dim, n_blocks=n_blocks, max_seq_len=32)
    (port, port_ep), (ref, ref_ep) = _engines(**kw)
    port_ctx = WorkflowContext(device="cpu", storage=port_storage, seed=1)
    port_td = port.components(port_ep)[0].read_training(port_ctx)
    ref_td = ref.components(ref_ep)[0].read_training(_ref_ctx(memory_storage))
    assert port_td.sequences == ref_td.sequences
    port_pd = port.components(port_ep)[1].prepare(port_ctx, port_td)
    (_, algo), = port.components(port_ep)[2]
    (_, ref_algo), = ref.components(ref_ep)[2]
    for a in (algo, ref_algo):
        a.params.epochs = 0
    init = algo.train(port_ctx, port_pd).params
    ref_pd = ref.components(ref_ep)[1].prepare(None, ref_td)
    ref_init = ref_algo.train(_ref_ctx(memory_storage), ref_pd).params
    jax.tree_util.tree_map(np.testing.assert_array_equal, init, ref_init)

    from predictionio_torch.templates.sessionrec.engine import training_batch

    seq, lengths, n = training_batch(port_pd.user_seqs, len(port_pd.item_ids),
                                     32, 32)
    assert n == 24
    _, losses = session.train_params(init, seq, lengths, 2, 0.05, 4,
                                     torch.device("cpu"))
    step = ref_engine._train_step(2, 0.05)
    p = jax.tree_util.tree_map(jnp.asarray, ref_init)
    m = jax.tree_util.tree_map(jnp.zeros_like, p)
    v = jax.tree_util.tree_map(jnp.zeros_like, p)
    t, ref_losses = np.float32(0.0), []
    for _ in range(4):
        p, m, v, t, loss = step(p, m, v, t, seq, lengths)
        ref_losses.append(float(loss))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)

    for a in (algo, ref_algo):
        a.params.epochs = 4
    model = algo.train(port_ctx, port_pd)
    ref_model = ref_algo.train(_ref_ctx(memory_storage), ref_pd)
    diffs = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda got, want: float(np.abs(got - np.asarray(want)).max()),
        model.params, ref_model.params))
    assert max(diffs) < 1e-4, diffs
    assert model.user_windows == ref_model.user_windows
    for u, vec in ref_model.session_vecs.items():
        np.testing.assert_allclose(model.session_vecs[u], vec, rtol=1e-4,
                                   atol=1e-5)


def _untied_ids_equal(got, want, gap=1e-5):
    """The ranked ids agree at every position whose score is more than
    `gap` from its neighbours' in `want` (the answer's last position is
    compared only when `want` ranks past it)."""
    w_ids = [s["item"] for s in want["itemScores"]]
    w_sc = [s["score"] for s in want["itemScores"]]
    g_ids = [s["item"] for s in got["itemScores"]]
    checked = 0
    for k in range(len(w_ids) - 1):
        lo = w_sc[k - 1] - w_sc[k] if k else np.inf
        if min(lo, w_sc[k] - w_sc[k + 1]) > gap:
            assert g_ids[k] == w_ids[k], (k, got, want)
            checked += 1
    return checked


def test_reference_model_serves_through_the_port(memory_storage):
    """A model the reference trained, carried by
    `session_model_from_arrays`, answers both query forms with the same
    ids wherever untied, its scores within rtol 1e-5 / atol 1e-6 of the
    reference's, and its pooled vectors equal."""
    ref_ingest_views(memory_storage, **STORE)
    _, (ref, ref_ep) = _engines(max_seq_len=32, embed_dim=16)
    ref_model = ref.train(_ref_ctx(memory_storage), ref_ep)[0]
    model = convert.session_model_from_arrays(
        jax.tree_util.tree_map(np.asarray, ref_model.params),
        ref_model.item_ids.to_dict(), ref_model.user_windows,
        ref_model.max_seq_len, ref_model.n_heads)
    model.device = "cpu"
    for u, vec in ref_model.session_vecs.items():
        np.testing.assert_array_equal(model.session_vecs[u], vec)
    (port, port_ep), _ = _engines(max_seq_len=32, embed_dim=16)
    queries = ([{"user": f"u{u}", "num": 11} for u in range(24)]
               + [{"items": [f"i{(3 * j) % 30}" for j in range(n)],
                   "num": 11} for n in (1, 2, 7, 13, 30)])
    checked = 0
    for got, want in zip(port.predict_batch(port_ep, [model], queries),
                         ref.predict_batch(ref_ep, [ref_model], queries)):
        np.testing.assert_allclose([s["score"] for s in got["itemScores"]],
                                   [s["score"] for s in want["itemScores"]],
                                   rtol=1e-5, atol=1e-6)
        checked += _untied_ids_equal(got, want)
    assert checked > 100


def test_through_the_console(tmp_path, monkeypatch):
    """`template get` → `build` → `train` → `deploy`, the CPU asked for:
    answers over HTTP to both query forms equal the stored instance's in
    process; then `eval` of SessionRecEvaluation over the grid."""
    base = tmp_path / "pio_base"
    monkeypatch.setenv("PIO_FS_BASEDIR", str(base))
    monkeypatch.setenv("PIO_NATIVE", "0")
    Storage.reset(None)
    try:
        assert console.main(["app", "new", "SessApp"]) == 0
        rng = np.random.default_rng(4)
        events = tmp_path / "views.jsonl"
        with open(events, "w") as f:
            for u in range(40):
                for k in range(int(rng.integers(2, 12))):
                    f.write(json.dumps({
                        "event": "view", "entityType": "user",
                        "entityId": f"u{u}", "targetEntityType": "item",
                        "targetEntityId": f"i{int(rng.integers(0, 25))}",
                        "eventTime": (T0 + timedelta(minutes=60 * u + k))
                        .isoformat()}) + "\n")
        assert console.main(["import", "--appname", "SessApp", "--input",
                             str(events)]) == 0
        sess_dir = tmp_path / "Sess"
        assert console.main(["template", "get", "sessionrec", str(sess_dir),
                             "--app-name", "SessApp"]) == 0
        engine_json = str(sess_dir / "engine.json")
        with open(engine_json) as f:
            body = json.load(f)
        body["algorithms"][0]["params"]["epochs"] = 5
        with open(engine_json, "w") as f:
            json.dump(body, f)
        assert console.main(["build", "--engine-json", engine_json]) == 0
        assert console.main(["train", "--engine-json", engine_json,
                             "--device", "cpu"]) == 0
        predict = _in_process(engine_json)
        queries = ([{"user": f"u{u}", "num": 4} for u in range(0, 40, 4)]
                   + [{"items": ["i1", "i7", "i3"][:n], "num": 5}
                      for n in (1, 2, 3)] + [{"user": "nobody"}])
        with _deployed(sess_dir, base) as url:
            answers = [(_post(url, q), predict(q)) for q in queries]
        assert all(got == want for got, want in answers), answers
        assert sum(bool(got["itemScores"]) for got, _ in answers) >= 12
        monkeypatch.setenv("PIO_EVAL_APP_NAME", "SessApp")
        monkeypatch.setenv("PIO_EVAL_K", "2")
        out = tmp_path / "eval.json"
        assert console.main([
            "eval", "predictionio_torch.templates.sessionrec.evaluation."
            "SessionRecEvaluation", "--device", "cpu", "--out",
            str(out)]) == 0
        assert out.exists()
    finally:
        if Storage._instance is not None:
            Storage._instance.close()
        Storage.reset(None)
