"""The port's Similar Product template on the CPU, held against the
reference template: the same seeded events in a memory store of each
package give equal DataSource / Preparator arrays and equal `read_eval`
folds; the port's train fed the reference's initial factors agrees with
the reference's train (rtol 2e-3 / atol 2e-4, tests/test_torch_als.py's
bar); the reference's model carried across with `convert` answers byte
for byte as the reference does. Then the reference's own cases
(tests/test_similarproduct_template.py) and its batched ≡ sequential case
(tests/test_serving_batcher.py) run against the port.

The helpers here (a port memory store, events written to both stores,
the reference's initial factors) serve the other template tests too."""

import json
import os
from datetime import datetime, timedelta, timezone

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.controller import WorkflowContext as RefContext
from predictionio_tpu.data.datamap import DataMap as RefDataMap
from predictionio_tpu.data.events import Event as RefEvent
from predictionio_tpu.storage.base import App as RefApp
from predictionio_tpu.templates.similarproduct import engine as ref_engine
from predictionio_torch import convert
from predictionio_torch.controller import WorkflowContext
from predictionio_torch.controller.evaluation import MetricEvaluator
from predictionio_torch.data.bimap import BiMap
from predictionio_torch.data.datamap import DataMap
from predictionio_torch.data.events import Event
from predictionio_torch.ops import spd_solve
from predictionio_torch.storage.base import App
from predictionio_torch.storage.registry import (
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_torch.templates.similarproduct import engine as port_engine
from predictionio_torch.templates.similarproduct.evaluation import (
    SimilarProductEvaluation,
)
from predictionio_torch.workflow.core_workflow import CoreWorkflow
from predictionio_torch.workflow.workflow_utils import (
    EngineVariant,
    extract_engine_params,
    get_engine,
    read_engine_json,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACTORY = "predictionio_torch.templates.similarproduct.SimilarProductEngine"
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
# the train bar of tests/test_torch_als.py
RTOL, ATOL = 2e-3, 2e-4

# one intra-op thread: these tests use small tensors, and the suite's
# parallel workers share the machine's cores with timing-sensitive tests
torch.set_num_threads(1)


# -- helpers shared with the other template tests ---------------------------

@pytest.fixture()
def port_storage():
    """A fresh in-memory port Storage wired as the port's singleton."""
    src = SourceConfig(name="TEST", type="memory")
    s = Storage(StorageConfig(metadata=src, modeldata=src, eventdata=src))
    Storage.reset(s)
    yield s
    s.close()
    Storage.reset(None)


def ev(event, entity_type, entity_id, target=None, props=None):
    """One event row: (event, entity type, entity id, target item id or
    None, properties or None)."""
    return (event, entity_type, entity_id, target, props)


def insert(storage, app_name, rows, port=True, t0=T0, app_id=None):
    """Write `rows` (`ev` tuples) into `storage`, one second apart from
    `t0`, as the port's events (or the reference's: port=False), into the
    app `app_name` (created unless `app_id` is given). Returns the app
    id."""
    event_cls, datamap_cls, app_cls = ((Event, DataMap, App) if port
                                       else (RefEvent, RefDataMap, RefApp))
    if app_id is None:
        app_id = storage.meta_apps().insert(app_cls(id=0, name=app_name))
    le = storage.l_events()
    for n, (name, etype, eid, target, props) in enumerate(rows):
        le.insert(event_cls(
            event=name, entity_type=etype, entity_id=eid,
            target_entity_type="item" if target is not None else None,
            target_entity_id=target,
            properties=datamap_cls(props or {}),
            event_time=t0 + timedelta(seconds=n)), app_id)
    return app_id


def insert_both(ref_storage, port_storage, app_name, rows, t0=T0):
    """The same events into the reference's store and the port's; returns
    (reference app id, port app id)."""
    return (insert(ref_storage, app_name, rows, port=False, t0=t0),
            insert(port_storage, app_name, rows, port=True, t0=t0))


def ref_init(n_items, rank, seed):
    """The reference's initial item factors (ops/als.py::als_train)."""
    key = jax.random.key(seed)
    return np.asarray(jax.random.normal(key, (n_items, rank),
                                        dtype=jnp.float32) / np.sqrt(rank))


def with_ref_init(monkeypatch, module):
    """Make `module.als_train` start from the reference's initial item
    factors of its config's seed (the port's own draws differ)."""
    real = module.als_train

    def als_train(user_idx, item_idx, values, n_users, n_items, cfg, **kw):
        kw["init_item_factors"] = ref_init(n_items, cfg.rank, cfg.seed)
        return real(user_idx, item_idx, values, n_users, n_items, cfg, **kw)

    monkeypatch.setattr(module, "als_train", als_train)


def ref_ctx(storage, seed=1):
    return RefContext(mesh_shape={"data": 1, "model": 1}, seed=seed,
                      storage=storage)


def port_ctx(storage, seed=1):
    return WorkflowContext(device="cpu", seed=seed, storage=storage)


def as_json(obj) -> str:
    return json.dumps(obj)


@pytest.fixture(autouse=True)
def _cpu_never_launches():
    spd_solve.reset_launches()
    yield
    assert not any(spd_solve.launches.values()), spd_solve.launches


# -- seeded data -------------------------------------------------------------

def shop_rows(seed=0, n_users=30, n_items=24, n_views=260):
    """Repeat views drawn with a planted group structure, items `$set`
    with 0-2 of four categories (some re-set later, one `$unset`), two
    items that only carry properties, and a `buy` the similar-events
    filter drops."""
    rng = np.random.default_rng(seed)
    cats = ["c0", "c1", "c2", "c3"]
    rows = []
    for i in range(n_items + 2):
        k = int(rng.integers(0, 3))
        rows.append(ev("$set", "item", f"i{i}", props={
            "categories": [str(c) for c in rng.choice(cats, k,
                                                      replace=False)]}))
    rows.append(ev("$set", "item", "i3", props={"categories": ["c1"]}))
    rows.append(ev("$unset", "item", "i4", props={"categories": None}))
    for _ in range(n_views):
        u = int(rng.integers(n_users))
        g = u % 3
        i = int(rng.integers(n_items // 3)) * 3 + g if rng.random() < 0.8 \
            else int(rng.integers(n_items))
        rows.append(ev("view", "user", f"u{u}", f"i{i}"))
    rows.append(ev("buy", "user", "u0", "i1"))
    return rows


def _assert_prepared_equal(port_pd, ref_pd, names):
    for name in names:
        np.testing.assert_array_equal(getattr(port_pd, name),
                                      getattr(ref_pd, name), err_msg=name)
    assert port_pd.user_ids.to_dict() == ref_pd.user_ids.to_dict()
    assert port_pd.item_ids.to_dict() == ref_pd.item_ids.to_dict()
    assert port_pd.item_categories == ref_pd.item_categories


# -- parity with the reference ----------------------------------------------

def test_datasource_preparator_and_folds_match_reference(memory_storage,
                                                        port_storage):
    """Exact: the training arrays, the BiMaps, the categories, the
    per-pair counts, and every `read_eval` fold (training arrays and
    (query, actual) pairs)."""
    insert_both(memory_storage, port_storage, "SimApp", shop_rows())
    ref_ds = ref_engine.DataSource(ref_engine.DataSourceParams(
        appName="SimApp", evalK=3))
    port_ds = port_engine.DataSource(port_engine.DataSourceParams(
        appName="SimApp", evalK=3))
    ref_td = ref_ds.read_training(ref_ctx(memory_storage))
    port_td = port_ds.read_training(port_ctx(port_storage))
    _assert_prepared_equal(port_td, ref_td, ("user_idx", "item_idx"))
    assert port_td.item_categories["i3"] == ["c1"]
    assert "i4" in port_td.item_categories
    ref_pd = ref_engine.Preparator().prepare(None, ref_td)
    port_pd = port_engine.Preparator().prepare(None, port_td)
    _assert_prepared_equal(port_pd, ref_pd,
                           ("user_idx", "item_idx", "counts"))
    assert port_pd.counts.max() > 1  # repeat views became counts

    ref_folds = ref_ds.read_eval(ref_ctx(memory_storage))
    port_folds = port_ds.read_eval(port_ctx(port_storage))
    assert len(port_folds) == len(ref_folds) == 3
    for (p_td, p_qa), (r_td, r_qa) in zip(port_folds, ref_folds):
        _assert_prepared_equal(p_td, r_td, ("user_idx", "item_idx"))
        assert p_qa == r_qa and len(p_qa) > 0


def test_train_matches_reference(memory_storage, port_storage, monkeypatch):
    """The port's train from the reference's initial factors against the
    reference's train on the same PreparedData: the unit item factors
    within rtol 2e-3 / atol 2e-4."""
    insert_both(memory_storage, port_storage, "SimApp", shop_rows(seed=1))
    params = dict(rank=6, numIterations=5, lambda_=0.05, alpha=2.0, seed=4)
    ref_td = ref_engine.DataSource(ref_engine.DataSourceParams(
        appName="SimApp")).read_training(ref_ctx(memory_storage))
    ref_pd = ref_engine.Preparator().prepare(None, ref_td)
    ref_model = ref_engine.ALSAlgorithm(ref_engine.ALSAlgorithmParams(
        **params)).train(ref_ctx(memory_storage), ref_pd)

    with_ref_init(monkeypatch, port_engine)
    port_td = port_engine.DataSource(port_engine.DataSourceParams(
        appName="SimApp")).read_training(port_ctx(port_storage))
    port_pd = port_engine.Preparator().prepare(None, port_td)
    port_model = port_engine.ALSAlgorithm(port_engine.ALSAlgorithmParams(
        **params)).train(port_ctx(port_storage), port_pd)
    assert isinstance(port_model.item_factors_unit, np.ndarray)
    assert port_model.item_factors_unit.dtype == np.float32
    np.testing.assert_allclose(port_model.item_factors_unit,
                               ref_model.item_factors_unit,
                               rtol=RTOL, atol=ATOL)
    assert port_model.item_ids.to_dict() == ref_model.item_ids.to_dict()


def _carried(ref_model):
    return convert.similar_product_model_from_arrays(
        ref_model.item_factors_unit, ref_model.item_ids.to_dict(),
        ref_model.item_categories)


SERVE_QUERIES = (
    [{"items": [f"i{i}"], "num": 5} for i in range(0, 24, 2)]
    + [{"items": ["i1", "i5", "i9"], "num": 4},
       {"items": ["i2"], "num": 100},  # beyond the catalogue
       {"items": ["i2"], "num": 0},
       {"items": ["nope"], "num": 3},
       {"items": ["i7", "nope"], "num": 3},
       {"items": [], "num": 3},
       {"items": ["i0"], "num": 6, "categories": ["c1"]},
       {"items": ["i0"], "num": 6, "categories": ["c2", "c3"]},
       {"items": ["i0"], "num": 6, "categories": ["none"]},
       {"items": ["i3"], "num": 6, "whiteList": ["i1", "i2", "nope"]},
       {"items": ["i3"], "num": 6, "whiteList": ["nope"]},
       {"items": ["i3"], "num": 6, "blackList": ["i1", "i2", "nope"]},
       {"items": ["i3"], "num": 6, "whiteList": ["i1", "i2", "i4"],
        "blackList": ["i2"], "categories": ["c0", "c1"]}])


def test_carried_model_answers_byte_identical(memory_storage):
    """The reference's trained model, carried across with `convert`,
    answers every query (filters, unknown items, `num` past the
    catalogue) byte for byte as the reference, one by one and batched."""
    insert(memory_storage, "SimApp", shop_rows(seed=2), port=False)
    ctx = ref_ctx(memory_storage)
    ref_td = ref_engine.DataSource(ref_engine.DataSourceParams(
        appName="SimApp")).read_training(ctx)
    ref_pd = ref_engine.Preparator().prepare(ctx, ref_td)
    ref_algo = ref_engine.ALSAlgorithm(ref_engine.ALSAlgorithmParams(
        rank=6, numIterations=4, lambda_=0.05, seed=2))
    ref_model = ref_algo.train(ctx, ref_pd)
    model = _carried(ref_model)
    algo = port_engine.ALSAlgorithm(port_engine.ALSAlgorithmParams())
    for q in SERVE_QUERIES:
        assert as_json(algo.predict(model, q)) == \
            as_json(ref_algo.predict(ref_model, q)), q
    assert as_json(algo.batch_predict(model, list(SERVE_QUERIES))) == \
        as_json(ref_algo.batch_predict(ref_model, list(SERVE_QUERIES)))
    with pytest.raises(ValueError, match="do not match"):
        convert.similar_product_model_from_arrays(
            ref_model.item_factors_unit[:-1], ref_model.item_ids.to_dict(),
            {})


# -- the reference's own cases, on the port ----------------------------------
# tests/test_similarproduct_template.py, with its fixture's events

def ingest_views(storage, app_name="SimApp", n_users=16, n_groups=2,
                 items_per_group=4):
    """Users in group g view group-g items (all but one, rotating): items
    co-viewed within a group come out more similar than across groups."""
    rows = [ev("$set", "item", f"g{g}i{j}", props={"categories": [f"cat{g}"]})
            for g in range(n_groups) for j in range(items_per_group)]
    for u in range(n_users):
        g = u % n_groups
        rows += [ev("view", "user", f"u{u}", f"g{g}i{j}")
                 for j in range(items_per_group) if j != u % items_per_group]
    return insert(storage, app_name, rows)


def variant_dict(app_name="SimApp", rank=4, iters=15):
    return {
        "id": "sim-test",
        "engineFactory": FACTORY,
        "datasource": {"params": {"appName": app_name}},
        "algorithms": [{"name": "als", "params": {
            "rank": rank, "numIterations": iters, "lambda": 0.05,
            "alpha": 2.0, "seed": 1}}],
    }


def _engine(d=None):
    variant = EngineVariant.from_dict(d or variant_dict())
    engine = get_engine(variant.engine_factory)
    return variant, engine, extract_engine_params(engine, variant)


def test_train_and_similar(port_storage):
    ingest_views(port_storage)
    variant, engine, ep = _engine()
    instance = CoreWorkflow.run_train(engine, ep, variant,
                                      port_ctx(port_storage))
    assert instance.status == "COMPLETED"
    blob = port_storage.model_data_models().get(instance.id).models
    models = engine.deserialize_models(blob)
    r = engine.predict(ep, models, {"items": ["g0i0"], "num": 3})
    items = [s["item"] for s in r["itemScores"]]
    assert len(items) == 3
    assert "g0i0" not in items  # the basket is excluded
    # co-viewed group-0 items outrank group-1 items
    assert set(items[:2]) <= {f"g0i{j}" for j in range(4)}
    scores = [s["score"] for s in r["itemScores"]]
    assert scores == sorted(scores, reverse=True)


def test_filters(port_storage):
    ingest_views(port_storage)
    _, engine, ep = _engine()
    models = engine.train(port_ctx(port_storage), ep)
    r = engine.predict(ep, models, {
        "items": ["g0i0"], "num": 10, "whiteList": ["g1i0", "g1i1"]})
    assert {s["item"] for s in r["itemScores"]} <= {"g1i0", "g1i1"}
    r = engine.predict(ep, models, {
        "items": ["g0i0"], "num": 10, "blackList": ["g0i1"]})
    assert "g0i1" not in {s["item"] for s in r["itemScores"]}
    r = engine.predict(ep, models, {
        "items": ["g0i0"], "num": 10, "categories": ["cat1"]})
    got = {s["item"] for s in r["itemScores"]}
    assert got and got <= {f"g1i{j}" for j in range(4)}


def test_unknown_items_empty(port_storage):
    ingest_views(port_storage)
    _, engine, ep = _engine()
    models = engine.train(port_ctx(port_storage, seed=0), ep)
    r = engine.predict(ep, models, {"items": ["nope"], "num": 3})
    assert r == {"itemScores": []}


def test_empty_app_fails_sanity_check(port_storage):
    port_storage.meta_apps().insert(App(id=0, name="EmptySim"))
    variant, engine, ep = _engine(variant_dict("EmptySim"))
    with pytest.raises(ValueError, match="no view events"):
        CoreWorkflow.run_train(engine, ep, variant, port_ctx(port_storage))


def test_events_file_is_refused(tmp_path):
    """The template reads item properties from the event store: a
    context with an events file is refused, not silently ignored."""
    ds = port_engine.DataSource(port_engine.DataSourceParams(appName="A"))
    with pytest.raises(ValueError, match="events file"):
        ds.read_training(WorkflowContext(device="cpu", events_path=str(
            tmp_path / "events.jsonl")))


def test_template_engine_json_parses():
    path = os.path.join(REPO, "predictionio_torch", "templates",
                        "similarproduct", "engine.json")
    variant = read_engine_json(path)
    assert variant.engine_factory == FACTORY
    engine = get_engine(variant.engine_factory)
    ep = extract_engine_params(engine, variant)
    name, params = ep.algorithm_params_list[0]
    assert name == "als"
    assert (params.rank, params.numIterations, params.lambda_,
            params.seed) == (10, 20, 0.01, 3)


def test_train_grid_matches_sequential_per_cell(port_storage):
    """Cells over (λ, iterations) train as one batched grid, and each
    equals its own sequential train (the reference's rtol 2e-4 /
    atol 2e-5); the factors come back as host numpy."""
    ingest_views(port_storage)
    _, engine, ep = _engine()
    ctx = port_ctx(port_storage)
    ds, prep, _, _ = engine.components(ep)
    pd = prep.prepare(ctx, ds.read_training(ctx))
    algos = [port_engine.ALSAlgorithm(port_engine.ALSAlgorithmParams(
                 rank=4, numIterations=n, lambda_=lam, seed=2))
             for n, lam in ((3, 0.05), (5, 0.05), (4, 0.2))]
    grid = port_engine.ALSAlgorithm.train_grid(ctx, pd, algos)
    assert grid is not None and len(grid) == 3
    for algo, gm in zip(algos, grid):
        assert isinstance(gm.item_factors_unit, np.ndarray)
        sm = algo.train(ctx, pd)
        np.testing.assert_allclose(gm.item_factors_unit,
                                   sm.item_factors_unit,
                                   rtol=2e-4, atol=2e-5)
    assert np.abs(grid[0].item_factors_unit
                  - grid[2].item_factors_unit).max() > 1e-4


def test_read_eval_folds_and_grid_eval(port_storage, monkeypatch):
    """The leave-views-out folds, and the evaluation grid through
    `Engine.eval_grid` (one batched train per fold, mixed horizons)."""
    ingest_views(port_storage)
    monkeypatch.setenv("PIO_EVAL_APP_NAME", "SimApp")
    monkeypatch.setenv("PIO_EVAL_K", "2")
    evaluation = SimilarProductEvaluation()
    ctx = port_ctx(port_storage)
    ds = evaluation.engine.components(evaluation.engine_params_list[0])[0]
    folds = ds.read_eval(ctx)
    assert len(folds) == 2
    for fold_td, qa in folds:
        assert len(fold_td.user_idx) > 0 and len(qa) > 0
        for q, a in qa:
            assert q["items"] and a["items"]
            assert q["items"][0] != a["items"][0]
    result = MetricEvaluator.evaluate(ctx, evaluation,
                                      evaluation.engine_params_list)
    assert len(result.all_results) == 4
    scores = [r.scores[result.metric_name] for r in result.all_results]
    assert all(np.isfinite(s) for s in scores)
    assert result.best.scores[result.metric_name] == max(scores)


def test_evaluation_grid_is_the_references():
    """λ {0.01, 0.1} × iterations {10, 20} at rank 8, in the reference's
    order."""
    from predictionio_tpu.templates.similarproduct.evaluation import (
        SimilarProductEvaluation as RefEvaluation,
    )

    def cells(e):
        return [(p.rank, p.numIterations, p.lambda_)
                for ep in e.engine_params_list
                for _, p in ep.algorithm_params_list]

    assert cells(SimilarProductEvaluation()) == cells(RefEvaluation())
    assert len(cells(SimilarProductEvaluation())) == 4


# -- tests/test_serving_batcher.py:108, on the port --------------------------

def test_similarproduct_batch_matches_sequential():
    rng = np.random.default_rng(7)
    n = 40
    f = rng.normal(size=(n, 6)).astype(np.float32)
    unit = (f / np.linalg.norm(f, axis=1, keepdims=True)).astype(np.float32)
    ids = BiMap.string_int(f"i{j}" for j in range(n))
    model = port_engine.SimilarProductModel(
        item_factors_unit=unit, item_ids=ids,
        item_categories={"i0": ["a"], "i1": ["b"]})
    algo = port_engine.ALSAlgorithm(port_engine.ALSAlgorithmParams())
    queries = (
        [{"items": [f"i{j}"], "num": 5} for j in range(10)]
        + [{"items": ["i1", "i3", "i5"], "num": 4}]
        + [{"items": ["i0"], "num": 5, "categories": ["b"]},
           {"items": ["i2"], "num": 5, "blackList": ["i3"]},
           {"items": ["nope"], "num": 5},
           {"items": ["i4", "nope"], "num": 5},
           {"items": ["i6"], "num": 0}]
        + [{"items": [f"i{j}"], "num": 7} for j in range(20, 24)])
    sequential = [algo.predict(model, q) for q in queries]
    assert algo.batch_predict(model, queries) == sequential
    perm = rng.permutation(len(queries))
    shuffled = algo.batch_predict(model, [queries[i] for i in perm])
    assert shuffled == [sequential[i] for i in perm]
