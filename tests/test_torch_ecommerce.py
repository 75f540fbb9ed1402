"""The port's E-Commerce template on the CPU, held against the reference
template: the same seeded view / buy / `$set` events in a memory store of
each package give equal DataSource / Preparator arrays; the port's train
fed the reference's initial factors agrees with the reference's (rtol
2e-3 / atol 2e-4); the reference's model carried across with `convert`,
with both packages' stores holding the same seen, recent and
`unavailableItems` events, answers byte for byte as the reference does.
Then the reference's own cases (tests/test_ecommerce_template.py) run
against the port."""

import os
from datetime import datetime, timezone

import numpy as np
import pytest
import torch

from predictionio_tpu.templates.ecommerce import engine as ref_engine
from predictionio_torch import convert
from predictionio_torch.ops import spd_solve
from predictionio_torch.templates.ecommerce import engine as port_engine
from predictionio_torch.workflow.core_workflow import CoreWorkflow
from predictionio_torch.workflow.workflow_utils import (
    EngineVariant,
    extract_engine_params,
    get_engine,
    read_engine_json,
)
from tests.test_torch_similarproduct import (
    ATOL,
    REPO,
    RTOL,
    as_json,
    ev,
    insert,
    insert_both,
    port_ctx,
    port_storage,  # noqa: F401 — a fixture
    ref_ctx,
    with_ref_init,
)

FACTORY = "predictionio_torch.templates.ecommerce.ECommerceEngine"
APP = "EcomApp"

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_never_launches():
    spd_solve.reset_launches()
    yield
    assert not any(spd_solve.launches.values()), spd_solve.launches


def shop_rows(seed=0, n_users=30, n_items=24, n_events=300):
    """Views and buys with a planted group structure (a buy weighs 4, a
    view 1, repeats sum), items `$set` with 0-2 of four categories, and a
    `rate` event the DataSource ignores."""
    rng = np.random.default_rng(seed)
    cats = ["c0", "c1", "c2", "c3"]
    rows = [ev("$set", "item", f"i{i}", props={
        "categories": [str(c) for c in rng.choice(
            cats, int(rng.integers(0, 3)), replace=False)]})
        for i in range(n_items)]
    for _ in range(n_events):
        u = int(rng.integers(n_users))
        i = int(rng.integers(n_items // 3)) * 3 + u % 3 \
            if rng.random() < 0.8 else int(rng.integers(n_items))
        name = "buy" if rng.random() < 0.15 else "view"
        rows.append(ev(name, "user", f"u{u}", f"i{i}"))
    rows.append(ev("rate", "user", "u1", "i2", {"rating": 5}))
    return rows


def _prepared(ds_engine, ctx):
    td = ds_engine.DataSource(ds_engine.DataSourceParams(
        appName=APP)).read_training(ctx)
    return td, ds_engine.Preparator().prepare(None, td)


# -- parity with the reference ----------------------------------------------

def test_datasource_and_preparator_match_reference(memory_storage,
                                                   port_storage):
    insert_both(memory_storage, port_storage, APP, shop_rows())
    ref_td, ref_pd = _prepared(ref_engine, ref_ctx(memory_storage))
    port_td, port_pd = _prepared(port_engine, port_ctx(port_storage))
    for name in ("user_idx", "item_idx", "weights"):
        np.testing.assert_array_equal(getattr(port_td, name),
                                      getattr(ref_td, name), err_msg=name)
    assert set(np.unique(port_td.weights)) == {1.0, 4.0}
    for name in ("user_idx", "item_idx", "confidence"):
        np.testing.assert_array_equal(getattr(port_pd, name),
                                      getattr(ref_pd, name), err_msg=name)
    for a, b in ((port_td, ref_td), (port_pd, ref_pd)):
        assert a.user_ids.to_dict() == b.user_ids.to_dict()
        assert a.item_ids.to_dict() == b.item_ids.to_dict()
        assert a.item_categories == b.item_categories


def test_train_matches_reference(memory_storage, port_storage, monkeypatch):
    """User, item and unit item factors within rtol 2e-3 / atol 2e-4 of
    the reference's, the port starting from the reference's init."""
    insert_both(memory_storage, port_storage, APP, shop_rows(seed=1))
    params = dict(appName=APP, rank=6, numIterations=5, lambda_=0.05,
                  alpha=2.0, seed=4)
    _, ref_pd = _prepared(ref_engine, ref_ctx(memory_storage))
    ref_model = ref_engine.ECommAlgorithm(ref_engine.ECommAlgorithmParams(
        **params)).train(ref_ctx(memory_storage), ref_pd)
    with_ref_init(monkeypatch, port_engine)
    _, port_pd = _prepared(port_engine, port_ctx(port_storage))
    port_model = port_engine.ECommAlgorithm(
        port_engine.ECommAlgorithmParams(**params)).train(
            port_ctx(port_storage), port_pd)
    for name in ("user_factors", "item_factors", "item_factors_unit"):
        got = getattr(port_model, name)
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        np.testing.assert_allclose(got, getattr(ref_model, name),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert port_model.app_name == ref_model.app_name == APP


def _carried(ref_model):
    return convert.ecomm_model_from_arrays(
        ref_model.user_factors, ref_model.item_factors,
        ref_model.item_factors_unit, ref_model.user_ids.to_dict(),
        ref_model.item_ids.to_dict(), ref_model.item_categories,
        ref_model.app_name)


SERVE_QUERIES = (
    [{"user": f"u{u}", "num": 5} for u in range(0, 30, 2)]
    + [{"user": "u1", "num": 100},  # beyond the catalogue
       {"user": "u1", "num": 0},
       {"user": "fresh", "num": 4},  # cold start through recent views
       {"user": "fresh", "num": 4, "categories": ["c1"]},
       {"user": "ghost", "num": 4},  # no history: empty
       {"user": "u3", "num": 8, "categories": ["c0", "c2"]},
       {"user": "u3", "num": 8, "categories": ["none"]},
       {"user": "u4", "num": 8, "whiteList": ["i1", "i2", "i5", "nope"]},
       {"user": "u4", "num": 8, "whiteList": ["nope"]},
       {"user": "u5", "num": 8, "blackList": ["i0", "i3", "nope"]},
       {"user": "u6", "num": 8, "whiteList": ["i1", "i2", "i4", "i7"],
        "blackList": ["i2"], "categories": ["c0", "c1", "c3"]}])


@pytest.mark.parametrize("unseen_only", [True, False])
def test_carried_model_answers_byte_identical(memory_storage, port_storage,
                                              unseen_only):
    """Both stores hold the training events, a never-seen user's views
    written after the train and a `$set` on unavailableItems; the port's
    algorithm over the port's store answers every query byte for byte as
    the reference's over its own."""
    rows = shop_rows(seed=2)
    ref_app, port_app = insert_both(memory_storage, port_storage, APP, rows)
    _, ref_pd = _prepared(ref_engine, ref_ctx(memory_storage))
    params = dict(appName=APP, rank=6, numIterations=4, lambda_=0.05,
                  seed=2, cacheTTLSeconds=0.0, unseenOnly=unseen_only)
    ref_algo = ref_engine.ECommAlgorithm(
        ref_engine.ECommAlgorithmParams(**params))
    ref_model = ref_algo.train(ref_ctx(memory_storage), ref_pd)
    later = [ev("view", "user", "fresh", "i4"), ev("view", "user", "fresh",
                                                   "i7"),
             ev("view", "user", "fresh", "nope"),
             ev("$set", "constraint", "unavailableItems",
                props={"items": ["i0", "i6", "nope"]})]
    t1 = datetime(2026, 2, 1, tzinfo=timezone.utc)
    insert(memory_storage, APP, later, port=False, t0=t1, app_id=ref_app)
    insert(port_storage, APP, later, port=True, t0=t1, app_id=port_app)

    model = _carried(ref_model)
    algo = port_engine.ECommAlgorithm(
        port_engine.ECommAlgorithmParams(**params))
    answered = 0
    for q in SERVE_QUERIES:
        got = as_json(algo.predict(model, q))
        assert got == as_json(ref_algo.predict(ref_model, q)), q
        answered += got != '{"itemScores": []}'
        assert '"i0"' not in got and '"i6"' not in got
    assert answered >= len(SERVE_QUERIES) - 5
    with pytest.raises(ValueError, match="do not match"):
        convert.ecomm_model_from_arrays(
            ref_model.user_factors, ref_model.item_factors,
            ref_model.item_factors_unit[:-1], ref_model.user_ids.to_dict(),
            ref_model.item_ids.to_dict(), {}, APP)


# -- the reference's own cases, on the port ----------------------------------
# tests/test_ecommerce_template.py, with its fixture's events

def ts(h):
    return datetime(2026, 1, 1, h, tzinfo=timezone.utc)


def ingest(storage, n_users=12, n_groups=2, items_per_group=4):
    """Two groups of users viewing their group's items (all but one) and
    buying one; returns the app id."""
    sets = [ev("$set", "item", f"g{g}i{j}", props={"categories": [f"cat{g}"]})
            for g in range(n_groups) for j in range(items_per_group)]
    app_id = insert(storage, APP, sets, t0=ts(0))
    views, buys = [], []
    for u in range(n_users):
        g = u % n_groups
        holdout = u % items_per_group
        views += [ev("view", "user", f"u{u}", f"g{g}i{j}")
                  for j in range(items_per_group) if j != holdout]
        buys.append(ev("buy", "user", f"u{u}",
                       f"g{g}i{(holdout + 1) % items_per_group}"))
    insert(storage, APP, views, t0=ts(1), app_id=app_id)
    insert(storage, APP, buys, t0=ts(2), app_id=app_id)
    return app_id


def variant_dict(algo_overrides=None):
    params = {
        "appName": APP, "rank": 4, "numIterations": 15, "lambda": 0.05,
        "alpha": 2.0, "seed": 1, "cacheTTLSeconds": 0.0,
    }
    params.update(algo_overrides or {})
    return {
        "id": "ecom-test",
        "engineFactory": FACTORY,
        "datasource": {"params": {"appName": APP}},
        "algorithms": [{"name": "ecomm", "params": params}],
    }


def trained(storage, algo_overrides=None):
    variant = EngineVariant.from_dict(variant_dict(algo_overrides))
    engine = get_engine(variant.engine_factory)
    ep = extract_engine_params(engine, variant)
    return engine, ep, engine.train(port_ctx(storage), ep)


def constraint(storage, app_id, items, hour):
    insert(storage, APP, [ev("$set", "constraint", "unavailableItems",
                             props={"items": items})],
           t0=ts(hour), app_id=app_id)


def test_unseen_only_excludes_seen_items(port_storage):
    ingest(port_storage)
    engine, ep, models = trained(port_storage)
    r = engine.predict(ep, models, {"user": "u0", "num": 10})
    items = [s["item"] for s in r["itemScores"]]
    assert items, "expected recommendations"
    # u0 (group 0, holdout g0i0) has seen g0i1..3 and bought g0i1
    assert not (set(items) & {"g0i1", "g0i2", "g0i3"})
    assert "g0i0" in items


def test_unavailable_items_filtered_and_constraint_updates(port_storage):
    app_id = ingest(port_storage)
    engine, ep, models = trained(port_storage)
    constraint(port_storage, app_id, ["g0i0"], 3)
    r = engine.predict(ep, models, {"user": "u0", "num": 10})
    assert "g0i0" not in [s["item"] for s in r["itemScores"]]
    # a newer constraint replaces the old one (latest=True)
    constraint(port_storage, app_id, [], 4)
    r = engine.predict(ep, models, {"user": "u0", "num": 10})
    assert "g0i0" in [s["item"] for s in r["itemScores"]]


def test_cold_start_scores_via_recent_views(port_storage):
    app_id = ingest(port_storage)
    engine, ep, models = trained(port_storage)
    insert(port_storage, APP, [ev("view", "user", "fresh", "g1i0")],
           t0=ts(5), app_id=app_id)
    r = engine.predict(ep, models, {"user": "fresh", "num": 2})
    items = [s["item"] for s in r["itemScores"]]
    assert items
    assert set(items) <= {f"g1i{j}" for j in range(4)}  # the co-viewed group
    assert "g1i0" not in items  # viewed → seen


def test_unknown_user_no_history_empty(port_storage):
    ingest(port_storage)
    engine, ep, models = trained(port_storage)
    r = engine.predict(ep, models, {"user": "ghost", "num": 3})
    assert r == {"itemScores": []}


def test_category_and_whitelist_filters(port_storage):
    ingest(port_storage)
    engine, ep, models = trained(port_storage, {"unseenOnly": False})
    r = engine.predict(ep, models, {
        "user": "u0", "num": 10, "categories": ["cat1"]})
    got = {s["item"] for s in r["itemScores"]}
    assert got and got <= {f"g1i{j}" for j in range(4)}
    r = engine.predict(ep, models, {
        "user": "u0", "num": 10, "whiteList": ["g0i1"]})
    assert [s["item"] for s in r["itemScores"]] == ["g0i1"]
    r = engine.predict(ep, models, {
        "user": "u0", "num": 10, "blackList": ["g0i1"],
        "categories": ["cat0"]})
    assert "g0i1" not in {s["item"] for s in r["itemScores"]}


def test_ttl_cache_serves_stale_within_ttl(port_storage):
    """Components resolved once (as the server does) keep the algorithm
    and its TTL cache across queries: within the TTL a new constraint is
    not yet seen; a freshly resolved algorithm sees it at once."""
    app_id = ingest(port_storage)
    engine, ep, models = trained(port_storage, {"cacheTTLSeconds": 60.0})
    comps = engine.components(ep)
    r = engine.predict(ep, models, {"user": "u0", "num": 10},
                       components=comps)
    assert "g0i0" in [s["item"] for s in r["itemScores"]]
    constraint(port_storage, app_id, ["g0i0"], 3)
    r = engine.predict(ep, models, {"user": "u0", "num": 10},
                       components=comps)
    assert "g0i0" in [s["item"] for s in r["itemScores"]]
    r = engine.predict(ep, models, {"user": "u0", "num": 10})
    assert "g0i0" not in [s["item"] for s in r["itemScores"]]


def test_model_roundtrips_through_persistence(port_storage):
    ingest(port_storage)
    variant = EngineVariant.from_dict(variant_dict())
    engine = get_engine(variant.engine_factory)
    ep = extract_engine_params(engine, variant)
    instance = CoreWorkflow.run_train(engine, ep, variant,
                                      port_ctx(port_storage))
    assert instance.status == "COMPLETED"
    blob = port_storage.model_data_models().get(instance.id).models
    models = engine.deserialize_models(blob)
    assert isinstance(models[0].user_factors, np.ndarray)
    r = engine.predict(ep, models, {"user": "u0", "num": 3})
    assert r["itemScores"]


def test_template_engine_json_parses():
    path = os.path.join(REPO, "predictionio_torch", "templates",
                        "ecommerce", "engine.json")
    variant = read_engine_json(path)
    assert variant.engine_factory == FACTORY
    engine = get_engine(variant.engine_factory)
    ep = extract_engine_params(engine, variant)
    name, params = ep.algorithm_params_list[0]
    assert name == "ecomm"
    assert params.seenEvents == ["buy", "view"]
    assert params.unseenOnly is True
    assert (params.rank, params.numIterations) == (10, 20)
