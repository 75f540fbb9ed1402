"""The port's Product Ranking template on the CPU, held against the
reference template: the same seeded rate / buy events in a memory store
of each package give equal DataSource / Preparator arrays; the port's
train fed the reference's initial factors agrees with the reference's
(rtol 2e-3 / atol 2e-4); the reference's model carried across with
`convert.als_model_from_arrays` ranks every candidate list byte for byte
as the reference does. Then the reference's own five cases
(tests/test_productranking_template.py) and its batched ≡ sequential case
(tests/test_serving_batcher.py) run against the port."""

import os

import numpy as np
import pytest
import torch

from predictionio_tpu.templates.productranking import engine as ref_engine
from predictionio_tpu.templates.recommendation import engine as ref_rec
from predictionio_torch import convert
from predictionio_torch.models.als_model import ALSModel
from predictionio_torch.ops import spd_solve
from predictionio_torch.templates.productranking import engine as port_engine
from predictionio_torch.templates.recommendation import engine as port_rec
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

FACTORY = "predictionio_torch.templates.productranking.ProductRankingEngine"

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_never_launches():
    spd_solve.reset_launches()
    yield
    assert not any(spd_solve.launches.values()), spd_solve.launches


def rating_rows(seed=0, n_users=30, n_items=20, n=300):
    """Half-star rates, some buys (rating 4.0) and re-ratings the
    Preparator's keep-last dedup resolves."""
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(n):
        u, i = int(rng.integers(n_users)), int(rng.integers(n_items))
        if k % 9 == 0:
            rows.append(ev("buy", "user", f"u{u}", f"i{i}"))
        else:
            rows.append(ev("rate", "user", f"u{u}", f"i{i}", {
                "rating": float(rng.integers(1, 11)) / 2}))
    return rows


def _prepared(ctx):
    td = port_rec.DataSource(port_rec.DataSourceParams(
        appName="RankApp")).read_training(ctx)
    return port_rec.Preparator().prepare(None, td)


def _ref_prepared(ctx):
    td = ref_rec.DataSource(ref_rec.DataSourceParams(
        appName="RankApp")).read_training(ctx)
    return ref_rec.Preparator().prepare(None, td)


# -- parity with the reference ----------------------------------------------

def test_datasource_and_preparator_match_reference(memory_storage,
                                                   port_storage):
    insert_both(memory_storage, port_storage, "RankApp", rating_rows())
    assert port_engine.DataSource is port_rec.DataSource
    ref_pd = _ref_prepared(ref_ctx(memory_storage))
    port_pd = _prepared(port_ctx(port_storage))
    for name in ("user_idx", "item_idx", "ratings"):
        np.testing.assert_array_equal(getattr(port_pd, name),
                                      getattr(ref_pd, name), err_msg=name)
    assert port_pd.user_ids.to_dict() == ref_pd.user_ids.to_dict()
    assert port_pd.item_ids.to_dict() == ref_pd.item_ids.to_dict()


def test_train_matches_reference(memory_storage, port_storage, monkeypatch):
    """The ALS factors within rtol 2e-3 / atol 2e-4, the port starting
    from the reference's init."""
    insert_both(memory_storage, port_storage, "RankApp", rating_rows(seed=1))
    ref_model = ref_engine.RankingALSAlgorithm(ref_rec.ALSAlgorithmParams(
        rank=6, numIterations=5, lambda_=0.05, seed=4)).train(
            ref_ctx(memory_storage), _ref_prepared(ref_ctx(memory_storage)))
    with_ref_init(monkeypatch, port_rec)
    port_model = port_engine.RankingALSAlgorithm(port_rec.ALSAlgorithmParams(
        rank=6, numIterations=5, lambda_=0.05, seed=4)).train(
            port_ctx(port_storage), _prepared(port_ctx(port_storage)))
    assert isinstance(port_model, ALSModel)
    for name in ("user_factors", "item_factors"):
        np.testing.assert_allclose(getattr(port_model, name),
                                   getattr(ref_model, name),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


QUERIES = (
    [{"user": f"u{u}", "items": [f"i{i}" for i in range(u % 7, 20, 3)]}
     for u in range(0, 30, 3)]
    + [{"user": "u1", "items": ["new2", "i1", "new1", "i2"]},
       {"user": "u2", "items": ["i5"]},
       {"user": "u4", "items": ["i3", "i3", "i9"]},
       {"user": "u5", "items": []},
       {"user": "stranger", "items": ["i3", "i1", "i2"]},
       {"items": ["i1"]},
       {"user": "u6"}])


def test_carried_model_answers_byte_identical(memory_storage):
    insert(memory_storage, "RankApp", rating_rows(seed=2), port=False)
    ctx = ref_ctx(memory_storage)
    pd = _ref_prepared(ctx)
    ref_algo = ref_engine.RankingALSAlgorithm(ref_rec.ALSAlgorithmParams(
        rank=6, numIterations=4, lambda_=0.05, seed=2))
    ref_model = ref_algo.train(ctx, pd)
    model = convert.als_model_from_arrays(
        ref_model.user_factors, ref_model.item_factors,
        ref_model.user_ids.to_dict(), ref_model.item_ids.to_dict(),
        pd.user_idx, pd.item_idx)
    algo = port_engine.RankingALSAlgorithm(port_rec.ALSAlgorithmParams())
    for q in QUERIES:
        assert as_json(algo.predict(model, q)) == \
            as_json(ref_algo.predict(ref_model, q)), q
    assert as_json(algo.batch_predict(model, list(QUERIES))) == \
        as_json(ref_algo.batch_predict(ref_model, list(QUERIES)))


# -- the reference's own cases, on the port ----------------------------------
# tests/test_productranking_template.py, with its fixture's events

def ingest_ratings(storage, app_name="RankApp"):
    """Even users love even items (5) and hate odd ones (1); odd users the
    reverse."""
    rows = [ev("rate", "user", f"u{u}", f"i{i}", {
                "rating": 5.0 if (i % 2 == 0) == (u % 2 == 0) else 1.0})
            for u in range(24) for i in range(8)]
    return insert(storage, app_name, rows)


def variant_dict(app_name="RankApp"):
    return {
        "id": "rank-test",
        "engineFactory": FACTORY,
        "datasource": {"params": {"appName": app_name}},
        "algorithms": [{"name": "als", "params": {
            "rank": 4, "numIterations": 15, "lambda": 0.05, "seed": 1}}],
    }


def _engine():
    variant = EngineVariant.from_dict(variant_dict())
    engine = get_engine(variant.engine_factory)
    return variant, engine, extract_engine_params(engine, variant)


def _trained(storage):
    _, engine, ep = _engine()
    return engine, ep, engine.train(port_ctx(storage), ep)


def test_ranks_candidates_by_preference(port_storage):
    ingest_ratings(port_storage)
    engine, ep, models = _trained(port_storage)
    r = engine.predict(ep, models, {
        "user": "u0", "items": ["i1", "i2", "i3", "i4"]})
    assert r["isOriginal"] is False
    got = [s["item"] for s in r["itemScores"]]
    assert set(got) == {"i1", "i2", "i3", "i4"}
    assert set(got[:2]) == {"i2", "i4"}  # u0 loves even items
    scores = [s["score"] for s in r["itemScores"]]
    assert scores == sorted(scores, reverse=True)


def test_unknown_user_returns_original_order(port_storage):
    ingest_ratings(port_storage)
    engine, ep, models = _trained(port_storage)
    r = engine.predict(ep, models, {
        "user": "stranger", "items": ["i3", "i1", "i2"]})
    assert r["isOriginal"] is True
    assert [s["item"] for s in r["itemScores"]] == ["i3", "i1", "i2"]


def test_unknown_items_keep_relative_order_at_end(port_storage):
    ingest_ratings(port_storage)
    engine, ep, models = _trained(port_storage)
    r = engine.predict(ep, models, {
        "user": "u1", "items": ["new2", "i1", "new1", "i2"]})
    assert r["isOriginal"] is False
    got = [s["item"] for s in r["itemScores"]]
    assert got[:2] == ["i1", "i2"]  # u1 loves odd items
    assert got[2:] == ["new2", "new1"]
    assert all(s["score"] == 0.0 for s in r["itemScores"][2:])


def test_full_workflow_and_persistence(port_storage):
    ingest_ratings(port_storage)
    variant, engine, ep = _engine()
    instance = CoreWorkflow.run_train(engine, ep, variant,
                                      port_ctx(port_storage))
    assert instance.status == "COMPLETED"
    blob = port_storage.model_data_models().get(instance.id).models
    models = engine.deserialize_models(blob)
    r = engine.predict(ep, models, {"user": "u2", "items": ["i0", "i1"]})
    assert [s["item"] for s in r["itemScores"]] == ["i0", "i1"]


def test_empty_items(port_storage):
    ingest_ratings(port_storage)
    engine, ep, models = _trained(port_storage)
    r = engine.predict(ep, models, {"user": "u0", "items": []})
    assert r == {"itemScores": [], "isOriginal": True}


def test_template_engine_json_parses():
    path = os.path.join(REPO, "predictionio_torch", "templates",
                        "productranking", "engine.json")
    variant = read_engine_json(path)
    assert variant.engine_factory == FACTORY
    engine = get_engine(variant.engine_factory)
    ep = extract_engine_params(engine, variant)
    name, params = ep.algorithm_params_list[0]
    assert name == "als" and (params.rank, params.numIterations) == (10, 20)


# -- tests/test_serving_batcher.py:146, on the port --------------------------

def test_productranking_batch_matches_sequential(port_storage):
    ingest_ratings(port_storage)
    variant, engine, ep = _engine()
    instance = CoreWorkflow.run_train(engine, ep, variant,
                                      port_ctx(port_storage))
    blob = port_storage.model_data_models().get(instance.id).models
    model = engine.deserialize_models(blob)[0]
    algo = port_engine.RankingALSAlgorithm(port_rec.ALSAlgorithmParams())
    queries = [
        {"user": "u0", "items": ["i1", "i3", "i5"]},
        {"user": "u1", "items": ["i0", "i2"]},
        {"user": "u0", "items": ["i7", "nope", "i2"]},  # a repeat user
        {"user": "stranger", "items": ["i1"]},  # isOriginal
        {"user": "u2", "items": []},
    ]
    sequential = [algo.predict(model, q) for q in queries]
    assert algo.batch_predict(model, queries) == sequential
