"""The port's Classification template on the CPU, held against the
reference template: the same seeded `$set` / `$unset` / `$delete` events
in a memory store of each package give equal labeled points, prepared
arrays and `read_eval` folds; both algorithms train within the
classification ops' bars (NB rtol 1e-6 / atol 1e-7, LogReg rtol 2e-4 /
atol 1e-5) and answer every query alike; `Engine.eval_grid` scores as the
reference's does, through `train_grid` and sequentially. Then the
reference's own cases (tests/test_classification_template.py,
tests/test_classify_grid.py::TestEngineEvalGridRouting) run against the
port."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from predictionio_tpu.controller import AverageMetric as RefAverageMetric
from predictionio_tpu.controller.evaluation import (
    Evaluation as RefEvaluation,
    MetricEvaluator as RefMetricEvaluator,
)
from predictionio_tpu.templates.classification import engine as ref_engine
from predictionio_tpu.workflow.workflow_utils import (
    EngineVariant as RefEngineVariant,
    extract_engine_params as ref_extract_engine_params,
    get_engine as ref_get_engine,
)
from predictionio_torch.controller import AverageMetric, WorkflowContext
from predictionio_torch.controller.evaluation import (
    Evaluation,
    MetricEvaluator,
)
from predictionio_torch.templates.classification import engine as port_engine
from predictionio_torch.workflow.core_workflow import CoreWorkflow
from predictionio_torch.workflow.workflow_utils import (
    EngineVariant,
    extract_engine_params,
    get_engine,
    read_engine_json,
)
from tests.test_torch_similarproduct import (
    REPO,
    ev,
    insert,
    insert_both,
    port_ctx,
    port_storage,  # noqa: F401 — a fixture
    ref_ctx,
)

FACTORY = "predictionio_torch.templates.classification.ClassificationEngine"
APP = "ClsApp"
NB_TOL = dict(rtol=1e-6, atol=1e-7)
LR_TOL = dict(rtol=2e-4, atol=1e-5)
ALGOS = [("naive", {"lambda": 1.0}),
         ("logisticregression", {"iterations": 40, "stepSize": 0.3})]

torch.set_num_threads(1)


def user_rows(counts=(20, 20, 20), seed=0):
    """The reference test's three separable classes (plan c has attrs ~
    onehot(c)·4 + {0, 1}; `counts` users a class), and users whose fold
    drops them: an `$unset` attribute, a `$delete`d entity, a missing
    label; one re-`$set` after a `$delete`."""
    rng = np.random.default_rng(seed)
    rows = []
    uid = 0
    for plan, n_users in zip((0.0, 1.0, 2.0), counts):
        base = np.eye(3)[int(plan)] * 4.0
        for _ in range(n_users):
            attrs = np.maximum(0.0, base + rng.integers(0, 2, size=3))
            rows.append(ev("$set", "user", f"u{uid}", None, {
                "attr0": float(attrs[0]), "attr1": float(attrs[1]),
                "attr2": float(attrs[2]), "plan": plan}))
            uid += 1
    full = {"attr0": 1.0, "attr1": 0.0, "attr2": 5.0, "plan": 2.0}
    rows += [ev("$set", "user", "unset", None, full),
             ev("$unset", "user", "unset", None, {"attr1": None}),
             ev("$set", "user", "deleted", None, full),
             ev("$delete", "user", "deleted"),
             ev("$set", "user", "unlabeled", None,
                {"attr0": 1.0, "attr1": 1.0, "attr2": 1.0}),
             ev("$set", "user", "u3", None, {"attr1": 2.0}),
             ev("$delete", "user", "u5"),
             ev("$set", "user", "u5", None, {
                 "attr0": 4.0, "attr1": 1.0, "attr2": 0.0, "plan": 0.0})]
    return rows


def variant_dict(algo="naive", params=None, app=APP, factory=FACTORY):
    return {"id": "cls-test", "engineFactory": factory,
            "datasource": {"params": {"appName": app}},
            "algorithms": [{"name": algo, "params": params or {}}]}


def _engines(algo, params, eval_k=0):
    """((port engine, its params), (reference engine, its params)) of the
    same engine.json body."""
    out = []
    for factory, variant_cls, get, extract in (
            (FACTORY, EngineVariant, get_engine, extract_engine_params),
            (FACTORY.replace("predictionio_torch.", "predictionio_tpu."),
             RefEngineVariant, ref_get_engine, ref_extract_engine_params)):
        vd = variant_dict(algo, params, factory=factory)
        vd["datasource"]["params"]["evalK"] = eval_k
        variant = variant_cls.from_dict(vd)
        engine = get(variant.engine_factory)
        out.append((engine, extract(engine, variant)))
    return out


QUERIES = ([{"attr0": a, "attr1": b, "attr2": c}
            for a in (0.0, 1.0, 4.0, 5.0) for b in (0.0, 4.0, 5.0)
            for c in (0.0, 1.0, 4.0)]
           + [{"features": [2.0, 2.0, 2.0]}, {"attr0": 3, "attr1": "1",
                                                "attr2": 0.5}])


# -- parity with the reference ----------------------------------------------

def test_datasource_preparator_and_folds_match_reference(memory_storage,
                                                        port_storage):
    """Exact: the labeled points in entity-id order (the folded-away users
    dropped by `required=`), the dense class indices, every fold."""
    insert_both(memory_storage, port_storage, APP, user_rows())
    params = dict(appName=APP, evalK=3)
    ref_ds = ref_engine.DataSource(ref_engine.DataSourceParams(**params))
    port_ds = port_engine.DataSource(port_engine.DataSourceParams(**params))
    ref_td = ref_ds.read_training(ref_ctx(memory_storage))
    port_td = port_ds.read_training(port_ctx(port_storage))
    assert len(port_td.labels) == 60  # "unset", "deleted", "unlabeled" out
    np.testing.assert_array_equal(port_td.features, ref_td.features)
    np.testing.assert_array_equal(port_td.labels, ref_td.labels)
    assert port_td.attributes == ref_td.attributes
    ref_pd = ref_engine.Preparator().prepare(None, ref_td)
    port_pd = port_engine.Preparator().prepare(None, port_td)
    for name in ("features", "label_idx", "classes"):
        np.testing.assert_array_equal(getattr(port_pd, name),
                                      getattr(ref_pd, name), err_msg=name)
        assert getattr(port_pd, name).dtype == getattr(ref_pd, name).dtype

    ref_folds = ref_ds.read_eval(ref_ctx(memory_storage))
    port_folds = port_ds.read_eval(port_ctx(port_storage))
    assert len(port_folds) == len(ref_folds) == 3
    for (p_td, p_qa), (r_td, r_qa) in zip(port_folds, ref_folds):
        np.testing.assert_array_equal(p_td.features, r_td.features)
        np.testing.assert_array_equal(p_td.labels, r_td.labels)
        assert p_qa == r_qa and len(p_qa) == 20


def _trained_pair(memory_storage, port_storage, algo, params, rows):
    insert_both(memory_storage, port_storage, APP, rows)
    (port, port_ep), (ref, ref_ep) = _engines(algo, params)
    return ((port, port_ep, port.train(port_ctx(port_storage), port_ep)[0]),
            (ref, ref_ep, ref.train(ref_ctx(memory_storage), ref_ep)[0]))


@pytest.mark.parametrize("algo,params", ALGOS)
def test_train_and_predictions_match_reference(memory_storage, port_storage,
                                               algo, params):
    """Classes of 23, 17 and 21 users: the models within the ops' bars,
    every answer equal."""
    (port, port_ep, port_model), (ref, ref_ep, ref_model) = _trained_pair(
        memory_storage, port_storage, algo, params,
        user_rows(counts=(23, 17, 21), seed=1))
    if algo == "naive":
        np.testing.assert_allclose(port_model.nb.log_prior,
                                   ref_model.nb.log_prior, **NB_TOL)
        np.testing.assert_allclose(port_model.nb.log_theta,
                                   ref_model.nb.log_theta, **NB_TOL)
    else:
        for name in ("weights", "bias", "loss_history"):
            np.testing.assert_allclose(getattr(port_model.lr, name),
                                       getattr(ref_model.lr, name), **LR_TOL)
    np.testing.assert_array_equal(port_model.classes, ref_model.classes)
    for q in QUERIES:
        assert (port.predict(port_ep, [port_model], q)
                == ref.predict(ref_ep, [ref_model], q)), q


def test_balanced_classes_logreg_answers_match_reference(memory_storage,
                                                        port_storage):
    """Open finding (ROADMAP Queue 3): with classes of exactly N/C points
    (20, 20, 20 here, the reference test's store) the bias gradient at
    the zero start is 0 in exact arithmetic, so each package's first Adam
    step (g / (|g| + 1e-8)) scales its own f32 rounding residue of the
    sum of (softmax − onehot) up to O(lr): after one step the reference's
    bias is [0, 0.128, 0] and the port's [0.217, 0.217, 0.207]; after 40
    steps at lr 0.3 the weights differ by 5.6e-2 max-abs, the bias by
    1.49 (measured on this store). The LogReg bar (rtol 2e-4 / atol
    1e-5) does not hold here and is not asserted. Every training point
    and class prototype gets the same answer (asserted); 12 of the 38
    QUERIES, points between two classes (attr1 = attr2 = 4, all zero)
    that the bias decides, get another answer (measured, not
    asserted)."""
    rows = user_rows(seed=1)
    (port, port_ep, port_model), (ref, ref_ep, ref_model) = _trained_pair(
        memory_storage, port_storage, *ALGOS[1], rows)
    points = [{a: p[a] for a in ("attr0", "attr1", "attr2")}
              for _, _, _, _, p in rows[:60]]
    points += [dict(zip(("attr0", "attr1", "attr2"), 4.0 * np.eye(3)[c]))
               for c in range(3)]
    for q in points:
        assert (port.predict(port_ep, [port_model], q)
                == ref.predict(ref_ep, [ref_model], q)), q


class _Accuracy(AverageMetric):
    def calculate(self, q, p, a):
        return 1.0 if p["label"] == a["label"] else 0.0


class _RefAccuracy(RefAverageMetric):
    def calculate(self, q, p, a):
        return 1.0 if p["label"] == a["label"] else 0.0


@pytest.mark.parametrize("algo,params,param,values", [
    ("naive", {"lambda": 1.0}, "lambda_", [0.1, 1.0, 10.0]),
    ("logisticregression", {"iterations": 20, "stepSize": 0.3}, "stepSize",
     [0.05, 0.3, 0.8]),
])
def test_eval_grid_matches_reference_and_sequential(
        memory_storage, port_storage, monkeypatch, algo, params, param,
        values):
    """The λ / stepSize grid scores as the reference's does; the port's
    `train_grid` engages and scores as its sequential evaluator
    (tests/test_classify_grid.py's routing bar, rtol 1e-6)."""
    insert_both(memory_storage, port_storage, APP, user_rows(seed=2))
    (port, port_ep), (ref, ref_ep) = _engines(algo, params, eval_k=3)

    def grid(engine, base_ep):
        name, p = base_ep.algorithm_params_list[0]
        return [dataclasses.replace(base_ep, algorithm_params_list=[
            (name, dataclasses.replace(p, **{param: v}))]) for v in values]

    class PortEval(Evaluation):
        engine = port
        metric = _Accuracy()

    class RefEval(RefEvaluation):
        engine = ref
        metric = _RefAccuracy()

    cls = type(port.components(port_ep)[2][0][1])
    real = cls.train_grid.__func__
    grid_calls = []

    def spy(c, ctx, pd, algos):
        out = real(c, ctx, pd, algos)
        grid_calls.append(out is not None)
        return out

    monkeypatch.setattr(cls, "train_grid", classmethod(spy))
    ctx = port_ctx(port_storage)
    port_res = MetricEvaluator.evaluate(ctx, PortEval(), grid(port, port_ep))
    assert grid_calls and all(grid_calls), "train_grid never engaged"
    monkeypatch.setattr(cls, "train_grid",
                        classmethod(lambda c, ctx, pd, algos: None))
    seq_res = MetricEvaluator.evaluate(ctx, PortEval(), grid(port, port_ep))
    ref_res = RefMetricEvaluator.evaluate(ref_ctx(memory_storage), RefEval(),
                                          grid(ref, ref_ep))

    def scores(res):
        return [r.scores[res.metric_name] for r in res.all_results]

    np.testing.assert_allclose(scores(port_res), scores(seq_res),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(scores(port_res), scores(ref_res),
                               rtol=1e-6, atol=1e-9)
    assert all(0.5 < s <= 1.0 for s in scores(port_res))


# -- the reference's cases, on the port --------------------------------------

@pytest.mark.parametrize("algo,params", [
    ("naive", {"lambda": 1.0}),
    ("logisticregression", {"iterations": 300, "stepSize": 0.3}),
])
def test_train_and_classify(port_storage, algo, params):
    insert(port_storage, APP, user_rows())
    variant = EngineVariant.from_dict(variant_dict(algo, params))
    engine = get_engine(variant.engine_factory)
    ep = extract_engine_params(engine, variant)
    instance = CoreWorkflow.run_train(engine, ep, variant,
                                      port_ctx(port_storage, seed=0))
    assert instance.status == "COMPLETED"
    blob = port_storage.model_data_models().get(instance.id).models
    models = engine.deserialize_models(blob)
    # each class prototype classifies back to its own plan
    for plan in (0.0, 1.0, 2.0):
        proto = (np.eye(3)[int(plan)] * 4.0).tolist()
        q = {"attr0": proto[0], "attr1": proto[1], "attr2": proto[2]}
        assert engine.predict(ep, models, q) == {"label": plan}


def test_query_validation(port_storage):
    insert(port_storage, APP, user_rows())
    variant = EngineVariant.from_dict(variant_dict())
    engine = get_engine(variant.engine_factory)
    ep = extract_engine_params(engine, variant)
    models = engine.train(port_ctx(port_storage), ep)
    assert engine.predict(ep, models, {"features": [0.0, 4.0, 0.0]}) == {
        "label": 1.0}
    with pytest.raises(ValueError, match="missing attribute 'attr2'"):
        engine.predict(ep, models, {"attr0": 1.0, "attr1": 1.0})
    with pytest.raises(ValueError, match="model expects 3"):
        engine.predict(ep, models, {"features": [1.0, 2.0]})


def test_empty_app_fails_sanity_check(port_storage):
    insert(port_storage, "EmptyCls", [])
    variant = EngineVariant.from_dict(variant_dict(app="EmptyCls"))
    engine = get_engine(variant.engine_factory)
    ep = extract_engine_params(engine, variant)
    with pytest.raises(ValueError, match="no labeled points"):
        CoreWorkflow.run_train(engine, ep, variant, port_ctx(port_storage))


def test_events_file_is_refused(tmp_path):
    ds = port_engine.DataSource(port_engine.DataSourceParams(appName="A"))
    with pytest.raises(ValueError, match="events file"):
        ds.read_training(WorkflowContext(device="cpu", events_path=str(
            tmp_path / "events.jsonl")))


def test_template_engine_json_parses():
    path = os.path.join(REPO, "predictionio_torch", "templates",
                        "classification", "engine.json")
    variant = read_engine_json(path)
    assert variant.engine_factory == FACTORY
    engine = get_engine(variant.engine_factory)
    ep = extract_engine_params(engine, variant)
    name, params = ep.algorithm_params_list[0]
    assert (name, params.lambda_) == ("naive", 1.0)
    assert port_engine.LogisticRegressionAlgorithm.checkpoint_tags == ("lr",)
