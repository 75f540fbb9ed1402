"""The port's Lead Scoring template and the metric zoo's AUC on the CPU,
held against the reference's: the same seeded sessions in a memory store
of each package give equal sessions, one-hot arrays, vocabularies and
`read_eval` folds; the trained models agree within the LogReg bar (rtol
2e-4 / atol 1e-5) and score every query alike; the evaluation's AUC per
cell equals the reference's. Then the reference's own cases
(tests/test_leadscoring_template.py, its AUC cases among them) run
against the port, the interrupted train resumed bitwise."""

import json
import logging
import math
import os

import numpy as np
import pytest
import torch

from predictionio_tpu.controller import metrics as ref_metrics
from predictionio_tpu.controller.evaluation import (
    MetricEvaluator as RefMetricEvaluator,
)
from predictionio_tpu.templates.leadscoring import engine as ref_engine
from predictionio_tpu.templates.leadscoring import (
    evaluation as ref_evaluation,
)
from predictionio_tpu.workflow.workflow_utils import (
    EngineVariant as RefEngineVariant,
    extract_engine_params as ref_extract,
    get_engine as ref_get_engine,
)
from predictionio_torch.controller import WorkflowContext, metrics
from predictionio_torch.controller.evaluation import MetricEvaluator
from predictionio_torch.templates.leadscoring import engine as port_engine
from predictionio_torch.templates.leadscoring.evaluation import (
    LeadScoringEvaluation,
    RegGridGenerator,
)
from predictionio_torch.utils.profiling import MetricsLogger
from predictionio_torch.workflow.checkpoint import CheckpointManager
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

FACTORY = "predictionio_torch.templates.leadscoring.LeadScoringEngine"
APP = "LeadApp"
LR_TOL = dict(rtol=2e-4, atol=1e-5)

torch.set_num_threads(1)


def session_rows(seed=7, per_page=60):
    """The reference test's planted structure: landing page "promo"
    converts ~90 %, "home" ~10 %, independent of the other features; and
    a second view of a session (ignored: the first defines it), a view
    without a sessionId and a buy of an unknown session."""
    rng = np.random.default_rng(seed)
    rows = []
    n = 0
    for lp, rate in (("promo", 0.9), ("home", 0.1)):
        for k in range(per_page):
            sid = f"s{n}"
            n += 1
            rows.append(ev("view", "user", f"u{n}", None, {
                "sessionId": sid, "landingPageId": lp,
                "referrerId": f"r{k % 3}",
                "browser": ["Chrome", "Firefox"][k % 2]}))
            if rng.random() < rate:
                rows.append(ev("buy", "user", f"u{n}", "i1",
                               {"sessionId": sid}))
    rows += [ev("view", "user", "u1", None, {
                 "sessionId": "s0", "landingPageId": "home",
                 "referrerId": "r9", "browser": "Safari"}),
             ev("view", "user", "u2", None, {"landingPageId": "promo"}),
             ev("buy", "user", "u3", "i1", {"sessionId": "nope"})]
    return rows


def variant_dict(app=APP, iterations=300, step=0.2, reg=0.01):
    return {"id": "lead-test", "engineFactory": FACTORY,
            "datasource": {"params": {"appName": app}},
            "algorithms": [{"name": "leadscoring", "params": {
                "iterations": iterations, "stepSize": step,
                "regParam": reg}}]}


def _engine(vd=None):
    variant = EngineVariant.from_dict(vd or variant_dict())
    engine = get_engine(variant.engine_factory)
    return variant, engine, extract_engine_params(engine, variant)


QUERIES = ([{"landingPageId": lp, "referrerId": r, "browser": b}
            for lp in ("promo", "home", "new")
            for r in ("r0", "r1", "r2", "r9")
            for b in ("Chrome", "Firefox", "Netscape")]
           + [{}, {"landingPageId": 7}])


# -- parity with the reference ----------------------------------------------

def test_datasource_preparator_and_folds_match_reference(memory_storage,
                                                        port_storage):
    insert_both(memory_storage, port_storage, APP, session_rows())
    params = dict(appName=APP, evalK=3)
    ref_ds = ref_engine.DataSource(ref_engine.DataSourceParams(**params))
    port_ds = port_engine.DataSource(port_engine.DataSourceParams(**params))
    ref_td = ref_ds.read_training(ref_ctx(memory_storage))
    port_td = port_ds.read_training(port_ctx(port_storage))

    def sessions(td):
        return [(s.features, s.converted) for s in td.sessions]

    assert sessions(port_td) == sessions(ref_td)
    assert len(port_td.sessions) == 120
    assert port_td.sessions[0].features == ("promo", "r0", "Chrome")
    ref_pd = ref_engine.Preparator().prepare(None, ref_td)
    port_pd = port_engine.Preparator().prepare(None, port_td)
    np.testing.assert_array_equal(port_pd.features, ref_pd.features)
    np.testing.assert_array_equal(port_pd.labels, ref_pd.labels)
    assert port_pd.vocabs == ref_pd.vocabs
    assert port_pd.offsets == ref_pd.offsets

    ref_folds = ref_ds.read_eval(ref_ctx(memory_storage))
    port_folds = port_ds.read_eval(port_ctx(port_storage))
    assert len(port_folds) == len(ref_folds) == 3
    for (p_td, p_qa), (r_td, r_qa) in zip(port_folds, ref_folds):
        assert sessions(p_td) == sessions(r_td)
        assert p_qa == r_qa and len(p_qa) == 40


def test_train_and_scores_match_reference(memory_storage, port_storage):
    insert_both(memory_storage, port_storage, APP, session_rows())
    vd = variant_dict(iterations=60)
    _, port, port_ep = _engine(vd)
    vd["engineFactory"] = FACTORY.replace("predictionio_torch.",
                                          "predictionio_tpu.")
    ref_variant = RefEngineVariant.from_dict(vd)
    ref = ref_get_engine(ref_variant.engine_factory)
    ref_ep = ref_extract(ref, ref_variant)
    port_model = port.train(port_ctx(port_storage), port_ep)[0]
    ref_model = ref.train(ref_ctx(memory_storage), ref_ep)[0]
    for name in ("weights", "bias", "loss_history"):
        np.testing.assert_allclose(getattr(port_model.lr, name),
                                   getattr(ref_model.lr, name), **LR_TOL)
    assert port_model.base_rate == ref_model.base_rate
    assert (port_model.vocabs, port_model.offsets) == (ref_model.vocabs,
                                                       ref_model.offsets)
    for q in QUERIES:
        got = port.predict(port_ep, [port_model], q)["score"]
        want = ref.predict(ref_ep, [ref_model], q)["score"]
        assert got == pytest.approx(want, rel=2e-4, abs=1e-5), q


def test_evaluation_auc_matches_reference(memory_storage, port_storage):
    """Each cell's AUC (3 folds, regParam 0.01 and 0.1) equals the
    reference's: the scores of equal feature triples tie in both, and
    the two packages order unequal ones alike."""
    insert_both(memory_storage, port_storage, APP, session_rows())
    regs = (0.01, 0.1)
    got = MetricEvaluator.evaluate(
        port_ctx(port_storage), LeadScoringEvaluation(),
        RegGridGenerator(APP, eval_k=3, reg_params=regs).engine_params_list)
    want = RefMetricEvaluator.evaluate(
        ref_ctx(memory_storage), ref_evaluation.LeadScoringEvaluation(),
        ref_evaluation.RegGridGenerator(
            APP, eval_k=3, reg_params=regs).engine_params_list)
    assert got.metric_name == want.metric_name == "AUC"
    for g, w in zip(got.all_results, want.all_results):
        assert g.scores["AUC"] == pytest.approx(w.scores["AUC"], rel=1e-9)
        assert g.per_fold == pytest.approx(w.per_fold, rel=1e-9)
        assert g.scores["AUC"] > 0.75  # planted 0.9-vs-0.1 structure


def test_evaluation_grid_is_the_references(monkeypatch):
    monkeypatch.setenv("PIO_EVAL_APP_NAME", "X")
    monkeypatch.setenv("PIO_EVAL_K", "4")

    def cells(e):
        return [(ep.data_source_params.appName, ep.data_source_params.evalK,
                 p.regParam, p.iterations, p.stepSize)
                for ep in e.engine_params_list
                for _, p in ep.algorithm_params_list]

    assert (cells(LeadScoringEvaluation())
            == cells(ref_evaluation.LeadScoringEvaluation()))
    assert [c[2] for c in cells(LeadScoringEvaluation())] == [0.001, 0.01,
                                                             0.1]


# -- the metric zoo against the reference's ----------------------------------

def _auc(pairs, module=metrics):
    return module.AUC().evaluate_all(
        [({}, {"score": s}, {"label": y}) for s, y in pairs])


def test_auc_perfect_and_random_and_ties():
    assert _auc([(0.9, 1), (0.8, 1), (0.2, 0), (0.1, 0)]) == 1.0
    assert _auc([(0.1, 1), (0.2, 1), (0.8, 0), (0.9, 0)]) == 0.0
    # all-tied scores → 0.5 through the tie correction
    assert _auc([(0.5, 1), (0.5, 0), (0.5, 1), (0.5, 0)]) == 0.5
    # a one-class fold is undefined
    assert math.isnan(_auc([(0.7, 1)]))


def test_auc_is_undefined_per_point():
    """No per-point AUC: `calculate` returns None (the excluded value),
    and the per-point `aggregate` refuses."""
    assert metrics.AUC().calculate({}, {"score": 0.9}, {"label": 1}) is None
    with pytest.raises(TypeError, match="set-level"):
        metrics.AUC().aggregate([None, None])


def test_auc_against_the_rank_formula_and_the_reference():
    rng = np.random.default_rng(0)
    scores = np.round(rng.random(200), 2)  # with ties
    labels = (rng.random(200) < 0.4).astype(int)
    pairs = [(float(s), int(y)) for s, y in zip(scores, labels)]
    got = _auc(pairs)
    # the probability a random positive outranks a random negative (ties
    # count half)
    pos, neg = scores[labels == 1], scores[labels == 0]
    cmp = ((pos[:, None] > neg[None, :]).sum()
           + 0.5 * (pos[:, None] == neg[None, :]).sum())
    assert got == pytest.approx(cmp / (len(pos) * len(neg)), abs=1e-12)
    assert got == _auc(pairs, ref_metrics)


@pytest.mark.parametrize("name", ["SumMetric", "StdevMetric", "ZeroMetric"])
def test_aggregating_metrics_match_reference(name):
    def make(module):
        base = getattr(module, name)
        if name == "ZeroMetric":
            return base()

        class Point(base):
            def calculate(self, q, p, a):
                return None if a is None else float(p) - a

        return Point()

    qpa = [(None, 3.0, 1.0), (None, 2.5, 0.5), (None, 1.0, None),
           (None, 4.0, 1.5)]
    got = make(metrics).evaluate_all(qpa)
    assert got == make(ref_metrics).evaluate_all(qpa)
    assert got == {"SumMetric": 6.5, "ZeroMetric": 0.0}.get(
        name, pytest.approx(np.std([2.0, 2.0, 2.5], ddof=1)))
    assert make(metrics).evaluate_all(qpa[:1]) == make(
        ref_metrics).evaluate_all(qpa[:1])


# -- the reference's cases, on the port --------------------------------------

def test_train_and_score_separates_pages(port_storage, tmp_path):
    """Planted 0.9 against 0.1 conversion; the train's metrics line."""
    insert(port_storage, APP, session_rows())
    variant, engine, ep = _engine()
    path = tmp_path / "metrics.jsonl"
    with MetricsLogger(str(path)) as logger:
        ctx = WorkflowContext(device="cpu", seed=1, storage=port_storage,
                              metrics=logger)
        instance = CoreWorkflow.run_train(engine, ep, variant, ctx)
    assert instance.status == "COMPLETED"
    blob = port_storage.model_data_models().get(instance.id).models
    models = engine.deserialize_models(blob)
    hi = engine.predict(ep, models, {"landingPageId": "promo",
                                     "referrerId": "r0",
                                     "browser": "Chrome"})["score"]
    lo = engine.predict(ep, models, {"landingPageId": "home",
                                     "referrerId": "r0",
                                     "browser": "Chrome"})["score"]
    assert 0.0 <= lo < hi <= 1.0
    assert hi > 0.6 and lo < 0.4
    line = json.loads(path.read_text().splitlines()[-1])
    assert line["stage"] == "train/leadscoring"
    assert line["sessions"] == 120
    assert line["conversion_rate"] == models[0].base_rate


def test_unseen_features_fall_back_to_base_rate(port_storage):
    insert(port_storage, APP, session_rows())
    _, engine, ep = _engine()
    models = engine.train(port_ctx(port_storage), ep)
    s = engine.predict(ep, models, {"landingPageId": "never-seen",
                                    "referrerId": "nope",
                                    "browser": "Netscape"})["score"]
    # the prior: the training conversion rate (~0.5 here)
    assert s == models[0].base_rate and 0.3 < s < 0.7
    # a partly known query still goes through the model
    s2 = engine.predict(ep, models, {"landingPageId": "promo",
                                     "referrerId": "nope",
                                     "browser": "Netscape"})["score"]
    assert s2 > 0.5


def test_empty_app_fails_sanity_check(port_storage):
    insert(port_storage, "EmptyLead", [])
    variant, engine, ep = _engine(variant_dict("EmptyLead"))
    with pytest.raises(ValueError, match="no sessions"):
        CoreWorkflow.run_train(engine, ep, variant, port_ctx(port_storage))


def test_interrupted_resume_matches_uninterrupted(port_storage, tmp_path,
                                                  caplog):
    """`ctx.checkpoint_dir` reaches the template's `logreg_train` under
    its tag `lr`: a 20-step run, then the 40-step run resumes at 20 and
    ends on the uninterrupted model's bits."""
    insert(port_storage, APP, session_rows())

    def train(iters, ckpt):
        _, engine, ep = _engine(variant_dict(iterations=iters))
        ctx = WorkflowContext(
            device="cpu", seed=1, storage=port_storage,
            checkpoint_dir=str(tmp_path / "ck") if ckpt else None,
            checkpoint_every=10)
        return engine.train(ctx, ep)[0]

    want = train(40, ckpt=False)
    train(20, ckpt=True)  # the "interrupted" run
    cm = CheckpointManager(str(tmp_path / "ck" / "lr"))
    assert cm.latest_step() == 20
    with caplog.at_level(logging.INFO):
        got = train(40, ckpt=True)
    assert any("resumed from checkpoint step 20" in r.getMessage()
               for r in caplog.records)
    assert cm.latest_step() == 40
    np.testing.assert_array_equal(got.lr.weights, want.lr.weights)
    np.testing.assert_array_equal(got.lr.bias, want.lr.bias)
    assert got.lr.loss_history == want.lr.loss_history


@pytest.mark.parametrize("every,steps", [(None, [32, 36, 40]),
                                         (15, [15, 30, 40])])
def test_checkpoint_cadence(port_storage, tmp_path, every, steps):
    """`checkpoint_every_or`: the run's `checkpoint_every` when it set one,
    else the template's default of a tenth of its iterations (40 → every
    4; three steps kept)."""
    insert(port_storage, APP, session_rows())
    _, engine, ep = _engine(variant_dict(iterations=40))
    ctx = WorkflowContext(device="cpu", storage=port_storage,
                          checkpoint_dir=str(tmp_path), checkpoint_every=every)
    assert ctx.checkpoint_every_or(4) == (every or 4)
    engine.train(ctx, ep)
    assert CheckpointManager(str(tmp_path / "lr")).all_steps() == steps


def test_events_file_is_refused(tmp_path):
    ds = port_engine.DataSource(port_engine.DataSourceParams(appName="A"))
    with pytest.raises(ValueError, match="events file"):
        ds.read_training(WorkflowContext(device="cpu", events_path=str(
            tmp_path / "events.jsonl")))


def test_template_engine_json_parses():
    path = os.path.join(REPO, "predictionio_torch", "templates",
                        "leadscoring", "engine.json")
    variant = read_engine_json(path)
    assert variant.engine_factory == FACTORY
    engine = get_engine(variant.engine_factory)
    ep = extract_engine_params(engine, variant)
    name, params = ep.algorithm_params_list[0]
    assert name == "leadscoring"
    assert (params.iterations, params.stepSize, params.regParam) == (
        300, 0.1, 0.01)
