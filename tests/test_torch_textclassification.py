"""The port's Text Classification template on the CPU, held against the
reference template: the same seeded `$set` documents in a memory store
of each package give equal training data, prepared data and `read_eval`
folds; NB (rtol 1e-6 / atol 1e-7) and LR (rtol 2e-4 / atol 1e-5) train
within the classification ops' bars on a corpus without exact ties
(`start_ties`) and answer every query alike; `Engine.eval_grid` scores as the
reference's does, through `train_grid` and sequentially; the Word2Vec
variant's head, fed the reference's vectors, lands within the LR bar.
Then the reference's own cases (tests/test_textclassification_template.py)
run against the port."""

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
from predictionio_tpu.templates.textclassification import engine as ref_engine
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
from predictionio_torch.ops import text as port_text
from predictionio_torch.templates.textclassification import (
    engine as port_engine,
)
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

FACTORY = ("predictionio_torch.templates.textclassification."
           "TextClassificationEngine")
APP = "TextApp"
NB_TOL = dict(rtol=1e-6, atol=1e-7)
LR_TOL = dict(rtol=2e-4, atol=1e-5)

torch.set_num_threads(1)

SPAM = [
    "buy cheap pills online now",
    "cheap pills great deal buy now",
    "win money now cheap offer",
    "online pharmacy cheap pills deal",
    "great offer win money online",
    "cheap deal buy pills win",
]
HAM = [
    "meeting tomorrow about the quarterly report",
    "please review the attached quarterly report",
    "lunch meeting with the team tomorrow",
    "the report needs review before the meeting",
    "team review of the quarterly numbers",
    "schedule the team meeting for tomorrow",
]


def reference_rows() -> list:
    """The reference test's store: six spam and six ham documents."""
    return ([ev("$set", "content", f"spam{i}", None,
                {"text": t, "category": "spam"}) for i, t in enumerate(SPAM)]
            + [ev("$set", "content", f"ham{i}", None,
                  {"text": t, "category": "ham"}) for i, t in enumerate(HAM)])


TOPICS = {"sports": ["match", "goal", "team", "score", "league", "coach"],
          "tech": ["chip", "code", "cloud", "server", "kernel", "data"],
          "food": ["pasta", "spice", "bake", "recipe", "sauce", "grill"]}
COMMON = ["the", "a", "new", "today", "big", "of", "and", "it's", "2024"]


def doc_rows(counts=(23, 17, 21), seed=0) -> list:
    """Seeded documents of three topics (`counts` a topic; 5-14 tokens,
    about half from the topic's words, the rest common), and documents the
    fold drops: an `$unset` text, a `$delete`d entity, one without a
    category; one re-`$set` after a `$delete`, one text replaced."""
    rng = np.random.default_rng(seed)
    rows = []
    n = 0
    for topic, count in zip(TOPICS, counts):
        for _ in range(count):
            words = [rng.choice(TOPICS[topic]) if rng.random() < 0.5
                     else rng.choice(COMMON)
                     for _ in range(rng.integers(5, 15))]
            rows.append(ev("$set", "content", f"d{n:03d}", None, {
                "text": " ".join(words).capitalize() + ".",
                "category": topic}))
            n += 1
    full = {"text": "goal and score", "category": "sports"}
    rows += [ev("$set", "content", "unset", None, full),
             ev("$unset", "content", "unset", None, {"text": None}),
             ev("$set", "content", "deleted", None, full),
             ev("$delete", "content", "deleted"),
             ev("$set", "content", "unlabeled", None, {"text": "code"}),
             ev("$set", "content", "d003", None,
                {"text": "The chip and the kernel."}),
             ev("$delete", "content", "d005"),
             ev("$set", "content", "d005", None, {
                 "text": "recipe of pasta sauce", "category": "food"})]
    return rows


QUERIES = ([{"text": t} for t in SPAM + HAM]
           + [{"text": "the new league coach"}, {"text": "cloud kernel code"},
              {"text": "bake a pasta"}, {"text": ""}, {"text": "unknown"},
              {"text": "goal chip sauce"}, {"text": 42}])


def variant_dict(algo="nb", params=None, app=APP, factory=FACTORY,
                 eval_k=0):
    return {"id": "text-test", "engineFactory": factory,
            "datasource": {"params": {"appName": app, "evalK": eval_k}},
            "algorithms": [{"name": algo, "params": params or {}}]}


def engines(algo, params, eval_k=0):
    """((port engine, its params), (reference engine, its params)) of the
    same engine.json body."""
    out = []
    for factory, variant_cls, get, extract in (
            (FACTORY, EngineVariant, get_engine, extract_engine_params),
            (FACTORY.replace("predictionio_torch.", "predictionio_tpu."),
             RefEngineVariant, ref_get_engine, ref_extract_engine_params)):
        variant = variant_cls.from_dict(
            variant_dict(algo, params, factory=factory, eval_k=eval_k))
        engine = get(variant.engine_factory)
        out.append((engine, extract(engine, variant)))
    return out


# -- parity with the reference ----------------------------------------------

def test_datasource_preparator_and_folds_match_reference(memory_storage,
                                                        port_storage):
    """Equal: the documents in entity-id order (the folded-away ones
    dropped by `required=`), the tokens, classes and class indices, every
    fold."""
    insert_both(memory_storage, port_storage, APP, doc_rows())
    params = dict(appName=APP, evalK=3)
    ref_ds = ref_engine.DataSource(ref_engine.DataSourceParams(**params))
    port_ds = port_engine.DataSource(port_engine.DataSourceParams(**params))
    ref_td = ref_ds.read_training(ref_ctx(memory_storage))
    port_td = port_ds.read_training(port_ctx(port_storage))
    assert len(port_td.texts) == 61
    assert (port_td.texts, port_td.labels) == (ref_td.texts, ref_td.labels)
    ref_pd = ref_engine.Preparator().prepare(None, ref_td)
    port_pd = port_engine.Preparator().prepare(None, port_td)
    assert port_pd.tokens == ref_pd.tokens
    assert port_pd.labels == ref_pd.labels
    assert port_pd.classes == ref_pd.classes == ["food", "sports", "tech"]
    np.testing.assert_array_equal(port_pd.label_idx, ref_pd.label_idx)
    assert port_pd.label_idx.dtype == ref_pd.label_idx.dtype

    ref_folds = ref_ds.read_eval(ref_ctx(memory_storage))
    port_folds = port_ds.read_eval(port_ctx(port_storage))
    assert len(port_folds) == len(ref_folds) == 3
    for (p_td, p_qa), (r_td, r_qa) in zip(port_folds, ref_folds):
        assert (p_td.texts, p_td.labels) == (r_td.texts, r_td.labels)
        assert p_qa == r_qa and len(p_qa) in (20, 21)


def trained_pair(memory_storage, port_storage, algo, params, rows):
    insert_both(memory_storage, port_storage, APP, rows)
    (port, port_ep), (ref, ref_ep) = engines(algo, params)
    return ((port, port_ep, port.train(port_ctx(port_storage), port_ep)[0]),
            (ref, ref_ep, ref.train(ref_ctx(memory_storage), ref_ep)[0]))


def start_ties(pd, num_features: int) -> int:
    """The (feature, class) cells whose softmax-regression gradient at the
    zero start is 0 in exact arithmetic though the feature occurs: a class
    holds exactly 1/C of the feature's hashed count. There Adam's first
    step scales each package's f32 rounding residue up to O(stepSize), and
    the two part ways (the open finding of ROADMAP Queue 3, exactly
    balanced classes being its bias case)."""
    tf = port_text.hashing_tf(pd.tokens, num_features).astype(np.int64)
    c = len(pd.classes)
    per_class = tf.T @ np.eye(c, dtype=np.int64)[pd.label_idx]
    residue = c * per_class - tf.sum(0)[:, None]
    return int(((residue == 0) & (tf.sum(0) > 0)[:, None]).sum())


def assert_answers_equal(port, port_ep, port_model, ref, ref_ep, ref_model):
    for q in QUERIES:
        got = port.predict(port_ep, [port_model], q)
        want = ref.predict(ref_ep, [ref_model], q)
        assert got["category"] == want["category"], q
        np.testing.assert_allclose(got["confidence"], want["confidence"],
                                   rtol=1e-4, err_msg=str(q))


@pytest.mark.parametrize("algo,params", [
    ("nb", {"lambda": 1.0, "numFeatures": 64}),
    ("nb", {"lambda": 0.25, "numFeatures": 256, "minDocFreq": 2}),
    ("lr", {"iterations": 40, "stepSize": 0.3, "numFeatures": 64}),
    ("lr", {"iterations": 30, "stepSize": 0.1, "regParam": 0.01,
            "numFeatures": 128, "minDocFreq": 2}),
])
def test_train_and_predictions_match_reference(memory_storage, port_storage,
                                               algo, params):
    """Topics of 22, 22 and 17 documents: the same IDF, the models within
    the ops' bars, every answer the same category. The corpus has no
    exact tie (`start_ties`, asserted), where the LR bar does not hold."""
    (port, port_ep, port_model), (ref, ref_ep, ref_model) = trained_pair(
        memory_storage, port_storage, algo, params, doc_rows(seed=0))
    pd = port_engine.Preparator().prepare(None, port_engine.DataSource(
        port_ep.data_source_params).read_training(port_ctx(port_storage)))
    assert start_ties(pd, port_model.num_features) == 0
    np.testing.assert_array_equal(port_model.idf.idf, ref_model.idf.idf)
    assert port_model.classes == ref_model.classes
    assert (port_model.kind, port_model.num_features) == (
        ref_model.kind, ref_model.num_features)
    if algo == "nb":
        np.testing.assert_allclose(port_model.nb.log_prior,
                                   ref_model.nb.log_prior, **NB_TOL)
        np.testing.assert_allclose(port_model.nb.log_theta,
                                   ref_model.nb.log_theta, **NB_TOL)
    else:
        for name in ("weights", "bias", "loss_history"):
            np.testing.assert_allclose(getattr(port_model.lr, name),
                                       getattr(ref_model.lr, name), **LR_TOL)
    assert_answers_equal(port, port_ep, port_model, ref, ref_ep, ref_model)


def test_w2v_head_matches_reference_on_its_vectors(memory_storage,
                                                  port_storage, monkeypatch):
    """The Word2Vec variant's draws differ between the packages, so the
    head is held on the reference's vectors: the port's `word2vec_train`
    hands back the reference model's embeddings, and the port's head
    (mean document vectors → softmax regression) lands within the LR bar
    of the reference's, every answer the same category."""
    params = {"dim": 8, "window": 2, "steps": 60, "batchSize": 64,
              "seed": 3, "iterations": 60, "stepSize": 0.2}
    insert_both(memory_storage, port_storage, APP, doc_rows(seed=0))
    (port, port_ep), (ref, ref_ep) = engines("word2vec", params)
    ref_model = ref.train(ref_ctx(memory_storage), ref_ep)[0]
    calls = []

    def reference_vectors(docs_tokens, cfg, **kw):
        calls.append(cfg)
        return port_text.Word2VecModel(vectors=ref_model.w2v.vectors,
                                       vocab=ref_model.w2v.vocab)

    monkeypatch.setattr(port_engine, "word2vec_train", reference_vectors)
    port_model = port.train(port_ctx(port_storage), port_ep)[0]
    assert calls == [port_text.Word2VecConfig(
        dim=8, window=2, negatives=5, steps=60, batch_size=64,
        learning_rate=0.05, min_count=1, seed=3)]
    for name in ("weights", "bias", "loss_history"):
        np.testing.assert_allclose(getattr(port_model.lr, name),
                                   getattr(ref_model.lr, name), **LR_TOL)
    assert port_model.classes == ref_model.classes
    assert_answers_equal(port, port_ep, port_model, ref, ref_ep, ref_model)


def test_w2v_seed_is_the_contexts_unless_given(port_storage, monkeypatch):
    insert(port_storage, APP, doc_rows(seed=4))
    seen = []
    real = port_engine.word2vec_train

    def spy(docs_tokens, cfg, **kw):
        seen.append(cfg.seed)
        return real(docs_tokens, cfg, **kw)

    monkeypatch.setattr(port_engine, "word2vec_train", spy)
    for params in ({}, {"seed": 11}):
        (port, port_ep), _ = engines("word2vec", dict(
            params, dim=4, steps=2, batchSize=16, iterations=2))
        port.train(port_ctx(port_storage, seed=5), port_ep)
    assert seen == [5, 11]


class Accuracy(AverageMetric):
    def calculate(self, q, p, a):
        return 1.0 if p["category"] == a["category"] else 0.0


class RefAccuracy(RefAverageMetric):
    def calculate(self, q, p, a):
        return 1.0 if p["category"] == a["category"] else 0.0


@pytest.mark.parametrize("algo,params,param,values", [
    ("nb", {"numFeatures": 64}, "lambda_", [0.1, 1.0, 10.0]),
    ("lr", {"iterations": 20, "stepSize": 0.3, "numFeatures": 64},
     "stepSize", [0.05, 0.3, 0.8]),
])
def test_eval_grid_matches_reference_and_sequential(
        memory_storage, port_storage, monkeypatch, algo, params, param,
        values):
    """A λ / stepSize grid over one featurization scores as the
    reference's does; the port's `train_grid` engages and scores as its
    sequential evaluator."""
    insert_both(memory_storage, port_storage, APP, doc_rows(seed=3))
    (port, port_ep), (ref, ref_ep) = engines(algo, params, eval_k=3)

    def grid(base_ep):
        name, p = base_ep.algorithm_params_list[0]
        return [dataclasses.replace(base_ep, algorithm_params_list=[
            (name, dataclasses.replace(p, **{param: v}))]) for v in values]

    class PortEval(Evaluation):
        engine = port
        metric = Accuracy()

    class RefEval(RefEvaluation):
        engine = ref
        metric = RefAccuracy()

    cls = type(port.components(port_ep)[2][0][1])
    real = cls.train_grid.__func__
    grid_calls = []

    def spy(c, ctx, pd, algos):
        out = real(c, ctx, pd, algos)
        grid_calls.append(out is not None)
        return out

    monkeypatch.setattr(cls, "train_grid", classmethod(spy))
    ctx = port_ctx(port_storage)
    port_res = MetricEvaluator.evaluate(ctx, PortEval(), grid(port_ep))
    assert grid_calls and all(grid_calls), "train_grid never engaged"
    monkeypatch.setattr(cls, "train_grid",
                        classmethod(lambda c, ctx, pd, algos: None))
    seq_res = MetricEvaluator.evaluate(ctx, PortEval(), grid(port_ep))
    ref_res = RefMetricEvaluator.evaluate(ref_ctx(memory_storage), RefEval(),
                                          grid(ref_ep))

    def scores(res):
        return [r.scores[res.metric_name] for r in res.all_results]

    np.testing.assert_allclose(scores(port_res), scores(seq_res),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(scores(port_res), scores(ref_res),
                               rtol=1e-6, atol=1e-9)
    assert all(0.5 < s <= 1.0 for s in scores(port_res))


def test_grid_declines_mixed_featurizations(port_storage):
    insert(port_storage, APP, doc_rows(seed=4))
    (port, port_ep), _ = engines("nb", {"numFeatures": 64})
    pd = port_engine.Preparator().prepare(
        None, port_engine.DataSource(port_ep.data_source_params)
        .read_training(port_ctx(port_storage)))
    algos = [port_engine.NBAlgorithm(port_engine.NBParams(numFeatures=n))
             for n in (64, 128)]
    assert port_engine.NBAlgorithm.train_grid(
        port_ctx(port_storage), pd, algos) is None
    lrs = [port_engine.LRAlgorithm(port_engine.LRParams(minDocFreq=m))
           for m in (0, 1)]
    assert port_engine.LRAlgorithm.train_grid(
        port_ctx(port_storage), pd, lrs) is None


# -- the reference's cases, on the port --------------------------------------

@pytest.mark.parametrize("algo,params", [
    ("nb", {"lambda": 1.0, "numFeatures": 256}),
    ("lr", {"iterations": 300, "stepSize": 0.3, "numFeatures": 256}),
])
def test_train_and_classify(port_storage, algo, params):
    """Six spam and six ham documents (exactly balanced: the LR answers
    are held to the reference's labels, not to its weights)."""
    insert(port_storage, APP, reference_rows())
    variant = EngineVariant.from_dict(variant_dict(algo, params))
    engine = get_engine(variant.engine_factory)
    ep = extract_engine_params(engine, variant)
    instance = CoreWorkflow.run_train(engine, ep, variant,
                                      port_ctx(port_storage, seed=0))
    assert instance.status == "COMPLETED"
    blob = port_storage.model_data_models().get(instance.id).models
    models = engine.deserialize_models(blob)
    r = engine.predict(ep, models, {"text": "cheap pills buy now"})
    assert r["category"] == "spam"
    assert 0.0 < r["confidence"] <= 1.0
    r = engine.predict(ep, models,
                       {"text": "quarterly report for the team meeting"})
    assert r["category"] == "ham"


def test_word2vec_variant(port_storage):
    insert(port_storage, APP, reference_rows())
    variant = EngineVariant.from_dict(variant_dict("word2vec", {
        "dim": 16, "steps": 200, "window": 3, "seed": 0,
        "iterations": 300, "stepSize": 0.3}))
    engine = get_engine(variant.engine_factory)
    ep = extract_engine_params(engine, variant)
    models = engine.train(port_ctx(port_storage, seed=0), ep)
    r = engine.predict(ep, models, {"text": "cheap pills online"})
    assert r["category"] == "spam"
    r = engine.predict(ep, models, {"text": "team meeting tomorrow"})
    assert r["category"] == "ham"


def test_evaluation_kfold_accuracy(port_storage):
    insert(port_storage, APP, reference_rows())
    variant = EngineVariant.from_dict(variant_dict(
        "nb", {"numFeatures": 256}, eval_k=3))
    engine = get_engine(variant.engine_factory)
    ep = extract_engine_params(engine, variant)

    class TextEval(Evaluation):
        pass

    TextEval.engine = engine
    TextEval.metric = Accuracy()
    result = MetricEvaluator.evaluate(port_ctx(port_storage, seed=0),
                                      TextEval(), [ep])
    assert result.best.scores["Accuracy"] >= 0.7


def test_empty_app_fails_sanity_check(port_storage):
    insert(port_storage, "EmptyText", [])
    variant = EngineVariant.from_dict(variant_dict(app="EmptyText"))
    engine = get_engine(variant.engine_factory)
    ep = extract_engine_params(engine, variant)
    with pytest.raises(ValueError, match="no documents"):
        CoreWorkflow.run_train(engine, ep, variant, port_ctx(port_storage))


def test_events_file_is_refused(tmp_path):
    ds = port_engine.DataSource(port_engine.DataSourceParams(appName="A"))
    with pytest.raises(ValueError, match="events file"):
        ds.read_training(WorkflowContext(device="cpu", events_path=str(
            tmp_path / "events.jsonl")))


def test_template_engine_json_parses():
    path = os.path.join(REPO, "predictionio_torch", "templates",
                        "textclassification", "engine.json")
    variant = read_engine_json(path)
    assert variant.engine_factory == FACTORY
    engine = get_engine(variant.engine_factory)
    ep = extract_engine_params(engine, variant)
    assert ep.algorithm_params_list[0][0] == "nb"
    assert ep.algorithm_params_list[0][1].numFeatures == 1024
    assert port_engine.LRAlgorithm.checkpoint_tags == ("lr",)
    assert port_engine.Word2VecAlgorithm.checkpoint_tags == ("w2v",
                                                             "w2v-head")
