"""The port's evaluation and batch-predict slice on the CPU: k-fold
`read_eval` and `MAPatK` against the reference, `MetricEvaluator` grid ≡
sequential (rel 1e-4, abs 1e-6: the reference's bar,
tests/test_als_grid.py), device-resident grid models on every `ALSModel`
read path, and `console eval` / `console batchpredict` end to end."""

import json
import os

import numpy as np
import pytest
import torch

from predictionio_tpu.controller import MAPatK as RefMAPatK
from predictionio_tpu.controller import WorkflowContext as RefContext
from predictionio_tpu.storage.base import App
from predictionio_tpu.templates.recommendation import engine as ref_engine
from predictionio_tpu.tools.transfer import file_to_events
from predictionio_torch.controller import MAPatK, WorkflowContext
from predictionio_torch.controller.engine import Engine
from predictionio_torch.controller.evaluation import MetricEvaluator
from predictionio_torch.data.bimap import BiMap
from predictionio_torch.models.als_model import ALSModel, SeenItems
from predictionio_torch.ops import als_grid, ranking, spd_solve
from predictionio_torch.templates.recommendation import engine as port_engine
from predictionio_torch.templates.recommendation.evaluation import (
    RecommendationEvaluation,
    _engine_params,
)
from predictionio_torch.tools import console
from predictionio_torch.workflow.core_workflow import (
    read_model_file,
    write_model_file,
)
from predictionio_torch.workflow.create_server import load_served_state
from tests.test_torch_recommendation import (
    ENGINE_JSON,
    _instance,
    _write_events,
)

EVAL_CLASS = ("predictionio_torch.templates.recommendation.evaluation."
              "RecommendationEvaluation")

# one intra-op thread: these tests use small tensors, and the suite's
# parallel workers share the machine's cores with timing-sensitive tests
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_never_launches():
    spd_solve.reset_launches()
    yield
    assert not any(spd_solve.launches.values()), spd_solve.launches


def _evaluation(lambdas=(0.01, 0.1)):
    """RecommendationEvaluation over a rank-4 λ grid, 5 iterations."""
    evaluation = RecommendationEvaluation()
    evaluation.engine_params_list = [_engine_params(4, 5, lam, "MyApp1", 3)
                                     for lam in lambdas]
    return evaluation


def test_read_eval_matches_reference(tmp_path, memory_storage):
    """Folds by event index over the same events: every fold's training
    arrays and (query, actual) pairs equal the reference's."""
    path = str(tmp_path / "events.jsonl")
    events = _write_events(path, seed=4)
    memory_storage.meta_apps().insert(App(id=0, name="MyApp1"))
    assert file_to_events(path, "MyApp1", storage=memory_storage) == \
        (len(events), 0)
    ref_folds = ref_engine.DataSource(ref_engine.DataSourceParams(
        appName="MyApp1", evalK=3)).read_eval(RefContext(
            storage=memory_storage))
    port_folds = port_engine.DataSource(port_engine.DataSourceParams(
        appName="MyApp1", evalK=3)).read_eval(WorkflowContext(
            device="cpu", events_path=path))
    assert len(port_folds) == len(ref_folds) == 3
    for (p_td, p_qa), (r_td, r_qa) in zip(port_folds, ref_folds):
        for name in ("user_idx", "item_idx", "ratings"):
            np.testing.assert_array_equal(getattr(p_td, name),
                                          getattr(r_td, name))
        assert p_td.user_ids.to_dict() == r_td.user_ids.to_dict()
        assert p_qa == r_qa
        assert p_qa and all(q["num"] == 10 for q, _ in p_qa)


def test_read_eval_needs_two_folds(tmp_path):
    path = str(tmp_path / "events.jsonl")
    _write_events(path)
    ds = port_engine.DataSource(port_engine.DataSourceParams(evalK=1))
    with pytest.raises(ValueError, match="evalK"):
        ds.read_eval(WorkflowContext(device="cpu", events_path=path))


def test_mapatk_matches_reference():
    rng = np.random.default_rng(3)
    items = [f"i{n}" for n in range(30)]
    qpa = []
    for n in range(40):
        pred = rng.choice(items, size=int(rng.integers(0, 15)), replace=False)
        actual = rng.choice(items, size=int(rng.integers(0, 12)),
                            replace=False)
        qpa.append(({"user": f"u{n}", "num": 10},
                    {"itemScores": [{"item": str(i), "score": 1.0}
                                    for i in pred]},
                    {"items": [str(i) for i in actual]}))
    for k in (1, 5, 10):
        port, ref = MAPatK(k), RefMAPatK(k)
        assert port.name == ref.name == f"MAP@{k}"
        for q, p, a in qpa:
            assert port.calculate(q, p, a) == ref.calculate(q, p, a)
        assert port.evaluate_all(qpa) == ref.evaluate_all(qpa)
    assert np.isnan(MAPatK(10).evaluate_all(
        [({}, {"itemScores": []}, {"items": []})]))
    assert MAPatK().compare(0.2, float("nan")) > 0
    assert MAPatK().compare(0.1, 0.2) < 0


def test_metric_evaluator_grid_matches_sequential(tmp_path, monkeypatch):
    """MetricEvaluator over a λ grid scores each cell the same whether the
    grid path or the sequential loop runs; one grid train per fold."""
    path = str(tmp_path / "events.jsonl")
    _write_events(path, n_users=40, n_items=25, seed=5)
    ctx = WorkflowContext(device="cpu", events_path=path)
    calls = []
    real = als_grid.als_train_grid

    def spy(*a, **k):
        calls.append(len(k["cfgs"]))
        return real(*a, **k)

    monkeypatch.setattr(als_grid, "als_train_grid", spy)
    evaluation = _evaluation(lambdas=(0.01, 0.05, 0.5))
    grid = MetricEvaluator.evaluate(ctx, evaluation,
                                    evaluation.engine_params_list)
    assert calls == [3, 3, 3]  # once per fold, every cell together
    monkeypatch.setattr(Engine, "eval_grid", lambda self, ctx, eps: None)
    seq = MetricEvaluator.evaluate(ctx, evaluation,
                                   evaluation.engine_params_list)
    assert calls == [3, 3, 3]
    for g, s in zip(grid.all_results, seq.all_results):
        assert g.scores["MAP@10"] == pytest.approx(s.scores["MAP@10"],
                                                   rel=1e-4, abs=1e-6)
        assert len(g.per_fold) == 3
    assert grid.all_results.index(grid.best) == \
        seq.all_results.index(seq.best)
    out = json.loads(grid.to_json())
    assert out["metric"] == "MAP@10" and len(out["results"]) == 3
    assert out["bestEngineParams"]["algorithms"][0]["name"] == "als"


def test_stock_grid_batches_per_rank(tmp_path, monkeypatch):
    """RecommendationEvaluation's rank {8, 16} × λ {0.01, 0.1} grid: one
    grid train per rank group and fold."""
    path = str(tmp_path / "events.jsonl")
    _write_events(path, seed=6)
    sizes = []
    real = als_grid.als_train_grid
    monkeypatch.setattr(als_grid, "als_train_grid", lambda *a, **k: (
        sizes.append(len(k["cfgs"])) or real(*a, **k)))
    monkeypatch.setenv("PIO_EVAL_K", "2")
    evaluation = RecommendationEvaluation()
    assert [ep.algorithm_params_list[0][1].rank
            for ep in evaluation.engine_params_list] == [8, 8, 16, 16]
    result = MetricEvaluator.evaluate(
        WorkflowContext(device="cpu", events_path=path), evaluation,
        evaluation.engine_params_list)
    assert sizes == [2, 2, 2, 2]  # 2 folds × 2 rank groups
    assert len(result.all_results) == 4
    for r in result.all_results:
        assert 0.0 <= r.scores["MAP@10"] <= 1.0


def test_grid_varying_the_data_source_evaluates_sequentially(tmp_path):
    path = str(tmp_path / "events.jsonl")
    _write_events(path, seed=7)
    evaluation = _evaluation()
    evaluation.engine_params_list[1].data_source_params.evalK = 2
    ctx = WorkflowContext(device="cpu", events_path=path)
    assert evaluation.engine.eval_grid(
        ctx, evaluation.engine_params_list) is None
    result = MetricEvaluator.evaluate(ctx, evaluation,
                                      evaluation.engine_params_list)
    assert [len(r.per_fold) for r in result.all_results] == [3, 2]


def _models(rng, n_users=90, n_items=40, k=6):
    uf = rng.normal(size=(n_users, k)).astype(np.float32)
    vf = rng.normal(size=(n_items, k)).astype(np.float32)
    seen_u = rng.integers(0, n_users, 300).astype(np.int32)
    seen_i = rng.integers(0, n_items, 300).astype(np.int32)
    common = dict(user_ids=BiMap.string_int([f"u{i}" for i in range(n_users)]),
                  item_ids=BiMap.string_int([f"i{i}" for i in range(n_items)]),
                  seen=SeenItems(seen_u, seen_i, n_users))
    host = ALSModel(user_factors=uf, item_factors=vf, device="cpu", **common)
    dev = ALSModel(user_factors=torch.from_numpy(uf),
                   item_factors=torch.from_numpy(vf), device="cpu", **common)
    return host, dev


def test_device_resident_models_on_every_read_path(monkeypatch):
    """Grid-eval models hold tensor factors: single queries, small and
    large batches and the algorithm's batch_predict all score them on
    their device (never the host branch, never a re-upload) and agree
    with the numpy model."""
    host, dev = _models(np.random.default_rng(0))
    host_calls = []
    real_host = ranking.topk_host
    monkeypatch.setattr(ranking, "topk_host", lambda *a, **k: (
        host_calls.append(isinstance(a[0], torch.Tensor))
        or real_host(*a, **k)))
    for user in ("u3", "u17", "nobody"):
        h, d = host.recommend_products(user, 5), dev.recommend_products(user, 5)
        assert [i for i, _ in h] == [i for i, _ in d]
        assert [s for _, s in h] == pytest.approx([s for _, s in d],
                                                  rel=1e-5)
    assert host_calls and not any(host_calls)
    for n in (10, ranking.SERVE_HOST_MAX_BATCH + 20):
        users = [f"u{i % 90}" for i in range(n)] + ["nobody"]
        hb = host.recommend_products_batch(users, 4)
        db = dev.recommend_products_batch(users, 4)
        assert [[i for i, _ in r] for r in hb] == \
            [[i for i, _ in r] for r in db]
    algo = port_engine.ALSAlgorithm(None)
    queries = [{"user": f"u{i}", "num": 3} for i in range(0, 90, 7)]
    assert [[s["item"] for s in p["itemScores"]]
            for p in algo.batch_predict(dev, queries)] == \
        [[s["item"] for s in algo.predict(host, q)["itemScores"]]
         for q in queries]
    assert not any(host_calls)


def test_device_factors_score_where_they_lie(monkeypatch):
    _, dev = _models(np.random.default_rng(1))
    uploads = []
    real = torch.as_tensor

    def spy(data, *a, **k):
        uploads.append(isinstance(data, np.ndarray) and data.ndim == 2)
        return real(data, *a, **k)

    monkeypatch.setattr(torch, "as_tensor", spy)
    ranking.recommend_topk(dev.user_factors, dev.item_factors,
                           np.arange(5, dtype=np.int32), 3)
    assert not any(uploads)  # no factor matrix crossed from numpy


def test_engine_predict_batch_matches_predict(tmp_path):
    path = str(tmp_path / "events.jsonl")
    _write_events(path, seed=8)
    model_path = str(tmp_path / "model.pio")
    assert console.main(["train", "--engine-json", ENGINE_JSON, "--events",
                         path, "--model-out", model_path,
                         "--device", "cpu"]) == 0
    state = load_served_state(ENGINE_JSON, model_path, torch.device("cpu"))
    queries = [{"user": f"u{u}", "num": 4} for u in range(0, 30, 3)]
    queries.append({"user": "nobody", "num": 2})
    batch = state.engine.predict_batch(state.engine_params, state.models,
                                       queries)
    assert batch == [state.engine.predict(state.engine_params, state.models,
                                          q) for q in queries]


def test_console_eval_on_cpu(tmp_path, capsys, monkeypatch):
    """`console eval` of the stock evaluation end to end: the summary, the
    evaluation record with its results, and the grid path taken."""
    path = str(tmp_path / "events.jsonl")
    _write_events(path, seed=9)
    out = str(tmp_path / "eval.json")
    monkeypatch.setenv("PIO_EVAL_K", "2")
    sizes = []
    real = als_grid.als_train_grid
    monkeypatch.setattr(als_grid, "als_train_grid", lambda *a, **k: (
        sizes.append(len(k["cfgs"])) or real(*a, **k)))
    rc = console.main(["eval", EVAL_CLASS, "--events", path, "--out", out,
                       "--device", "cpu"])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "Metric: MAP@10" in printed and "<= BEST" in printed
    assert sizes == [2, 2, 2, 2]
    with open(out) as f:
        record = json.load(f)
    assert record["status"] == "EVALCOMPLETED"
    assert record["id"] in printed
    assert record["evaluation_class"] == EVAL_CLASS
    assert record["engine_params_generator_class"] == EVAL_CLASS
    results = json.loads(record["evaluator_results_json"])
    assert len(results["results"]) == 4
    assert record["evaluator_results"].startswith("Metric: MAP@10")


def test_console_eval_reports_failures(tmp_path, capsys, monkeypatch):
    rc = console.main(["eval", EVAL_CLASS, "--events",
                       str(tmp_path / "missing.jsonl"), "--device", "cpu"])
    assert rc == 1
    assert "Cannot read input" in capsys.readouterr().err
    rc = console.main(["eval", "no.such.Evaluation", "--events", "x",
                       "--device", "cpu"])
    assert rc == 1
    assert "Evaluation failed" in capsys.readouterr().err
    path = str(tmp_path / "events.jsonl")
    _write_events(path)
    monkeypatch.setenv("PIO_EVAL_K", "1")  # read_eval refuses one fold
    out = str(tmp_path / "eval.json")
    rc = console.main(["eval", EVAL_CLASS, "--events", path, "--out", out,
                       "--device", "cpu"])
    assert rc == 1
    assert "evalK" in capsys.readouterr().err
    with open(out) as f:
        assert json.load(f)["status"] == "EVALFAILED"


def test_console_batchpredict_on_cpu(tmp_path, capsys):
    """`console batchpredict` writes one {query, prediction} line per query
    in input order, equal to the in-process engine's batch; the model's
    pickled device does not decide where it scores."""
    path = str(tmp_path / "events.jsonl")
    _write_events(path, seed=10)
    model_path = str(tmp_path / "model.pio")
    assert console.main(["train", "--engine-json", ENGINE_JSON, "--events",
                         path, "--model-out", model_path,
                         "--device", "cpu"]) == 0
    instance, models = read_model_file(model_path)
    models[0].device = "cuda"  # as a model trained on the card is pickled
    write_model_file(model_path, instance, models)
    queries = [{"user": f"u{u % 30}", "num": 1 + u % 5}
               for u in range(ranking.SERVE_HOST_MAX_BATCH + 30)]
    queries.append({"user": "nobody", "num": 3})
    q_path, o_path = tmp_path / "q.jsonl", str(tmp_path / "out.jsonl")
    q_path.write_text("\n".join(json.dumps(q) for q in queries) + "\n\n")
    rc = console.main(["batchpredict", "--engine-json", ENGINE_JSON,
                       "--model", model_path, "--input", str(q_path),
                       "--output", o_path, "--device", "cpu"])
    assert rc == 0
    assert f"{len(queries)} queries" in capsys.readouterr().out
    with open(o_path) as f:
        lines = [json.loads(line) for line in f]
    state = load_served_state(ENGINE_JSON, model_path, torch.device("cpu"))
    want = state.engine.predict_batch(state.engine_params, state.models,
                                      queries)
    assert [line["query"] for line in lines] == queries
    assert [line["prediction"] for line in lines] == want


def test_console_batchpredict_reports_failures(tmp_path, capsys):
    model_path = str(tmp_path / "model.pio")
    write_model_file(model_path, _instance("x", "some.other.Engine"), [])
    q_path = tmp_path / "q.jsonl"
    q_path.write_text('{"user": "u1", "num": 2}\n')
    rc = console.main(["batchpredict", "--engine-json", ENGINE_JSON,
                       "--model", model_path, "--input", str(q_path),
                       "--output", str(tmp_path / "o.jsonl"),
                       "--device", "cpu"])
    assert rc == 1
    assert "trained by some.other.Engine" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "o.jsonl")
