"""The port's Recommendation slice as a whole, on the CPU: events file →
DataSource → Preparator → ALS → model file → `console deploy` →
`POST /queries.json`, held against the reference template."""

import contextlib
import json
import os
import subprocess
import sys
import urllib.request
from datetime import datetime, timedelta, timezone

import numpy as np
import torch

from predictionio_tpu.controller import WorkflowContext as RefContext
from predictionio_tpu.storage.base import App
from predictionio_tpu.templates.recommendation import engine as ref_engine
from predictionio_tpu.tools.transfer import file_to_events
from predictionio_torch import convert
from predictionio_torch.controller import WorkflowContext
from predictionio_torch.models.als_model import ALSModel
from predictionio_torch.ops import ranking
from predictionio_torch.templates.recommendation import engine as port_engine
from predictionio_torch.tools import console
from predictionio_torch.workflow.core_workflow import (
    EngineInstance,
    read_model_file,
    write_model_file,
)
from predictionio_torch.workflow.workflow_utils import (
    extract_engine_params,
    get_engine,
    read_engine_json,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACTORY = "predictionio_torch.templates.recommendation.RecommendationEngine"
ENGINE_JSON = os.path.join(REPO, "predictionio_torch", "templates",
                           "recommendation", "engine.json")

# one intra-op thread: these tests use small tensors, and the suite's
# parallel workers share the machine's cores with timing-sensitive tests
torch.set_num_threads(1)


def _write_events(path, n_users=30, n_items=20, seed=0):
    """Rate events (half-star ratings), some buys, and re-ratings that a
    later event overwrites; every event at its own time."""
    rng = np.random.default_rng(seed)
    t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
    events = []
    for n in range(n_users * 8):
        u, i = rng.integers(n_users), rng.integers(n_items)
        ev = {"event": "buy" if n % 7 == 0 else "rate",
              "entityType": "user", "entityId": f"u{u}",
              "targetEntityType": "item", "targetEntityId": f"i{i}",
              "eventTime": (t0 + timedelta(seconds=n)).isoformat()
              .replace("+00:00", "Z")}
        if ev["event"] == "rate":
            ev["properties"] = {"rating": float(rng.integers(1, 11)) / 2}
        events.append(ev)
    # a user-property event the DataSource must ignore
    events.append({"event": "$set", "entityType": "user", "entityId": "u0",
                   "properties": {"age": 3},
                   "eventTime": t0.isoformat().replace("+00:00", "Z")})
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")
    return events


def _variant_json(path, algorithms, serving=None):
    d = {"id": "default", "engineFactory": FACTORY,
         "datasource": {"params": {"appName": "MyApp1"}},
         "algorithms": algorithms}
    if serving:
        d["serving"] = serving
    with open(path, "w") as f:
        json.dump(d, f)


@contextlib.contextmanager
def _deployed(engine_json, model_path):
    """`console deploy --device cpu --port 0` in a subprocess; yields the
    base URL once the server prints its "deployed on" line."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_torch.tools.console", "deploy",
         "--engine-json", engine_json, "--model", model_path, "--ip",
         "127.0.0.1", "--port", "0", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=REPO, env=env)
    try:
        line = proc.stdout.readline()
        assert " deployed on 127.0.0.1:" in line, line
        yield f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()


def _post(url, query):
    req = urllib.request.Request(url + "/queries.json",
                                 data=json.dumps(query).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def test_datasource_and_preparator_match_reference(tmp_path, memory_storage):
    """The events file read through the port's columnar store equals the
    reference's storage scan of the same events imported with
    `pio import`: sorted BiMap codes, event-time order, buy ⇒ 4.0, and the
    keep-last dedup."""
    path = str(tmp_path / "events.jsonl")
    events = _write_events(path)
    memory_storage.meta_apps().insert(App(id=0, name="MyApp1"))
    imported, skipped = file_to_events(path, "MyApp1", storage=memory_storage)
    assert (imported, skipped) == (len(events), 0)
    ref_ds = ref_engine.DataSource(ref_engine.DataSourceParams(appName="MyApp1"))
    ref_td = ref_ds.read_training(RefContext(storage=memory_storage))
    port_ds = port_engine.DataSource(
        port_engine.DataSourceParams(appName="MyApp1"))
    port_td = port_ds.read_training(WorkflowContext(device="cpu",
                                                    events_path=path))
    for name in ("user_idx", "item_idx", "ratings"):
        np.testing.assert_array_equal(getattr(port_td, name),
                                      getattr(ref_td, name))
    assert port_td.user_ids.to_dict() == ref_td.user_ids.to_dict()
    assert port_td.item_ids.to_dict() == ref_td.item_ids.to_dict()
    ref_pd = ref_engine.Preparator().prepare(None, ref_td)
    port_pd = port_engine.Preparator().prepare(None, port_td)
    for name in ("user_idx", "item_idx", "ratings"):
        np.testing.assert_array_equal(getattr(port_pd, name),
                                      getattr(ref_pd, name))


def test_reference_model_served_through_port_deploy(tmp_path):
    """Train the reference template, carry its ALSModel across with
    `convert.als_model_from_arrays`, serve it with the port's `console
    deploy`: every answer equals the reference's `predict`."""
    path = str(tmp_path / "events.jsonl")
    _write_events(path, seed=1)
    port_td = port_engine.DataSource(
        port_engine.DataSourceParams()).read_training(
            WorkflowContext(device="cpu", events_path=path))
    ref_td = ref_engine.TrainingData(
        user_idx=port_td.user_idx, item_idx=port_td.item_idx,
        ratings=port_td.ratings,
        user_ids=ref_engine.BiMap(port_td.user_ids.to_dict()),
        item_ids=ref_engine.BiMap(port_td.item_ids.to_dict()))
    ctx = RefContext(mesh_shape={"data": 1, "model": 1}, seed=3)
    pd = ref_engine.Preparator().prepare(ctx, ref_td)
    algo = ref_engine.ALSAlgorithm(ref_engine.ALSAlgorithmParams(
        rank=6, numIterations=5, lambda_=0.05))
    ref_model = algo.train(ctx, pd)

    model = convert.als_model_from_arrays(
        ref_model.user_factors, ref_model.item_factors,
        ref_model.user_ids.to_dict(), ref_model.item_ids.to_dict(),
        pd.user_idx, pd.item_idx)
    assert isinstance(model, ALSModel)
    model_path = str(tmp_path / "model.pio")
    write_model_file(model_path, EngineInstance(
        id="carried", engine_id="default", engine_variant="default",
        engine_factory=FACTORY, start_time="", end_time=""), [model])
    engine_json = str(tmp_path / "engine.json")
    _variant_json(engine_json, [{"name": "als", "params": {"rank": 6}}],
                  serving={"name": "first"})

    queries = [{"user": f"u{u}", "num": n} for u in range(0, 30, 3)
               for n in (1, 4, 25)]
    queries.append({"user": "nobody", "num": 5})
    with _deployed(engine_json, model_path) as url:
        for q in queries:
            assert _post(url, q) == algo.predict(ref_model, q), q


def test_console_train_then_deploy_on_cpu(tmp_path):
    """`console train --device cpu` end to end on an events file with the
    shipped engine.json (ALS + popularity, weighted serving), then the
    deployed answers equal the in-process engine's."""
    path = str(tmp_path / "events.jsonl")
    events = _write_events(path, seed=2)
    model_path = str(tmp_path / "model.pio")
    rc = console.main(["train", "--engine-json", ENGINE_JSON, "--events",
                       path, "--model-out", model_path, "--device", "cpu"])
    assert rc == 0
    instance, models = read_model_file(model_path)
    assert instance.engine_factory == FACTORY
    als_model, pop_model = models
    assert np.isfinite(als_model.user_factors).all()
    assert als_model.user_factors.shape[1] == 10  # engine.json rank

    variant = read_engine_json(ENGINE_JSON)
    engine = get_engine(variant.engine_factory)
    ep = extract_engine_params(engine, variant)
    seen = {}
    for ev in events:
        if ev["event"] in ("rate", "buy"):
            seen.setdefault(ev["entityId"], set()).add(ev["targetEntityId"])
    als_model.device = "cpu"
    queries = [{"user": f"u{u}", "num": 5} for u in range(0, 30, 2)]
    with _deployed(ENGINE_JSON, model_path) as url:
        for q in queries:
            got = _post(url, q)
            assert got == engine.predict(ep, models, q)
            rec = [s["item"] for s in
                   port_engine.ALSAlgorithm(None).predict(als_model, q)[
                       "itemScores"]]
            assert not set(rec) & seen[q["user"]]
    # the bulk path: > SERVE_HOST_MAX_BATCH users through the device
    # branch equals the per-query host answers
    algo = port_engine.ALSAlgorithm(None)
    many = [{"user": f"u{u % 30}", "num": 4}
            for u in range(ranking.SERVE_HOST_MAX_BATCH + 6)]
    bulk = algo.batch_predict(als_model, many)
    for q, got in zip(many, bulk):
        want = algo.predict(als_model, q)
        assert [s["item"] for s in got["itemScores"]] == \
            [s["item"] for s in want["itemScores"]]


def test_console_train_reports_bad_inputs(tmp_path, capsys):
    rc = console.main(["train", "--engine-json", ENGINE_JSON, "--events",
                       str(tmp_path / "missing.jsonl"), "--model-out",
                       str(tmp_path / "m.pio"), "--device", "cpu"])
    assert rc == 1
    assert "Cannot read input" in capsys.readouterr().err


def test_deploy_refuses_a_model_of_another_engine(tmp_path, capsys):
    model_path = str(tmp_path / "model.pio")
    write_model_file(model_path, EngineInstance(
        id="x", engine_id="default", engine_variant="default",
        engine_factory="some.other.Engine", start_time="", end_time=""), [])
    rc = console.main(["deploy", "--engine-json", ENGINE_JSON, "--model",
                       model_path, "--port", "0", "--device", "cpu"])
    assert rc == 1
    assert "trained by some.other.Engine" in capsys.readouterr().err
