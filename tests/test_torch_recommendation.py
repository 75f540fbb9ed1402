"""The port's Recommendation slice as a whole, on the CPU: events file or
event store → DataSource → Preparator → ALS → model file or model
repository → `console deploy` → `POST /queries.json`, held against the
reference template."""

import contextlib
import json
import os
import subprocess
import sys
import urllib.request
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from predictionio_tpu.controller import WorkflowContext as RefContext
from predictionio_tpu.storage.base import App
from predictionio_tpu.templates.recommendation import engine as ref_engine
from predictionio_tpu.tools.transfer import file_to_events
from predictionio_torch import convert
from predictionio_torch.controller import WorkflowContext
from predictionio_torch.models.als_model import ALSModel
from predictionio_torch.ops import ranking
from predictionio_torch.storage.base import EngineInstance
from predictionio_torch.templates.recommendation import engine as port_engine
from predictionio_torch.tools import console
from predictionio_torch.workflow.core_workflow import (
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


def _instance(instance_id, factory):
    """A completed engine-instance record of `factory` for a model file."""
    now = datetime.now(timezone.utc)
    return EngineInstance(
        id=instance_id, status="COMPLETED", start_time=now, end_time=now,
        engine_id="default", engine_version="1", engine_variant="default",
        engine_factory=factory)


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
    write_model_file(model_path, _instance("carried", FACTORY), [model])
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
    write_model_file(model_path, _instance("x", "some.other.Engine"), [])
    rc = console.main(["deploy", "--engine-json", ENGINE_JSON, "--model",
                       model_path, "--port", "0", "--device", "cpu"])
    assert rc == 1
    assert "trained by some.other.Engine" in capsys.readouterr().err


@pytest.fixture()
def store_basedir(tmp_path, monkeypatch):
    """PIO_FS_BASEDIR at a fresh directory, the port's storage singleton
    unset before and after."""
    from predictionio_torch.storage.registry import Storage

    base = tmp_path / "pio_base"
    monkeypatch.setenv("PIO_FS_BASEDIR", str(base))
    Storage.reset(None)
    yield base
    Storage.reset(None)


@contextlib.contextmanager
def _deployed_from_store(engine_json, base):
    """`console deploy` with no model file: the latest completed instance
    of the store under `base`."""
    env = dict(os.environ, PYTHONPATH=REPO, PIO_FS_BASEDIR=str(base))
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_torch.tools.console", "deploy",
         "--engine-json", engine_json, "--ip", "127.0.0.1", "--port", "0",
         "--device", "cpu"],
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


def test_store_path_app_import_train_deploy_on_cpu(tmp_path, store_basedir,
                                                   capsys):
    """`app new` → `import` → `train` → `deploy` through the store (pio.db
    under PIO_FS_BASEDIR): the engine-instance row and the model blob
    land in storage, and the deployed answers equal those of the same
    engine trained from the events file."""
    from predictionio_torch.storage.registry import Storage

    path = str(tmp_path / "events.jsonl")
    events = _write_events(path, seed=4)
    assert console.main(["app", "new", "MyApp1"]) == 0
    assert console.main(["app", "list"]) == 0
    assert console.main(["app", "new", "MyApp1"]) == 1  # name taken
    assert console.main(["import", "--appname", "MyApp1", "--input",
                         path]) == 0
    assert f"Imported {len(events)} events" in capsys.readouterr().out
    assert console.main(["train", "--engine-json", ENGINE_JSON,
                         "--device", "cpu"]) == 0
    instance_id = capsys.readouterr().out.split("ID: ")[-1].strip()
    model_path = str(tmp_path / "model.pio")
    assert console.main(["train", "--engine-json", ENGINE_JSON, "--events",
                         path, "--model-out", model_path,
                         "--device", "cpu"]) == 0
    assert (store_basedir / "pio.db").exists()

    storage = Storage.get()
    try:
        inst = storage.meta_engine_instances().get(instance_id)
        assert inst.status == "COMPLETED"
        assert inst.engine_factory == FACTORY
        assert json.loads(inst.algorithms_params)[0]["name"] == "als"
        blob = storage.model_data_models().get(instance_id)
        assert blob is not None and len(blob.models) > 0
    finally:
        storage.close()
        Storage.reset(None)

    _, file_models = read_model_file(model_path)
    variant = read_engine_json(ENGINE_JSON)
    engine = get_engine(variant.engine_factory)
    ep = extract_engine_params(engine, variant)
    queries = [{"user": f"u{u}", "num": 4} for u in range(0, 30, 3)]
    queries.append({"user": "nobody", "num": 2})
    with _deployed_from_store(ENGINE_JSON, store_basedir) as url:
        status = json.loads(urllib.request.urlopen(url + "/",
                                                   timeout=30).read())
        assert status["engineInstanceId"] == instance_id
        for q in queries:
            assert _post(url, q) == engine.predict(ep, file_models, q), q

    # batchpredict and export against the same store
    q_path, o_path = tmp_path / "q.jsonl", str(tmp_path / "o.jsonl")
    q_path.write_text("\n".join(json.dumps(q) for q in queries) + "\n")
    assert console.main(["batchpredict", "--engine-json", ENGINE_JSON,
                         "--input", str(q_path), "--output", o_path,
                         "--device", "cpu"]) == 0
    with open(o_path) as f:
        got = [json.loads(line)["prediction"] for line in f]
    assert got == engine.predict_batch(ep, file_models, queries)
    out = str(tmp_path / "export.jsonl")
    assert console.main(["export", "--appname", "MyApp1", "--output",
                         out]) == 0
    from predictionio_torch.data.events import parse_time

    with open(out) as f:
        exported = [json.loads(line) for line in f]
    assert sorted(parse_time(e["eventTime"]) for e in exported) == \
        sorted(parse_time(e["eventTime"]) for e in events)


def test_store_path_eval_records_an_instance(tmp_path, store_basedir,
                                             monkeypatch, capsys):
    """`console eval` with no events file reads the app from the store
    and records the evaluation instance there."""
    from predictionio_torch.storage.registry import Storage

    monkeypatch.setenv("PIO_EVAL_K", "2")
    path = str(tmp_path / "events.jsonl")
    _write_events(path, seed=8)
    assert console.main(["app", "new", "MyApp1"]) == 0
    assert console.main(["import", "--appname", "MyApp1", "--input",
                         path]) == 0
    assert console.main(["eval", "predictionio_torch.templates."
                         "recommendation.evaluation.RecommendationEvaluation",
                         "--device", "cpu"]) == 0
    instance_id = capsys.readouterr().out.split("Instance ID: ")[-1].strip()
    storage = Storage.get()
    try:
        (inst,) = storage.meta_evaluation_instances().get_completed()
        assert inst.id == instance_id
        assert inst.evaluator_results.startswith("Metric: MAP@10")
        assert len(json.loads(inst.evaluator_results_json)["results"]) == 4
    finally:
        storage.close()
        Storage.reset(None)


def test_model_blob_lands_on_localfs_and_deploys(tmp_path, monkeypatch):
    """Metadata and events in memory, model blobs on the filesystem (the
    reference's tests/test_localfs_storage.py train → deploy case): the
    train writes `<instance>.model`, the server deploys from it."""
    import threading

    from predictionio_torch.storage.base import App
    from predictionio_torch.storage.registry import Storage, StorageConfig
    from predictionio_torch.tools.transfer import file_to_events
    from predictionio_torch.workflow.core_workflow import CoreWorkflow
    from predictionio_torch.workflow.create_server import PredictionServer

    env = {"PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "LOCALFS",
           "PIO_STORAGE_SOURCES_LOCALFS_TYPE": "localfs",
           "PIO_STORAGE_SOURCES_LOCALFS_PATH": str(tmp_path / "models"),
           "PIO_STORAGE_SOURCES_PIO_DEFAULT_TYPE": "memory"}
    storage = Storage(StorageConfig.from_env(env))
    try:
        path = str(tmp_path / "events.jsonl")
        _write_events(path, seed=5)
        storage.meta_apps().insert(App(id=0, name="MyApp1"))
        file_to_events(path, "MyApp1", storage=storage)
        variant = read_engine_json(ENGINE_JSON)
        engine = get_engine(variant.engine_factory)
        instance = CoreWorkflow.run_train(
            engine, extract_engine_params(engine, variant), variant,
            WorkflowContext(device="cpu", storage=storage))
        blob_file = tmp_path / "models" / f"{instance.id}.model"
        assert blob_file.exists() and blob_file.stat().st_size > 0
        server = PredictionServer(ENGINE_JSON, ip="127.0.0.1", port=0,
                                  device="cpu", storage=storage)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            got = _post(f"http://127.0.0.1:{server.port}",
                        {"user": "u1", "num": 2})
            assert len(got["itemScores"]) == 2
        finally:
            server.shutdown()
            server.server_close()
            thread.join(10)
    finally:
        storage.close()
