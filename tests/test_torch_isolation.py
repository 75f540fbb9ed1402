"""The port stands alone: it imports neither JAX nor the reference
package, and its entry points never fall back to the CPU quietly."""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "predictionio_tpu")

_BLOCKED_RUN = textwrap.dedent("""
    import importlib.abc, json, os, sys, tempfile, threading, urllib.request

    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import of " + name)
            return None

    before = {{m for m in sys.modules if m.split(".")[0] in BLOCKED}}
    sys.meta_path.insert(0, Block())

    from predictionio_torch.tools import console
    from predictionio_torch.workflow.create_server import PredictionServer

    tmp = tempfile.mkdtemp()
    events = os.path.join(tmp, "events.jsonl")
    with open(events, "w") as f:
        for n in range(120):
            f.write(json.dumps({{
                "event": "rate", "entityType": "user",
                "entityId": "u%d" % (n % 9), "targetEntityType": "item",
                "targetEntityId": "i%d" % (n % 29),
                "properties": {{"rating": 1 + n % 5}},
                "eventTime": "2026-01-01T00:00:%02dZ" % (n % 60)}}) + "\\n")
    engine_json = os.path.join({repo!r}, "predictionio_torch", "templates",
                               "recommendation", "engine.json")
    model = os.path.join(tmp, "model.pio")
    assert console.main(["train", "--engine-json", engine_json, "--events",
                         events, "--model-out", model,
                         "--device", "cpu"]) == 0
    server = PredictionServer(engine_json, model, ip="127.0.0.1", port=0,
                              device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    req = urllib.request.Request(
        "http://127.0.0.1:%d/queries.json" % server.port,
        data=json.dumps({{"user": "u1", "num": 3}}).encode())
    with urllib.request.urlopen(req, timeout=30) as resp:
        answer = json.loads(resp.read())
    server.shutdown()
    server.server_close()
    assert len(answer["itemScores"]) == 3, answer
    out = os.path.join(tmp, "eval.json")
    assert console.main(["eval", "predictionio_torch.templates."
                         "recommendation.evaluation.RecommendationEvaluation",
                         "--events", events, "--out", out,
                         "--device", "cpu"]) == 0
    with open(out) as f:
        assert json.load(f)["status"] == "EVALCOMPLETED"
    queries = os.path.join(tmp, "queries.jsonl")
    with open(queries, "w") as f:
        for n in range(80):
            f.write(json.dumps({{"user": "u%d" % (n % 9), "num": 2}}) + "\\n")
    predictions = os.path.join(tmp, "predictions.jsonl")
    assert console.main(["batchpredict", "--engine-json", engine_json,
                         "--model", model, "--input", queries, "--output",
                         predictions, "--device", "cpu"]) == 0
    with open(predictions) as f:
        assert len(f.readlines()) == 80

    # the storage slice: the event store and model repository, the
    # store tailer, and a fold of the trained model on the CPU
    import predictionio_torch.storage
    from predictionio_torch.ingest.tailer import StoreTailer
    from predictionio_torch.online import foldin
    from predictionio_torch.ops.als import ALSConfig
    from predictionio_torch.workflow.core_workflow import read_model_file

    os.environ["PIO_FS_BASEDIR"] = os.path.join(tmp, "base")
    assert console.main(["app", "new", "MyApp1"]) == 0
    assert console.main(["import", "--appname", "MyApp1", "--input",
                         events]) == 0
    assert console.main(["train", "--engine-json", engine_json,
                         "--device", "cpu"]) == 0
    storage = predictionio_torch.storage.Storage.get()
    pulled = []

    class Pull(StoreTailer):
        def _apply(self, e):
            pulled.append(e)
            return True

    assert Pull(storage).poll_once() == 120

    # the online plane on that store: one poll folds a new rating
    from predictionio_torch.data.datamap import DataMap
    from predictionio_torch.data.events import Event
    from predictionio_torch.online import OnlineConfig

    server = PredictionServer(engine_json, ip="127.0.0.1", port=0,
                              device="cpu", storage=storage,
                              online=OnlineConfig())
    server.online.stop()
    storage.l_events().insert(Event(
        event="rate", entity_type="user", entity_id="fresh",
        target_entity_type="item", target_entity_id="i1",
        properties=DataMap({{"rating": 4.0}})),
        storage.meta_apps().get_by_name("MyApp1").id)
    assert server.online.poll_once() == 1
    assert server.predict({{"user": "fresh", "num": 2}})["itemScores"]
    server.server_close()

    # the similarproduct and ecommerce templates: scaffolded, built and
    # trained with the console on the store, served over HTTP
    assert console.main(["template", "list"]) == 0
    assert console.main(["app", "new", "ShopApp"]) == 0
    shop = os.path.join(tmp, "shop.jsonl")
    with open(shop, "w") as f:
        for n in range(150):
            f.write(json.dumps({{
                "event": "buy" if n % 7 == 0 else "view",
                "entityType": "user", "entityId": "s%d" % (n % 11),
                "targetEntityType": "item",
                "targetEntityId": "p%d" % (n * 7 % 23),
                "eventTime": "2026-01-01T00:01:%02dZ" % (n % 60)}}) + "\\n")
    assert console.main(["import", "--appname", "ShopApp", "--input",
                         shop]) == 0
    for name, query in (("similarproduct", {{"items": ["p1"], "num": 3}}),
                        ("ecommerce", {{"user": "s1", "num": 3}})):
        engine_dir = os.path.join(tmp, name)
        assert console.main(["template", "get", name, engine_dir,
                             "--app-name", "ShopApp"]) == 0
        shop_json = os.path.join(engine_dir, "engine.json")
        assert console.main(["build", "--engine-json", shop_json]) == 0
        assert console.main(["train", "--engine-json", shop_json,
                             "--device", "cpu"]) == 0
        server = PredictionServer(shop_json, ip="127.0.0.1", port=0,
                                  device="cpu", storage=storage)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        req = urllib.request.Request(
            "http://127.0.0.1:%d/queries.json" % server.port,
            data=json.dumps(query).encode())
        with urllib.request.urlopen(req, timeout=30) as resp:
            answer = json.loads(resp.read())
        server.shutdown()
        server.server_close()
        assert len(answer["itemScores"]) == 3, (name, answer)
    storage.close()
    _, (als_model, _popular) = read_model_file(model)
    folded, stats = foldin.fold_model(
        als_model, ALSConfig(rank=10, reg=0.01),
        {{"u1": [("i0", 5.0), ("i3", 1.0)], "new": [("i2", 4.0)]}},
        device="cpu")
    assert (stats.folded_users, stats.new_users) == (2, 1), stats
    assert folded.user_factors.shape[0] == als_model.user_factors.shape[0] + 1

    # the event server: a key made with the console, one event POSTed
    # through group commit and read back
    import io, contextlib
    from predictionio_torch.data.api import EventServer, EventServerConfig

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert console.main(["accesskey", "new", "MyApp1"]) == 0
    key = out.getvalue().split(": ")[-1].strip()
    es = EventServer(EventServerConfig(ip="127.0.0.1", port=0))
    es.start()
    base = "http://127.0.0.1:%d" % es.port
    req = urllib.request.Request(
        base + "/events.json?accessKey=" + key,
        data=json.dumps({{"event": "rate", "entityType": "user",
                          "entityId": "es-u", "targetEntityType": "item",
                          "targetEntityId": "i1",
                          "properties": {{"rating": 3}}}}).encode())
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert resp.status == 201
        eid = json.loads(resp.read())["eventId"]
    with urllib.request.urlopen(
            base + "/events/%s.json?accessKey=%s" % (eid, key),
            timeout=30) as resp:
        assert json.loads(resp.read())["entityId"] == "es-u"
    es.shutdown()
    import torch
    assert not torch.cuda.is_initialized()
    after = {{m for m in sys.modules if m.split(".")[0] in BLOCKED}}
    assert after == before, sorted(after - before)
    print("ISOLATED-OK")
""")


def test_train_and_serve_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("PIO_TORCH_DEVICE", None)
    proc = subprocess.run(
        [sys.executable, "-c",
         _BLOCKED_RUN.format(blocked=BLOCKED, repo=REPO)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED-OK" in proc.stdout


_SERVING_RUN = textwrap.dedent("""
    import importlib.abc, sys, threading

    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import of " + name)
            return None

    before = {{m for m in sys.modules if m.split(".")[0] in BLOCKED}}
    sys.meta_path.insert(0, Block())

    from predictionio_torch.ingest.invalidation import BUS
    from predictionio_torch.serving import (
        AdmissionConfig, ServingConfig, ServingPlane, ShedLoad)
    from predictionio_torch.serving.result_cache import ResultCache
    from predictionio_torch.utils import fastjson

    plane = ServingPlane(lambda qs: [{{"q": q}} for q in qs],
                         result_cache=ResultCache(), variant="v")
    out = [None] * 8
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, plane.handle_query({{"user": str(i)}}, {{}}))) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert out == [({{"q": {{"user": str(i)}}}}, False) for i in range(8)]
    assert len(plane.result_cache) == 8
    BUS.publish(["3"], variant="v")
    assert len(plane.result_cache) == 7
    plane.close()
    assert not BUS.has_subscribers
    shed = ServingPlane(lambda qs: qs, degraded_fn=lambda q: "popular",
                        config=ServingConfig(
                            admission=AdmissionConfig(max_queue=0)))
    assert shed.handle_query("q") == ("popular", True)
    shed.close()
    assert fastjson.loads(fastjson.dumps_bytes({{"a": [1.5]}})) == {{"a": [1.5]}}
    after = {{m for m in sys.modules if m.split(".")[0] in BLOCKED}}
    assert after == before, sorted(after - before)
    print("SERVING-ISOLATED-OK")
""")


def test_serving_plane_with_jax_and_reference_blocked():
    """The serving plane and the port's JSON codec import neither JAX nor
    the reference, and serve batched, cached and degraded answers."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _SERVING_RUN.format(blocked=BLOCKED)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SERVING-ISOLATED-OK" in proc.stdout


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO,
                                                   "predictionio_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_no_port_file_imports_jax_or_the_reference():
    offenders = []
    files = _port_files()
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "attr", "") == "import_module"
                  and node.args and isinstance(node.args[0], ast.Constant)):
                names = [str(node.args[0].value)]
            else:
                continue
            offenders += [f"{os.path.relpath(path, REPO)}: {n}"
                          for n in names if n.split(".")[0] in BLOCKED]
    assert not offenders, offenders


@pytest.fixture()
def no_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    monkeypatch.delenv("PIO_TORCH_DEVICE", raising=False)


def test_entry_points_without_a_device_raise(no_cuda):
    from predictionio_torch.controller import WorkflowContext
    from predictionio_torch.ops import als, ranking

    ui = np.arange(20, dtype=np.int32) % 4
    ii = np.arange(20, dtype=np.int32) % 5
    r = np.ones(20, np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        als.als_train(ui, ii, r, 4, 5, als.ALSConfig(rank=2, iterations=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        WorkflowContext()
    f = np.ones((80, 2), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ranking.recommend_topk(f, f, np.arange(80, dtype=np.int32), 3)
    from predictionio_torch.ops import basket

    for max_dense_items in (8192, 1):  # the dense path and the host's
        with pytest.raises(RuntimeError, match="device='cpu'"):
            basket.mine_rules(ui, ii, 4, 5, max_dense_items=max_dense_items)
    # a sessionrec model that names no device scores on CUDA by default
    from predictionio_torch import convert
    from predictionio_torch.templates.sessionrec import engine as sessionrec

    model = convert.session_model_from_arrays(
        sessionrec.init_params(5, 4, 1, 8, np.random.default_rng(0)),
        {f"i{j}": j for j in range(5)}, {"u": ("i1", "i2")}, 8, 2)
    algo = sessionrec.SessionRecAlgorithm(sessionrec.SessionRecParams())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        algo.predict(model, {"user": "u", "num": 2})


def test_console_without_a_device_fails(no_cuda, tmp_path, capsys):
    from predictionio_torch.tools import console

    events = tmp_path / "events.jsonl"
    events.write_text('{"event": "rate", "entityType": "user", "entityId": '
                      '"u", "targetEntityType": "item", "targetEntityId": '
                      '"i", "properties": {"rating": 3}}\n')
    engine_json = os.path.join(REPO, "predictionio_torch", "templates",
                               "recommendation", "engine.json")
    rc = console.main(["train", "--engine-json", engine_json, "--events",
                       str(events), "--model-out", str(tmp_path / "m.pio")])
    assert rc == 1
    assert "CUDA" in capsys.readouterr().err
    assert not (tmp_path / "m.pio").exists()


def test_env_selects_the_cpu(monkeypatch):
    from predictionio_torch.device import resolve_device

    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")
    assert resolve_device().type == "cpu"
    assert resolve_device("cpu").type == "cpu"


def test_context_generator_is_seeded_on_its_device():
    from predictionio_torch.controller import WorkflowContext

    ctx = WorkflowContext(device="cpu", seed=5)
    a = torch.randn(4, generator=ctx.generator())
    assert torch.equal(a, torch.randn(4, generator=ctx.generator()))
    assert not torch.equal(a, torch.randn(4, generator=ctx.generator(1)))
    assert ctx.generator().device.type == "cpu"


def test_tf32_is_off():
    import predictionio_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("name", ["similarproduct", "ecommerce",
                                  "productranking", "classification",
                                  "leadscoring", "complementarypurchase",
                                  "sessionrec"])
def test_new_templates_console_without_a_device_fails(name, no_cuda,
                                                      tmp_path, monkeypatch,
                                                      capsys):
    """`console train` and `console deploy` of a scaffolded template
    refuse to run on a machine without CUDA unless asked for the CPU."""
    from predictionio_torch.storage.registry import Storage
    from predictionio_torch.tools import console

    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    Storage.reset(None)
    try:
        assert console.main(["template", "get", name, str(tmp_path / name),
                             "--app-name", "A"]) == 0
        engine_json = str(tmp_path / name / "engine.json")
        assert console.main(["build", "--engine-json", engine_json]) == 0
        capsys.readouterr()
        assert console.main(["train", "--engine-json", engine_json]) == 1
        assert "CUDA" in capsys.readouterr().err
        assert console.main(["deploy", "--engine-json", engine_json,
                             "--port", "0"]) == 1
        assert "CUDA" in capsys.readouterr().err
    finally:
        Storage.reset(None)


_NATIVE_RUN = textwrap.dedent("""
    import importlib.abc, json, os, sys, tempfile

    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import of " + name)
            return None

    before = {{m for m in sys.modules if m.split(".")[0] in BLOCKED}}
    sys.meta_path.insert(0, Block())

    from predictionio_torch import native
    from predictionio_torch.data.store import EventStore
    from predictionio_torch.storage.registry import Storage
    from predictionio_torch.tools import console

    answered = {{}}
    for name in ("import_events_native", "columnar_scan_native",
                 "agg_props_native", "export_events_native"):
        def spy(*a, _real=getattr(native, name), _name=name, **k):
            out = _real(*a, **k)
            answered.setdefault(_name, []).append(out is not None)
            return out
        setattr(native, name, spy)

    tmp = tempfile.mkdtemp()
    os.environ["PIO_FS_BASEDIR"] = tmp
    events = os.path.join(tmp, "events.jsonl")
    with open(events, "w") as f:
        for n in range(200):
            f.write(json.dumps({{
                "event": "rate", "entityType": "user",
                "entityId": "u%d" % (n % 9), "targetEntityType": "item",
                "targetEntityId": "i%d" % (n % 29),
                "properties": {{"rating": 1 + n % 5}},
                "eventTime": "2026-01-01T00:00:%02dZ" % (n % 60)}}) + "\\n")
        f.write(json.dumps({{"event": "$set", "entityType": "item",
                             "entityId": "i1",
                             "properties": {{"categories": ["a", "b"]}}}})
                + "\\n")
    assert console.main(["app", "new", "NativeApp"]) == 0
    assert console.main(["import", "--appname", "NativeApp", "--input",
                         events]) == 0
    assert console.main(["export", "--appname", "NativeApp", "--output",
                         os.path.join(tmp, "out.jsonl")]) == 0
    storage = Storage.get()
    store = EventStore(storage)
    cols = store.find_columnar("NativeApp", value_key="rating",
                               ordered=False)
    assert len(cols) == 200 and len(cols.entity_bimap) == 9
    props = store.aggregate_properties("NativeApp", "item")
    assert props["i1"].to_dict() == {{"categories": ["a", "b"]}}
    storage.close()
    assert answered == {{"import_events_native": [True],
                         "export_events_native": [True],
                         "columnar_scan_native": [True],
                         "agg_props_native": [True]}}, answered
    assert native.native_status() == "available (loaded)"
    after = {{m for m in sys.modules if m.split(".")[0] in BLOCKED}}
    assert after == before, sorted(after - before)
    print("NATIVE-ISOLATED-OK")
""")


def test_native_tier_with_jax_and_reference_blocked():
    """The native package builds and its import, export, columnar scan
    and property fold answer (none falls back) with JAX and the
    reference blocked."""
    from predictionio_torch import native

    if not native.native_available():
        pytest.skip("no C++ toolchain (g++) to build the native library")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("PIO_NATIVE", None)
    proc = subprocess.run(
        [sys.executable, "-c", _NATIVE_RUN.format(blocked=BLOCKED)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NATIVE-ISOLATED-OK" in proc.stdout


_RUNTIME_RUN = textwrap.dedent("""
    import importlib.abc, json, os, sys, tempfile

    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import of " + name)
            return None

    before = {{m for m in sys.modules if m.split(".")[0] in BLOCKED}}
    sys.meta_path.insert(0, Block())

    from predictionio_torch.controller import WorkflowContext
    from predictionio_torch.tools import console
    from predictionio_torch.workflow.fake import run_fake_workflow
    from predictionio_torch.workflow.segmented import segmented_train

    tmp = tempfile.mkdtemp()
    os.environ["PIO_FS_BASEDIR"] = os.path.join(tmp, "base")
    os.environ["PIO_BUCKET_CACHE"] = "1"
    events = os.path.join(tmp, "events.jsonl")
    with open(events, "w") as f:
        for n in range(300):
            f.write(json.dumps({{
                "event": "rate", "entityType": "user",
                "entityId": "u%d" % (n % 13), "targetEntityType": "item",
                "targetEntityId": "i%d" % (n * 7 % 31),
                "properties": {{"rating": 1 + n % 5}},
                "eventTime": "2026-01-01T00:%02d:%02dZ" % (n // 60, n % 60)
            }}) + "\\n")
    engine_json = os.path.join({repo!r}, "predictionio_torch", "templates",
                               "recommendation", "engine.json")
    train = ["train", "--engine-json", engine_json, "--events", events,
             "--device", "cpu", "--model-out", os.path.join(tmp, "m.pio"),
             "--checkpoint-dir", os.path.join(tmp, "ckpt"),
             "--metrics-file", os.path.join(tmp, "metrics.jsonl")]
    os.environ["PIO_FAULTS"] = "als.epoch_boundary:3=error"
    assert console.main(train) == 1
    os.environ["PIO_FAULTS"] = ""
    assert sorted(os.listdir(os.path.join(tmp, "ckpt", "als"))) == [
        "step_1", "step_2"]
    assert console.main(train + ["--check-asserts", "--profile-dir",
                                 os.path.join(tmp, "prof")]) == 0
    assert os.path.exists(os.path.join(tmp, "prof", "trace.json"))
    assert sorted(os.listdir(os.path.join(tmp, "base", "cache", "als")))
    assert console.main(["eval", "predictionio_torch.templates."
                         "recommendation.evaluation.RecommendationEvaluation",
                         "--events", events, "--device", "cpu"]) == 0
    assert console.main(["app", "new", "MyApp1"]) == 0
    assert run_fake_workflow(lambda ctx: 7,
                             WorkflowContext(device="cpu")) == 7
    state, hist, start = segmented_train(
        total_steps=4, init_state=lambda: 0,
        run_chunk=lambda s, n, d: (s + n, [float(d + k) for k in range(n)]),
        state_to_host=lambda s: {{"s": s}},
        state_from_host=lambda t: int(t["s"]), fingerprint="f",
        checkpoint_dir=os.path.join(tmp, "seg"), checkpoint_every=3)
    assert (state, hist, start) == (4, [0.0, 1.0, 2.0, 3.0], 0)
    import torch
    assert not torch.cuda.is_initialized()
    after = {{m for m in sys.modules if m.split(".")[0] in BLOCKED}}
    assert after == before, sorted(after - before)
    print("RUNTIME-ISOLATED-OK")
""")


def test_train_runtime_with_jax_and_reference_blocked():
    """The train runtime (`--checkpoint-dir` killed and resumed, the bucket
    cache, `--metrics-file`, `--profile-dir`, `--check-asserts`, the eval
    grid, `run_fake_workflow`, `segmented_train`) imports neither JAX nor
    the reference."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("PIO_TORCH_DEVICE", None)
    proc = subprocess.run(
        [sys.executable, "-c",
         _RUNTIME_RUN.format(blocked=BLOCKED, repo=REPO)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RUNTIME-ISOLATED-OK" in proc.stdout


_CLASSIFY_RUN = textwrap.dedent("""
    import importlib.abc, json, os, sys, tempfile, threading, urllib.request

    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import of " + name)
            return None

    before = {{m for m in sys.modules if m.split(".")[0] in BLOCKED}}
    sys.meta_path.insert(0, Block())

    from predictionio_torch.storage.registry import Storage
    from predictionio_torch.tools import console
    from predictionio_torch.workflow.create_server import PredictionServer

    tmp = tempfile.mkdtemp()
    os.environ["PIO_FS_BASEDIR"] = os.path.join(tmp, "base")
    events = os.path.join(tmp, "events.jsonl")
    with open(events, "w") as f:
        for n in range(60):
            c = n % 3
            attrs = [4.0 * (c == j) + (n * 7 + j) % 2 for j in range(3)]
            f.write(json.dumps({{
                "event": "$set", "entityType": "user",
                "entityId": "c%d" % n, "properties": {{
                    "attr0": attrs[0], "attr1": attrs[1],
                    "attr2": attrs[2], "plan": float(c)}}}}) + "\\n")
        for n in range(90):
            props = {{"sessionId": "s%d" % n,
                      "landingPageId": "promo" if n % 2 else "home",
                      "referrerId": "r%d" % (n % 3), "browser": "Chrome"}}
            f.write(json.dumps({{"event": "view", "entityType": "user",
                                 "entityId": "v%d" % n,
                                 "properties": props}}) + "\\n")
            if n % 2 and n % 5:
                f.write(json.dumps({{
                    "event": "buy", "entityType": "user",
                    "entityId": "v%d" % n, "targetEntityType": "item",
                    "targetEntityId": "i1",
                    "properties": {{"sessionId": "s%d" % n}}}}) + "\\n")
    assert console.main(["app", "new", "MyApp1"]) == 0
    assert console.main(["import", "--appname", "MyApp1", "--input",
                         events]) == 0
    answers = {{}}
    for name, query, extra in (
            ("classification", {{"attr0": 4.0, "attr1": 0.0,
                                 "attr2": 0.0}}, []),
            ("leadscoring", {{"landingPageId": "promo", "referrerId": "r1",
                              "browser": "Chrome"}},
             ["--checkpoint-dir", os.path.join(tmp, "ckpt")])):
        engine_dir = os.path.join(tmp, name)
        assert console.main(["template", "get", name, engine_dir,
                             "--app-name", "MyApp1"]) == 0
        engine_json = os.path.join(engine_dir, "engine.json")
        assert console.main(["build", "--engine-json", engine_json]) == 0
        assert console.main(["train", "--engine-json", engine_json,
                             "--device", "cpu", *extra]) == 0
        server = PredictionServer(engine_json, ip="127.0.0.1", port=0,
                                  device="cpu", storage=Storage.get())
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        req = urllib.request.Request(
            "http://127.0.0.1:%d/queries.json" % server.port,
            data=json.dumps(query).encode())
        with urllib.request.urlopen(req, timeout=30) as resp:
            answers[name] = json.loads(resp.read())
        server.shutdown()
        server.server_close()
    assert answers["classification"] == {{"label": 0.0}}, answers
    assert 0.5 < answers["leadscoring"]["score"] <= 1.0, answers
    assert sorted(os.listdir(os.path.join(tmp, "ckpt", "lr"))) == [
        "step_240", "step_270", "step_300"]
    os.environ["PIO_EVAL_APP_NAME"] = "MyApp1"
    assert console.main(["eval", "predictionio_torch.templates."
                         "leadscoring.evaluation.LeadScoringEvaluation",
                         "--device", "cpu"]) == 0
    Storage.get().close()
    import torch
    assert not torch.cuda.is_initialized()
    after = {{m for m in sys.modules if m.split(".")[0] in BLOCKED}}
    assert after == before, sorted(after - before)
    print("CLASSIFY-ISOLATED-OK")
""")


def test_classify_templates_with_jax_and_reference_blocked():
    """The classification and leadscoring templates, scaffolded, built,
    trained (leadscoring with `--checkpoint-dir`) from a store, served
    over HTTP and evaluated (AUC), import neither JAX nor the
    reference."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("PIO_TORCH_DEVICE", None)
    proc = subprocess.run(
        [sys.executable, "-c", _CLASSIFY_RUN.format(blocked=BLOCKED)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CLASSIFY-ISOLATED-OK" in proc.stdout


_TEXT_RUN = textwrap.dedent("""
    import importlib.abc, json, os, sys, tempfile, threading, urllib.request

    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import of " + name)
            return None

    before = {{m for m in sys.modules if m.split(".")[0] in BLOCKED}}
    sys.meta_path.insert(0, Block())

    from predictionio_torch.ops import text
    from predictionio_torch.storage.registry import Storage
    from predictionio_torch.tools import console
    from predictionio_torch.workflow.create_server import PredictionServer

    tmp = tempfile.mkdtemp()
    os.environ["PIO_FS_BASEDIR"] = os.path.join(tmp, "base")
    words = {{"spam": ["cheap", "pills", "win", "money", "offer", "deal"],
              "ham": ["meeting", "report", "team", "review", "lunch",
                      "quarterly"]}}
    events = os.path.join(tmp, "events.jsonl")
    with open(events, "w") as f:
        for n in range(40):
            cat = "spam" if n % 2 else "ham"
            tokens = [words[cat][(n * 7 + j * 3) % 6] for j in range(6)]
            f.write(json.dumps({{
                "event": "$set", "entityType": "content",
                "entityId": "doc%d" % n, "properties": {{
                    "text": "The " + " ".join(tokens) + ".",
                    "category": cat}}}}) + "\\n")
    assert console.main(["app", "new", "MyApp1"]) == 0
    assert console.main(["import", "--appname", "MyApp1", "--input",
                         events]) == 0
    engine_dir = os.path.join(tmp, "text")
    assert console.main(["template", "get", "textclassification",
                         engine_dir, "--app-name", "MyApp1"]) == 0
    engine_json = os.path.join(engine_dir, "engine.json")
    assert console.main(["build", "--engine-json", engine_json]) == 0
    assert console.main(["train", "--engine-json", engine_json,
                         "--device", "cpu"]) == 0
    with open(engine_json) as f:
        variant = json.load(f)
    variant["id"] = "text-w2v"
    variant["algorithms"] = [{{"name": "word2vec", "params": {{
        "dim": 8, "window": 2, "steps": 40, "batchSize": 64,
        "iterations": 40, "stepSize": 0.3}}}}]
    w2v_json = os.path.join(engine_dir, "engine-w2v.json")
    with open(w2v_json, "w") as f:
        json.dump(variant, f)
    assert console.main(["train", "--engine-json", w2v_json, "--device",
                         "cpu", "--checkpoint-dir",
                         os.path.join(tmp, "ckpt")]) == 0
    assert text.sampler_calls["sgns"] == 40
    assert sorted(os.listdir(os.path.join(tmp, "ckpt", "w2v"))) == [
        "step_32", "step_36", "step_40"]
    answers = []
    for path in (engine_json, w2v_json):
        server = PredictionServer(path, ip="127.0.0.1", port=0,
                                  device="cpu", storage=Storage.get())
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        req = urllib.request.Request(
            "http://127.0.0.1:%d/queries.json" % server.port,
            data=json.dumps({{"text": "cheap pills offer"}}).encode())
        with urllib.request.urlopen(req, timeout=30) as resp:
            answers.append(json.loads(resp.read()))
        server.shutdown()
        server.server_close()
    assert [a["category"] for a in answers] == ["spam", "spam"], answers
    Storage.get().close()
    import torch
    assert not torch.cuda.is_initialized()
    after = {{m for m in sys.modules if m.split(".")[0] in BLOCKED}}
    assert after == before, sorted(after - before)
    print("TEXT-ISOLATED-OK")
""")


def test_text_template_with_jax_and_reference_blocked():
    """The text template, scaffolded, built, trained from a store (NB,
    and the Word2Vec variant with `--checkpoint-dir`) and served over
    HTTP, imports neither JAX nor the reference."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("PIO_TORCH_DEVICE", None)
    proc = subprocess.run(
        [sys.executable, "-c", _TEXT_RUN.format(blocked=BLOCKED)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "TEXT-ISOLATED-OK" in proc.stdout


_BASKET_RUN = textwrap.dedent("""
    import importlib.abc, json, os, sys, tempfile, threading, urllib.request

    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import of " + name)
            return None

    before = {{m for m in sys.modules if m.split(".")[0] in BLOCKED}}
    sys.meta_path.insert(0, Block())

    import numpy as np
    from predictionio_torch.ops import basket
    from predictionio_torch.storage.registry import Storage
    from predictionio_torch.tools import console
    from predictionio_torch.workflow.create_server import PredictionServer

    b = np.repeat(np.arange(300), 2)
    i = np.tile([0, 1], 300)
    assert basket.cooccurrence_matrix(b, i, 300, 2, device="cpu")[0, 1] == 300
    tmp = tempfile.mkdtemp()
    os.environ["PIO_FS_BASEDIR"] = os.path.join(tmp, "base")
    events = os.path.join(tmp, "events.jsonl")
    with open(events, "w") as f:
        for u in range(30):
            for n, item in enumerate(["bread", "butter"] + (
                    ["jam"] if u % 3 == 0 else [])):
                f.write(json.dumps({{
                    "event": "buy", "entityType": "user",
                    "entityId": "u%d" % u, "targetEntityType": "item",
                    "targetEntityId": item,
                    "eventTime": "2026-02-01T%02d:%02d:00.000Z" % (
                        u % 24, n)}}) + "\\n")
    assert console.main(["app", "new", "MyApp1"]) == 0
    assert console.main(["import", "--appname", "MyApp1", "--input",
                         events]) == 0
    engine_dir = os.path.join(tmp, "cp")
    assert console.main(["template", "get", "complementarypurchase",
                         engine_dir, "--app-name", "MyApp1"]) == 0
    engine_json = os.path.join(engine_dir, "engine.json")
    assert console.main(["build", "--engine-json", engine_json]) == 0
    assert console.main(["train", "--engine-json", engine_json,
                         "--device", "cpu"]) == 0
    server = PredictionServer(engine_json, ip="127.0.0.1", port=0,
                              device="cpu", storage=Storage.get())
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    req = urllib.request.Request(
        "http://127.0.0.1:%d/queries.json" % server.port,
        data=json.dumps({{"items": ["bread"], "num": 2}}).encode())
    with urllib.request.urlopen(req, timeout=30) as resp:
        answer = json.loads(resp.read())
    server.shutdown()
    server.server_close()
    assert answer["rules"][0]["itemScores"][0]["item"] == "butter", answer
    Storage.get().close()
    import torch
    assert not torch.cuda.is_initialized()
    after = {{m for m in sys.modules if m.split(".")[0] in BLOCKED}}
    assert after == before, sorted(after - before)
    print("BASKET-ISOLATED-OK")
""")


def test_basket_template_with_jax_and_reference_blocked():
    """The basket ops and the complementarypurchase template, scaffolded,
    built, trained from a store and served over HTTP, import neither JAX
    nor the reference."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("PIO_TORCH_DEVICE", None)
    proc = subprocess.run(
        [sys.executable, "-c", _BASKET_RUN.format(blocked=BLOCKED)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BASKET-ISOLATED-OK" in proc.stdout


_SESSIONREC_RUN = textwrap.dedent("""
    import importlib.abc, json, os, sys, tempfile, threading, urllib.request

    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import of " + name)
            return None

    before = {{m for m in sys.modules if m.split(".")[0] in BLOCKED}}
    sys.meta_path.insert(0, Block())

    from predictionio_torch.ops import attention, session
    from predictionio_torch.storage.registry import Storage
    from predictionio_torch.tools import console
    from predictionio_torch.workflow.create_server import PredictionServer

    tmp = tempfile.mkdtemp()
    os.environ["PIO_FS_BASEDIR"] = os.path.join(tmp, "base")
    events = os.path.join(tmp, "events.jsonl")
    with open(events, "w") as f:
        for u in range(20):
            for k in range(5):
                f.write(json.dumps({{
                    "event": "view", "entityType": "user",
                    "entityId": "u%d" % u, "targetEntityType": "item",
                    "targetEntityId": "i%d" % ((u + k) % 9),
                    "eventTime": "2026-03-01T%02d:%02d:00.000Z" % (
                        u, k)}}) + "\\n")
    assert console.main(["app", "new", "MyApp1"]) == 0
    assert console.main(["import", "--appname", "MyApp1", "--input",
                         events]) == 0
    engine_dir = os.path.join(tmp, "sess")
    assert console.main(["template", "get", "sessionrec", engine_dir,
                         "--app-name", "MyApp1"]) == 0
    engine_json = os.path.join(engine_dir, "engine.json")
    assert console.main(["build", "--engine-json", engine_json]) == 0
    assert console.main(["train", "--engine-json", engine_json,
                         "--device", "cpu"]) == 0
    server = PredictionServer(engine_json, ip="127.0.0.1", port=0,
                              device="cpu", storage=Storage.get())
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    answers = []
    for query in ({{"user": "u3", "num": 3}}, {{"items": ["i1", "i2"],
                                               "num": 3}}):
        req = urllib.request.Request(
            "http://127.0.0.1:%d/queries.json" % server.port,
            data=json.dumps(query).encode())
        with urllib.request.urlopen(req, timeout=30) as resp:
            answers.append(json.loads(resp.read()))
    server.shutdown()
    server.server_close()
    assert all(len(a["itemScores"]) == 3 for a in answers), answers
    assert session.launches == {{"session_encode": 0, "session_readout": 0}}
    Storage.get().close()
    import torch
    assert not torch.cuda.is_initialized()
    after = {{m for m in sys.modules if m.split(".")[0] in BLOCKED}}
    assert after == before, sorted(after - before)
    print("SESSIONREC-ISOLATED-OK")
""")


def test_sessionrec_template_with_jax_and_reference_blocked():
    """The attention op and the sessionrec template, scaffolded, built,
    trained from a store and served over HTTP (both query forms), import
    neither JAX nor the reference."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("PIO_TORCH_DEVICE", None)
    proc = subprocess.run(
        [sys.executable, "-c", _SESSIONREC_RUN.format(blocked=BLOCKED)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SESSIONREC-ISOLATED-OK" in proc.stdout


_SESSION_FOLD_PARITY_RUN = textwrap.dedent("""
    import importlib.abc, sys
    from datetime import datetime, timezone

    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import of " + name)
            return None

    before = {{m for m in sys.modules if m.split(".")[0] in BLOCKED}}
    sys.meta_path.insert(0, Block())

    import numpy as np
    from predictionio_torch import convert
    from predictionio_torch.online.session import SessionFold
    from predictionio_torch.quality.__main__ import main
    from predictionio_torch.quality.parity import run_parity
    from predictionio_torch.templates.sessionrec.engine import init_params

    params = init_params(6, 4, 1, 8, np.random.default_rng(0))
    model = convert.session_model_from_arrays(
        params, {{"i%d" % k: k for k in range(6)}}, {{"u0": ("i1",)}}, 8, 2)
    t = datetime(2026, 1, 1, tzinfo=timezone.utc)
    folded, stats = SessionFold(8).fold(
        model, {{"u1": [("i2", 1.0, t), ("cold", 1.0, t)]}})
    assert folded.user_windows == {{"u0": ("i1",), "u1": ("i2",)}}
    assert stats.folded_users == 1 and stats.new_items == 1
    out = run_parity("explicit", "100k", rank=4, iterations=1, device="cpu")
    assert out["ours"]["device"] == "cpu" and out["ref"]["rmse"] > 0
    after = {{m for m in sys.modules if m.split(".")[0] in BLOCKED}}
    assert after == before, sorted(after - before)
    print("SESSION-FOLD-PARITY-ISOLATED-OK")
""")


def test_session_fold_and_parity_with_jax_and_reference_blocked():
    """The online session fold and the quality-parity harness import
    neither JAX nor the reference, and fold and score on the CPU."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("PIO_TORCH_DEVICE", None)
    proc = subprocess.run(
        [sys.executable, "-c",
         _SESSION_FOLD_PARITY_RUN.format(blocked=BLOCKED)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SESSION-FOLD-PARITY-ISOLATED-OK" in proc.stdout
