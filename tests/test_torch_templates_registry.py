"""The port's template registry, its scaffolding and the console verbs
`template list|get`, `new` and `build` (the reference's
tests/test_templates_registry.py against the port's seven templates), and
the reference's quickstart of the similarproduct and ecommerce templates
(tests/test_quickstart_e2e.py::test_similarproduct_and_ecommerce) through
the port's console on the CPU: `template get` → `app new` → `import` →
`build` → `train` → `deploy --port 0` in a child → `POST /queries.json`,
each answer equal to the in-process model's."""

import contextlib
import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

import predictionio_torch
from predictionio_tpu.templates.registry import (
    BUILTIN_TEMPLATES as REF_TEMPLATES,
)
from predictionio_torch.storage.registry import Storage
from predictionio_torch.templates.registry import (
    BUILTIN_TEMPLATES,
    get_template,
    scaffold,
)
from predictionio_torch.tools import console
from predictionio_torch.workflow.workflow_utils import (
    extract_engine_params,
    get_engine,
    read_engine_json,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("classification", "complementarypurchase", "ecommerce",
         "leadscoring", "productranking", "recommendation", "sessionrec",
         "similarproduct", "textclassification")

torch.set_num_threads(1)


# -- the registry ------------------------------------------------------------

def test_registered_templates_present():
    assert set(BUILTIN_TEMPLATES) == set(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_entry_matches_the_references(name):
    """The same default engine.json body and sample query as the
    reference's entry, and its factory in the port's package."""
    ref, port = REF_TEMPLATES[name], BUILTIN_TEMPLATES[name]
    assert port.engine_json == ref.engine_json
    assert port.sample_query == ref.sample_query
    assert port.engine_factory == ref.engine_factory.replace(
        "predictionio_tpu.", "predictionio_torch.")
    assert "mesh" not in port.description


def test_unknown_template_raises():
    with pytest.raises(KeyError, match="available: classification, "
                                       "complementarypurchase, "
                                       "ecommerce, leadscoring, "
                                       "productranking, recommendation, "
                                       "sessionrec, similarproduct, "
                                       "textclassification"):
        get_template("nope")


@pytest.mark.parametrize("name", NAMES)
def test_scaffold_passes_console_build(name, tmp_path, capsys):
    """Every scaffolded engine.json resolves its factory and extracts its
    params: `console build` passes out of the box."""
    d = scaffold(name, str(tmp_path / name), app_name="ScaffApp")
    engine_json = os.path.join(d, "engine.json")
    assert console.main(["build", "--engine-json", engine_json]) == 0
    assert "is ready for training" in capsys.readouterr().out
    variant = read_engine_json(engine_json)
    assert variant.engine_factory.startswith("predictionio_torch.templates.")
    extract_engine_params(get_engine(variant.engine_factory), variant)
    with open(os.path.join(d, "template.json")) as f:
        meta = json.load(f)
    assert meta["name"] == name
    assert meta["pio"]["version"]["min"] == predictionio_torch.__version__
    with open(os.path.join(d, "README.md")) as f:
        assert "python -m predictionio_torch.tools.console build" in f.read()


def test_scaffold_fills_app_name_everywhere(tmp_path):
    d = scaffold("ecommerce", str(tmp_path / "e"), app_name="Shop")
    with open(os.path.join(d, "engine.json")) as f:
        engine = json.load(f)
    assert engine["datasource"]["params"]["appName"] == "Shop"
    assert engine["algorithms"][0]["params"]["appName"] == "Shop"


def test_scaffold_refuses_overwrite(tmp_path):
    scaffold("recommendation", str(tmp_path))
    with pytest.raises(FileExistsError):
        scaffold("similarproduct", str(tmp_path))


# -- the console verbs -------------------------------------------------------

def test_template_list(capsys):
    assert console.main(["template", "list"]) == 0
    out = capsys.readouterr().out
    assert all(name in out for name in NAMES)


def test_template_get_and_new(tmp_path, capsys):
    assert console.main(["template", "get", "productranking",
                         str(tmp_path / "p"), "--app-name", "A"]) == 0
    out = capsys.readouterr().out
    assert "Engine template 'productranking' created at" in out
    assert ("Edit engine.json, then: python -m "
            "predictionio_torch.tools.console build") in out
    assert os.path.exists(tmp_path / "p" / "engine.json")
    assert console.main(["new", str(tmp_path / "n"),
                         "--template", "similarproduct"]) == 0
    with open(tmp_path / "n" / "engine.json") as f:
        assert "similarproduct" in json.load(f)["engineFactory"]
    assert console.main(["new", str(tmp_path / "r")]) == 0
    with open(tmp_path / "r" / "engine.json") as f:
        assert "recommendation" in json.load(f)["engineFactory"]


def test_template_get_unknown_fails(tmp_path, capsys):
    assert console.main(["template", "get", "nope", str(tmp_path)]) == 1
    assert "Unknown template" in capsys.readouterr().err


def test_template_get_refuses_overwrite(tmp_path, capsys):
    assert console.main(["template", "get", "ecommerce", str(tmp_path)]) == 0
    assert console.main(["template", "get", "ecommerce", str(tmp_path)]) == 1
    assert "refusing to overwrite" in capsys.readouterr().err


@pytest.mark.parametrize("body", [
    "{",  # not JSON
    json.dumps({"id": "x", "engineFactory": "no.such.Factory"}),
    json.dumps({"id": "x", "engineFactory":
                "predictionio_torch.templates.similarproduct."
                "SimilarProductEngine",
                "algorithms": [{"name": "als",
                                "params": {"noSuchParam": 1}}]}),
    json.dumps({"id": "x", "engineFactory":
                "predictionio_torch.templates.ecommerce.ECommerceEngine",
                "algorithms": [{"name": "nope", "params": {}}]}),
])
def test_build_of_a_bad_engine_json_fails(body, tmp_path, capsys):
    path = tmp_path / "engine.json"
    path.write_text(body)
    assert console.main(["build", "--engine-json", str(path)]) == 1
    assert "Engine build failed" in capsys.readouterr().err


def test_build_reads_engine_json_in_the_working_directory(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    scaffold("similarproduct", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    assert console.main(["build"]) == 0
    assert "'similarproduct'" in capsys.readouterr().out
    monkeypatch.chdir(tmp_path.parent)
    assert console.main(["build"]) == 1


# -- the quickstart through the port's console, on the CPU -------------------

def _spread(n_users, n_items, row_fn):
    """The reference quickstart's hash-spread rows: users' item subsets
    overlap without being identical."""
    lines = []
    for u in range(1, n_users + 1):
        for i in range(1, n_items + 1):
            if ((u * 2654435761 + i * 40503) >> 4) % 3 == 0:
                lines.extend(row_fn(u, i))
    return lines


def _shop_rows(u, i):
    rows = [json.dumps({
        "event": "view", "entityType": "user", "entityId": str(u),
        "targetEntityType": "item", "targetEntityId": f"i{i}"})]
    if (u + i) % 4 == 0:
        rows.append(json.dumps({
            "event": "buy", "entityType": "user", "entityId": str(u),
            "targetEntityType": "item", "targetEntityId": f"i{i}"}))
    return rows


@contextlib.contextmanager
def _deployed(cwd, base):
    """`console deploy --port 0` in a child, run from the engine
    directory `cwd` (its engine.json) on the store under `base`."""
    env = dict(os.environ, PYTHONPATH=REPO, PIO_FS_BASEDIR=str(base),
               PIO_TORCH_DEVICE="cpu")
    for knob in ("PIO_HTTP_RESULT_CACHE", "PIO_ONLINE"):
        env.pop(knob, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_torch.tools.console", "deploy",
         "--ip", "127.0.0.1", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=str(cwd), env=env)
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


def _in_process(engine_json):
    """The latest completed instance of `engine_json`'s engine, loaded
    from the store; returns a function answering one query."""
    variant = read_engine_json(engine_json)
    engine = get_engine(variant.engine_factory)
    ep = extract_engine_params(engine, variant)
    storage = Storage.get()
    instance = storage.meta_engine_instances().get_latest_completed(
        variant.id, "1", variant.variant)
    assert instance is not None and instance.status == "COMPLETED"
    models = engine.deserialize_models(
        storage.model_data_models().get(instance.id).models)
    return lambda q: engine.predict(ep, models, q)


def test_similarproduct_and_ecommerce_through_the_console(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    base = tmp_path / "pio_base"
    monkeypatch.setenv("PIO_FS_BASEDIR", str(base))
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")
    Storage.reset(None)
    try:
        assert console.main(["app", "new", "ShopApp"]) == 0
        lines = _spread(12, 18, _shop_rows)
        lines += [json.dumps({"event": "$set", "entityType": "item",
                              "entityId": f"i{i}", "properties": {
                                  "categories": [f"c{i % 3}"]}})
                  for i in range(1, 19)]
        events = tmp_path / "shop.jsonl"
        events.write_text("\n".join(lines) + "\n")
        assert console.main(["import", "--appname", "ShopApp", "--input",
                             str(events)]) == 0

        # -- similarproduct ---------------------------------------------
        sp_dir = tmp_path / "Similar"
        assert console.main(["template", "get", "similarproduct",
                             str(sp_dir), "--app-name", "ShopApp"]) == 0
        sp_json = str(sp_dir / "engine.json")
        assert console.main(["build", "--engine-json", sp_json]) == 0
        assert console.main(["train", "--engine-json", sp_json]) == 0
        similar = _in_process(sp_json)
        queries = [{"items": ["i5"], "num": 3},
                   {"items": ["i2", "i7"], "num": 20},
                   {"items": ["i5"], "num": 5, "categories": ["c1"]},
                   {"items": ["i5"], "num": 5, "whiteList": ["i1", "i2"]},
                   {"items": ["i5"], "num": 5, "blackList": ["i1", "i2"]},
                   {"items": ["nope"], "num": 3}]
        with _deployed(sp_dir, base) as url:
            for q in queries:
                assert _post(url, q) == similar(q), q
            res = _post(url, queries[0])
        assert len(res["itemScores"]) == 3
        assert all(r["item"] != "i5" for r in res["itemScores"])

        # -- ecommerce ---------------------------------------------------
        ec_dir = tmp_path / "Shop"
        assert console.main(["template", "get", "ecommerce", str(ec_dir),
                             "--app-name", "ShopApp"]) == 0
        ec_json = str(ec_dir / "engine.json")
        assert console.main(["build", "--engine-json", ec_json]) == 0
        assert console.main(["train", "--engine-json", ec_json]) == 0
        queries = [{"user": str(u), "num": 4} for u in range(1, 13)]
        queries += [{"user": "3", "num": 6, "categories": ["c2"]},
                     {"user": "ghost", "num": 4}]
        with _deployed(ec_dir, base) as url:
            recommend = _in_process(ec_json)
            for q in queries:
                assert _post(url, q) == recommend(q), q
            res = _post(url, {"user": "3", "num": 4})
            assert res["itemScores"], res
            first = res["itemScores"][0]["item"]
            # the top item made unavailable with a $set on the constraint
            # entity: the deployed lookup drops it once its cache expires
            constraint = tmp_path / "constraint.jsonl"
            constraint.write_text(json.dumps({
                "event": "$set", "entityType": "constraint",
                "entityId": "unavailableItems",
                "properties": {"items": [first]}}) + "\n")
            assert console.main(["import", "--appname", "ShopApp",
                                 "--input", str(constraint)]) == 0
            deadline = time.monotonic() + 30
            while True:
                res2 = _post(url, {"user": "3", "num": 4})
                if all(r["item"] != first for r in res2["itemScores"]) \
                        or time.monotonic() > deadline:
                    break
                time.sleep(0.5)
            assert res2["itemScores"], res2
            assert all(r["item"] != first for r in res2["itemScores"]), res2
            assert res2 == _in_process(ec_json)({"user": "3", "num": 4})
    finally:
        if Storage._instance is not None:
            Storage._instance.close()
        Storage.reset(None)
