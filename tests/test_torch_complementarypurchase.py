"""The port's Complementary Purchase template on the CPU, held against the
reference template: the same seeded `buy` events in a memory store of each
package, and in one sqlite pio.db that the reference writes and both
read, give equal training data, baskets and rules, and every cart query
answers JSON-equal. Then the reference's own cases
(tests/test_complementarypurchase_template.py) run against the port, and
the template goes through the console: `template get`, `build`, `train`
and `deploy` with the CPU asked for."""

import json
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from predictionio_tpu.data.events import Event as RefEvent
from predictionio_tpu.storage.base import App as RefApp
from predictionio_tpu.storage.registry import (
    SourceConfig as RefSourceConfig,
    Storage as RefStorage,
    StorageConfig as RefStorageConfig,
)
from predictionio_tpu.templates.complementarypurchase import (
    engine as ref_engine,
)
from predictionio_tpu.workflow.workflow_utils import (
    EngineVariant as RefEngineVariant,
    extract_engine_params as ref_extract_engine_params,
    get_engine as ref_get_engine,
)
from predictionio_torch.data.events import Event
from predictionio_torch.storage.base import App
from predictionio_torch.storage.registry import (
    SourceConfig,
    Storage,
    StorageConfig,
)
from predictionio_torch.templates.complementarypurchase import (
    engine as port_engine,
)
from predictionio_torch.tools import console
from predictionio_torch.workflow.core_workflow import CoreWorkflow
from predictionio_torch.workflow.workflow_utils import (
    EngineVariant,
    extract_engine_params,
    get_engine,
)
from tests.test_torch_similarproduct import (
    port_ctx,
    port_storage,  # noqa: F401 — a fixture
    ref_ctx,
)
from tests.test_torch_templates_registry import _deployed, _in_process, _post

FACTORY = ("predictionio_torch.templates.complementarypurchase."
           "ComplementaryPurchaseEngine")
APP = "CPApp"
T0 = datetime(2026, 2, 1, tzinfo=timezone.utc)

torch.set_num_threads(1)


def buy_rows(seed=0, n_users=40, n_items=25) -> list:
    """(event, user, item, seconds from T0) rows: each user's 1-4 baskets
    10 000 s apart, a basket's 1-6 Zipf-drawn items 31-899 s apart (some
    bought twice; a 600 s window splits some baskets), and `view`s that
    the DataSource must skip. The gaps are odd seconds, never exactly a
    window: there the reference's store read (julianday, ~20 µs off)
    decides the basket, and the port's exact read keeps one
    (`test_a_gap_of_exactly_the_window_keeps_one_basket`)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_items + 1)
    rows = []
    for u in range(n_users):
        for k in range(int(rng.integers(1, 5))):
            t = k * 10_000 + int(rng.integers(0, 1_000))
            items = rng.choice(n_items, int(rng.integers(1, 7)), p=p / p.sum())
            gaps = np.cumsum(2 * rng.integers(15, 450, len(items)) + 1)
            for item, gap in zip(items, gaps):
                rows.append(("buy", f"u{u}", f"i{item}", t + int(gap)))
            rows.append(("view", f"u{u}", f"i{rng.integers(0, n_items)}",
                         t + 30))
    return rows


def planted_rows() -> list:
    """The reference test's store: bread and butter bought together by
    every user, jam by every third, milk alone in a later basket."""
    rows = []
    for u in range(12):
        rows += [("buy", f"u{u}", "bread", u * 18_000),
                 ("buy", f"u{u}", "butter", u * 18_000 + 300)]
        if u % 3 == 0:
            rows.append(("buy", f"u{u}", "jam", u * 18_000 + 600))
        rows.append(("buy", f"u{u}", "milk", u * 18_000 + 120_000))
    return rows


def insert(storage, rows, port=True, app_name=APP) -> int:
    event_cls, app_cls = (Event, App) if port else (RefEvent, RefApp)
    app_id = storage.meta_apps().insert(app_cls(id=0, name=app_name))
    le = storage.l_events()
    for name, user, item, seconds in rows:
        le.insert(event_cls(
            event=name, entity_type="user", entity_id=user,
            target_entity_type="item", target_entity_id=item,
            event_time=T0 + timedelta(seconds=seconds)), app_id)
    return app_id


def variant_dict(params=None, factory=FACTORY, app=APP, window=3600):
    return {"id": "cp-test", "engineFactory": factory,
            "datasource": {"params": {"appName": app}},
            "preparator": {"params": {"basketWindow": window}},
            "algorithms": [{"name": "association", "params": params or {
                "minSupport": 0.05, "minConfidence": 0.1, "minLift": 1.0,
                "numRulesPerCond": 5}}]}


def engines(params=None, window=3600):
    """((port engine, its params), (reference engine, its params)) of one
    engine.json body."""
    out = []
    for factory, variant_cls, get, extract in (
            (FACTORY, EngineVariant, get_engine, extract_engine_params),
            (FACTORY.replace("predictionio_torch.", "predictionio_tpu."),
             RefEngineVariant, ref_get_engine, ref_extract_engine_params)):
        variant = variant_cls.from_dict(
            variant_dict(params, factory=factory, window=window))
        engine = get(variant.engine_factory)
        out.append((engine, extract(engine, variant)))
    return out


@pytest.fixture(params=["memory", "sqlite"])
def stores(request, tmp_path, monkeypatch, port_storage, memory_storage):
    """(reference storage, port storage) holding the same events: a
    memory store each, or one sqlite pio.db written by the reference and
    opened by both (the port's SQL tier: PIO_NATIVE=0)."""
    rows = buy_rows()
    if request.param == "memory":
        insert(memory_storage, rows, port=False)
        insert(port_storage, rows)
        yield memory_storage, port_storage
        return
    monkeypatch.setenv("PIO_NATIVE", "0")
    path = str(tmp_path / "pio.db")
    ref_src = RefSourceConfig(name="F", type="sqlite", path=path)
    ref_store = RefStorage(RefStorageConfig(metadata=ref_src,
                                            modeldata=ref_src,
                                            eventdata=ref_src))
    insert(ref_store, rows, port=False)
    src = SourceConfig(name="F", type="sqlite", path=path)
    port_store = Storage(StorageConfig(metadata=src, modeldata=src,
                                       eventdata=src))
    yield ref_store, port_store
    port_store.close()
    ref_store.close()


QUERIES = ([{"items": [f"i{j}"], "num": n} for j, n in
            ((0, 3), (1, 10), (2, 1), (5, 4), (9, 2), (24, 5))]
           + [{"items": ["i0", "i3", "i7"], "num": 2},
              {"items": ["i1", "nope"]}, {"items": ["nope"], "num": 3},
              {"items": [], "num": 3}, {"num": 2}])


@pytest.mark.parametrize("params,window", [
    (None, 3600),
    ({"minSupport": 0.0, "minConfidence": 0.0, "minLift": 0.0,
      "numRulesPerCond": 4, "score": "confidence"}, 600),
    ({"minSupport": 0.01, "minLift": 1.0, "numRulesPerCond": 3,
      "maxDenseItems": 1}, 3600),
])
def test_train_and_answers_match_reference(stores, params, window):
    """The same buy columns and baskets, every rule array equal, every
    cart query JSON-equal (dense path; the last case the host fallback)."""
    ref_store, port_store = stores
    (port, port_ep), (ref, ref_ep) = engines(params, window)
    ref_td = ref_engine.DataSource(ref_ep.data_source_params).read_training(
        ref_ctx(ref_store))
    port_td = port_engine.DataSource(
        port_ep.data_source_params).read_training(port_ctx(port_store))
    for name in ("user_idx", "item_idx"):
        np.testing.assert_array_equal(getattr(port_td, name),
                                      getattr(ref_td, name), err_msg=name)
    # the port's SQL tier reads event times exactly (whole seconds here);
    # the reference's goes through julianday, ~20 µs off at these dates
    assert (port_td.times == np.round(port_td.times)).all()
    np.testing.assert_allclose(port_td.times, ref_td.times, rtol=0,
                               atol=1e-4)
    ref_pd = ref_engine.Preparator(ref_ep.preparator_params).prepare(
        None, ref_td)
    port_pd = port_engine.Preparator(port_ep.preparator_params).prepare(
        None, port_td)
    np.testing.assert_array_equal(port_pd.basket_idx, ref_pd.basket_idx)
    np.testing.assert_array_equal(port_pd.item_idx, ref_pd.item_idx)
    assert port_pd.n_baskets == ref_pd.n_baskets > 40
    assert list(port_pd.item_ids.from_index(range(len(port_pd.item_ids)))) \
        == list(ref_pd.item_ids.from_index(range(len(ref_pd.item_ids))))

    port_model = port.train(port_ctx(port_store), port_ep)[0]
    ref_model = ref.train(ref_ctx(ref_store), ref_ep)[0]
    for name in ("cond_items", "cons_items", "scores", "support",
                 "confidence", "lift"):
        np.testing.assert_array_equal(getattr(port_model.rules, name),
                                      getattr(ref_model.rules, name),
                                      err_msg=name)
    answered = 0
    for q in QUERIES:
        got = port.predict(port_ep, [port_model], q)
        assert json.dumps(got) == json.dumps(
            ref.predict(ref_ep, [ref_model], q)), q
        answered += bool(got["rules"])
    assert answered >= 5


def test_a_gap_of_exactly_the_window_keeps_one_basket(port_storage):
    """The port reads event times exactly, so purchases exactly
    basketWindow apart share a basket (`sessionize` splits on a gap >
    the window) and one second more splits them."""
    insert(port_storage, [("buy", "u0", "a", 0), ("buy", "u0", "b", 3600),
                          ("buy", "u1", "a", 0), ("buy", "u1", "b", 3601)])
    (port, port_ep), _ = engines()
    td = port_engine.DataSource(port_ep.data_source_params).read_training(
        port_ctx(port_storage))
    pd = port_engine.Preparator(port_ep.preparator_params).prepare(None, td)
    assert pd.n_baskets == 3


# -- the reference's cases, on the port --------------------------------------

def test_train_and_query(port_storage):
    insert(port_storage, planted_rows())
    variant = EngineVariant.from_dict(variant_dict())
    engine = get_engine(variant.engine_factory)
    ep = extract_engine_params(engine, variant)
    instance = CoreWorkflow.run_train(engine, ep, variant,
                                      port_ctx(port_storage))
    assert instance.status == "COMPLETED"
    blob = port_storage.model_data_models().get(instance.id).models
    models = engine.deserialize_models(blob)
    r = engine.predict(ep, models, {"items": ["bread"], "num": 3})
    rule = r["rules"][0]
    assert rule["cond"] == ["bread"]
    top = rule["itemScores"][0]
    assert top["item"] == "butter"  # every bread basket has butter
    assert top["confidence"] == pytest.approx(1.0)
    assert top["lift"] > 1.0
    assert "milk" not in {s["item"] for s in rule["itemScores"]}


def test_multi_item_cart_and_unknowns(port_storage):
    insert(port_storage, planted_rows())
    (port, port_ep), _ = engines()
    models = port.train(port_ctx(port_storage), port_ep)
    r = port.predict(port_ep, models, {"items": ["bread", "nope", "milk"],
                                       "num": 2})
    conds = [rule["cond"][0] for rule in r["rules"]]
    assert conds == ["bread"]  # no rule for an unknown item, nor for milk
    assert len(r["rules"][0]["itemScores"]) == 2


def test_empty_app_fails_sanity_check(port_storage):
    port_storage.meta_apps().insert(App(id=0, name="EmptyCP"))
    variant = EngineVariant.from_dict(variant_dict(app="EmptyCP"))
    engine = get_engine(variant.engine_factory)
    ep = extract_engine_params(engine, variant)
    with pytest.raises(ValueError, match="no buy events"):
        CoreWorkflow.run_train(engine, ep, variant, port_ctx(port_storage))


def test_through_the_console(tmp_path, monkeypatch):
    """`template get` → `build` → `train` → `deploy`, the CPU asked for
    (`--device cpu` on train, PIO_TORCH_DEVICE for the deploy child):
    every answer over HTTP equals the stored instance's in process."""
    base = tmp_path / "pio_base"
    monkeypatch.setenv("PIO_FS_BASEDIR", str(base))
    monkeypatch.setenv("PIO_NATIVE", "0")
    Storage.reset(None)
    try:
        assert console.main(["app", "new", "CartApp"]) == 0
        events = tmp_path / "buys.jsonl"
        events.write_text("".join(json.dumps({
            "event": name, "entityType": "user", "entityId": user,
            "targetEntityType": "item", "targetEntityId": item,
            "eventTime": (T0 + timedelta(seconds=s)).isoformat()}) + "\n"
            for name, user, item, s in buy_rows(seed=2)))
        assert console.main(["import", "--appname", "CartApp", "--input",
                             str(events)]) == 0
        cp_dir = tmp_path / "Cart"
        assert console.main(["template", "get", "complementarypurchase",
                             str(cp_dir), "--app-name", "CartApp"]) == 0
        cp_json = str(cp_dir / "engine.json")
        assert console.main(["build", "--engine-json", cp_json]) == 0
        assert console.main(["train", "--engine-json", cp_json, "--device",
                             "cpu"]) == 0
        predict = _in_process(cp_json)
        with _deployed(cp_dir, base) as url:
            answers = [(_post(url, q), predict(q)) for q in QUERIES]
        assert all(got == want for got, want in answers), answers
        assert sum(bool(got["rules"]) for got, _ in answers) >= 5
    finally:
        if Storage._instance is not None:
            Storage._instance.close()
        Storage.reset(None)
