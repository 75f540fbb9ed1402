"""The port's event server (`data/api.py`, `data/webhooks.py`,
`utils/routing.py`, the console's `eventserver` / `accesskey` / `app
channel-new`) held to the reference's.

Every scenario of the reference's tests/test_event_server.py and
tests/test_ingest_server.py runs through one fixture parametrised by
implementation, each server on its own memory storage, with the
reference's assertions. On the port's side the same scenario then runs
against a fresh reference server, and the two transcripts (status codes
and JSON bodies, in order) must be equal apart from generated event ids,
`creationTime` (and an `eventTime` that defaulted to it), `pio_lineage`
and `/stats.json`'s `uptime_s`.

Also here: a sqlite file written by either event server read back by
the other package field for field, and the console verbs.
"""

import base64
import contextlib
import http.client
import json
import re
import threading
import time
import urllib.error
import urllib.request
from datetime import timedelta

import pytest

from predictionio_tpu.data import api as ref_api
from predictionio_tpu.ingest import writer as ref_writer
from predictionio_tpu.storage import base as ref_base
from predictionio_tpu.storage import registry as ref_registry
from predictionio_tpu.telemetry.registry import parse_prometheus
from predictionio_tpu.tools import console as ref_console
from predictionio_torch.data import api
from predictionio_torch.ingest import writer
from predictionio_torch.storage import base
from predictionio_torch.storage import registry
from predictionio_torch.tools import console

IMPLS = {
    "reference": (ref_api, ref_writer, ref_base, ref_registry, ref_console),
    "port": (api, writer, base, registry, console),
}

RATE = {"event": "rate", "entityType": "user", "entityId": "u1",
        "targetEntityType": "item", "targetEntityId": "i1",
        "properties": {"rating": 4.5}, "eventTime": "2026-01-01T00:00:00.000Z"}


class _Side:
    """One implementation's event server on its own memory storage, with
    an app, its access key and a channel `ch1`; every call is logged."""

    def __init__(self, impl, app_name="TestApp", ingest_config=None):
        (self.api, self.writer, self.base, registry_mod,
         self.console) = IMPLS[impl]
        self.registry = registry_mod
        src = registry_mod.SourceConfig(name="TEST", type="memory")
        self.storage = registry_mod.Storage(registry_mod.StorageConfig(
            metadata=src, modeldata=src, eventdata=src))
        registry_mod.Storage.reset(self.storage)
        self.app_id = self.storage.meta_apps().insert(
            self.base.App(id=0, name=app_name))
        self.key = self.add_key()
        self.storage.meta_channels().insert(
            self.base.Channel(id=0, name="ch1", app_id=self.app_id))
        if ingest_config is not None:
            ingest_config = self.writer.IngestConfig(**ingest_config)
        self.srv = self.api.EventServer(
            self.api.EventServerConfig(ip="127.0.0.1", port=0, stats=True),
            self.storage, ingest_config=ingest_config)
        self.srv.start()
        self.log = []

    def add_key(self, events=None):
        key = self.base.AccessKey.generate(self.app_id, events=events)
        self.storage.meta_access_keys().insert(key)
        return key.key

    def close(self):
        self.srv.shutdown()
        self.storage.close()
        self.registry.Storage.reset(None)

    @property
    def port(self):
        return self.srv.port

    def call(self, method, path, body=None, headers=None, raw=None):
        """(status, decoded JSON body, headers) of one request on a new
        connection; logged as (method, status, normalised body)."""
        url = f"http://127.0.0.1:{self.port}{path}"
        data = raw if raw is not None else (
            json.dumps(body).encode() if body is not None else None)
        req = urllib.request.Request(
            url, data=data, method=method,
            headers=headers or {"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                out = (resp.status, json.loads(resp.read() or b"null"),
                       resp.headers)
        except urllib.error.HTTPError as e:
            out = (e.code, json.loads(e.read() or b"null"), e.headers)
        self.log.append((method, out[0], _norm(out[1])))
        return out


_GENERATED_ID = re.compile(r"^[0-9a-f]{32}$")


def _norm(x):
    """A body without what differs by run: generated event ids,
    creationTime (and an eventTime that defaulted to it), pio_lineage and
    uptime_s."""
    if isinstance(x, list):
        return [_norm(v) for v in x]
    if not isinstance(x, dict):
        return x
    out = {}
    for k, v in x.items():
        if k in ("pio_lineage", "uptime_s"):
            continue
        if k == "eventId" and isinstance(v, str) and _GENERATED_ID.match(v):
            v = "<generated>"
        elif k == "creationTime" or (k == "eventTime"
                                     and v == x.get("creationTime")):
            v = "<now>"
        out[k] = _norm(v)
    return out


@contextlib.contextmanager
def _side(impl, **kw):
    side = _Side(impl, **kw)
    try:
        yield side
    finally:
        side.close()


@pytest.fixture(params=list(IMPLS))
def es(request):
    """A factory of one implementation's started event server; the
    scenario's transcript on the port is held against the reference's."""
    opened = []

    def make(**kw):
        side = _Side(request.param, **kw)
        opened.append(side)
        return side

    make.impl = request.param
    yield make
    for side in opened:
        side.close()


def _check(es, scenario, **kw):
    """Run `scenario` on `es`'s implementation; on the port, run it on a
    fresh reference server too and compare the two transcripts."""
    side = es(**kw)
    scenario(side)
    got = side.log
    if es.impl == "port":
        with _side("reference", **kw) as ref:
            scenario(ref)
            assert got == ref.log
    return side


# -- tests/test_event_server.py ------------------------------------------------

def sc_alive(s):
    assert s.call("GET", "/")[0] == 200


def sc_post_and_get_roundtrip(s):
    key = s.key
    status, body, _ = s.call("POST", f"/events.json?accessKey={key}", RATE)
    assert status == 201
    eid = body["eventId"]
    status, got, _ = s.call("GET", f"/events/{eid}.json?accessKey={key}")
    assert status == 200
    assert got["event"] == "rate" and got["properties"] == {"rating": 4.5}
    status, events, _ = s.call(
        "GET", f"/events.json?accessKey={key}&event=rate&entityId=u1")
    assert status == 200 and len(events) == 1


def sc_auth_failures(s):
    assert s.call("POST", "/events.json", RATE)[0] == 401
    assert s.call("POST", "/events.json?accessKey=WRONG", RATE)[0] == 401
    assert s.call("GET", "/events.json?accessKey=WRONG")[0] == 401


def sc_validation_rejected(s):
    bad = {"event": "$unset", "entityType": "user", "entityId": "u1"}
    status, body, _ = s.call("POST", f"/events.json?accessKey={s.key}", bad)
    assert status == 400
    assert "properties" in body["message"]
    status, _, _ = s.call("POST", f"/events.json?accessKey={s.key}",
                          {"event": "x", "entityType": "user"})
    assert status == 400


def sc_batch(s):
    batch = [RATE, {"event": "$unset", "entityType": "user",
                    "entityId": "u"}, dict(RATE, entityId="u2")]
    status, results, _ = s.call(
        "POST", f"/batch/events.json?accessKey={s.key}", batch)
    assert status == 200
    assert [r["status"] for r in results] == [201, 400, 201]
    status, _, _ = s.call("POST", f"/batch/events.json?accessKey={s.key}",
                          [RATE] * 51)
    assert status == 400


def sc_batch_duplicate_event_id(s):
    first = dict(RATE, eventId="fixed-id")
    status, [r1], _ = s.call(
        "POST", f"/batch/events.json?accessKey={s.key}", [first])
    assert r1["status"] == 201 and r1["eventId"] == "fixed-id"
    batch = [dict(RATE, entityId="uA"), dict(RATE, eventId="fixed-id"),
             dict(RATE, entityId="uB")]
    status, results, _ = s.call(
        "POST", f"/batch/events.json?accessKey={s.key}", batch)
    assert status == 200
    assert [r["status"] for r in results] == [201, 400, 201]
    assert "duplicate eventId" in results[1]["message"]


def sc_delete(s):
    _, body, _ = s.call("POST", f"/events.json?accessKey={s.key}", RATE)
    eid = body["eventId"]
    path = f"/events/{eid}.json?accessKey={s.key}"
    assert s.call("DELETE", path)[0] == 200
    assert s.call("DELETE", path)[0] == 404
    assert s.call("GET", path)[0] == 404


def sc_channel_scoping(s):
    s.call("POST", f"/events.json?accessKey={s.key}&channel=ch1", RATE)
    _, default_events, _ = s.call("GET", f"/events.json?accessKey={s.key}")
    assert default_events == []
    _, ch_events, _ = s.call(
        "GET", f"/events.json?accessKey={s.key}&channel=ch1")
    assert len(ch_events) == 1
    # unknown channel → auth failure, like the reference
    assert s.call("POST", f"/events.json?accessKey={s.key}&channel=nope",
                  RATE)[0] == 401


def sc_time_range_filter(s):
    for i, t in enumerate(["2026-01-01T00:00:00Z", "2026-01-02T00:00:00Z",
                           "2026-01-03T00:00:00Z"]):
        s.call("POST", f"/events.json?accessKey={s.key}",
               dict(RATE, entityId=f"u{i}", eventTime=t))
    _, events, _ = s.call(
        "GET", f"/events.json?accessKey={s.key}"
        "&startTime=2026-01-02T00:00:00Z&untilTime=2026-01-03T00:00:00Z")
    assert [e["entityId"] for e in events] == ["u1"]
    _, events, _ = s.call(
        "GET", f"/events.json?accessKey={s.key}&reversed=true&limit=1")
    assert events[0]["entityId"] == "u2"


def sc_event_whitelist_key(s):
    limited = s.add_key(events=["view"])
    status, body, _ = s.call("POST", f"/events.json?accessKey={limited}",
                             RATE)
    assert status == 400 and "not allowed" in body["message"]
    ok = dict(RATE, event="view")
    assert s.call("POST", f"/events.json?accessKey={limited}", ok)[0] == 201


def sc_stats(s):
    s.call("POST", f"/events.json?accessKey={s.key}", RATE)
    status, body, _ = s.call("GET", f"/stats.json?accessKey={s.key}")
    assert status == 200
    assert body["counts"] == [{"event": "rate", "status": 201, "count": 1}]


def sc_basic_auth(s):
    """The key in a Basic `Authorization` header instead of the query."""
    token = base64.b64encode(f"{s.key}:".encode()).decode()
    headers = {"Content-Type": "application/json",
               "Authorization": f"Basic {token}"}
    status, body, _ = s.call("POST", "/events.json", RATE, headers=headers)
    assert status == 201
    assert s.call("GET", f"/events/{body['eventId']}.json",
                  headers=headers)[0] == 200
    bad = {"Authorization": "Basic !!!not-base64"}
    assert s.call("GET", "/events.json", headers=bad)[0] == 401


def sc_segmentio(s):
    payload = {"type": "track", "userId": "u42", "event": "Signed Up",
               "properties": {"plan": "pro"},
               "timestamp": "2026-01-01T00:00:00Z"}
    status, body, _ = s.call(
        "POST", f"/webhooks/segmentio.json?accessKey={s.key}", payload)
    assert status == 201
    _, got, _ = s.call(
        "GET", f"/events/{body['eventId']}.json?accessKey={s.key}")
    assert got["event"] == "track" and got["entityId"] == "u42"
    assert got["properties"]["plan"] == "pro"


def sc_segmentio_bad_type(s):
    status, _, _ = s.call(
        "POST", f"/webhooks/segmentio.json?accessKey={s.key}",
        {"type": "bogus", "userId": "u"})
    assert status == 400


def sc_mailchimp_form(s):
    form = ("type=subscribe&fired_at=2026-01-01 00:00:00"
            "&data[id]=abc123&data[email]=a@b.c&data[list_id]=L1")
    status, _, _ = s.call(
        "POST", f"/webhooks/mailchimp.json?accessKey={s.key}",
        raw=form.encode(),
        headers={"Content-Type": "application/x-www-form-urlencoded"})
    assert status == 201
    _, events, _ = s.call(
        "GET", f"/events.json?accessKey={s.key}&event=subscribe")
    assert events[0]["properties"]["email"] == "a@b.c"


def sc_unknown_connector(s):
    assert s.call("POST", f"/webhooks/none.json?accessKey={s.key}",
                  {})[0] == 404


def sc_non_dict_bodies_return_400(s):
    for bad in (42, "x", [1, 2]):
        status, _, _ = s.call("POST", f"/events.json?accessKey={s.key}", bad)
        assert status == 400
    status, results, _ = s.call(
        "POST", f"/batch/events.json?accessKey={s.key}", [RATE, 5])
    assert status == 200
    assert [r["status"] for r in results] == [201, 400]
    status, _, _ = s.call(
        "POST", f"/webhooks/segmentio.json?accessKey={s.key}", [])
    assert status == 400


def sc_duplicate_event_id_returns_400(s):
    with_id = dict(RATE, eventId="fixed-id")
    assert s.call("POST", f"/events.json?accessKey={s.key}",
                  with_id)[0] == 201
    status, body, _ = s.call("POST", f"/events.json?accessKey={s.key}",
                             with_id)
    assert status == 400 and "duplicate" in body["message"]


def sc_keepalive_after_401_post(s):
    conn = http.client.HTTPConnection("127.0.0.1", s.port, timeout=60)
    conn.request("POST", "/events.json", body=json.dumps(RATE),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    first = (resp.status, json.loads(resp.read()))
    # the second request on the SAME connection must not see leftover
    # body bytes
    conn.request("GET", "/")
    resp = conn.getresponse()
    second = (resp.status, json.loads(resp.read()))
    conn.close()
    assert first[0] == 401
    assert second == (200, {"status": "alive"})
    s.log += [first, second]


def sc_auth_cache_entry_carries_app_id(s):
    assert s.call("POST", f"/events.json?accessKey={s.key}", RATE)[0] == 201
    access_key, app_id, _expiry = s.srv.routes.akey_cache[s.key]
    assert app_id == access_key.app_id
    assert app_id == s.storage.meta_access_keys().get(s.key).app_id


def sc_revoked_key_401s_after_invalidation(s):
    path = f"/events.json?accessKey={s.key}"
    assert s.call("POST", path, RATE)[0] == 201
    # revoked in storage: within the TTL the cached entry still
    # authenticates — the window invalidation closes
    assert s.storage.meta_access_keys().delete(s.key)
    assert s.call("POST", path, RATE)[0] == 201
    s.srv.invalidate_access_key(s.key)
    assert s.call("POST", path, RATE)[0] == 401
    assert s.call("POST", path, RATE)[0] == 401  # misses are not cached


def sc_invalidate_all_clears_every_entry(s):
    assert s.call("GET", f"/events.json?accessKey={s.key}")[0] == 200
    assert s.key in s.srv.routes.akey_cache
    s.srv.invalidate_access_key()
    assert s.srv.routes.akey_cache == {}


EVENT_SERVER_SCENARIOS = [
    sc_alive, sc_post_and_get_roundtrip, sc_auth_failures,
    sc_validation_rejected, sc_batch, sc_batch_duplicate_event_id, sc_delete,
    sc_channel_scoping, sc_time_range_filter, sc_event_whitelist_key,
    sc_stats, sc_basic_auth, sc_segmentio, sc_segmentio_bad_type,
    sc_mailchimp_form, sc_unknown_connector, sc_non_dict_bodies_return_400,
    sc_duplicate_event_id_returns_400, sc_keepalive_after_401_post,
    sc_auth_cache_entry_carries_app_id,
    sc_revoked_key_401s_after_invalidation,
    sc_invalidate_all_clears_every_entry]


@pytest.mark.parametrize("scenario", EVENT_SERVER_SCENARIOS,
                         ids=lambda f: f.__name__[3:])
def test_event_server_scenario(es, scenario):
    _check(es, scenario)


def test_port_in_use_clean_error(es, capsys):
    side = es()
    rc = side.console.main(["eventserver", "--ip", "127.0.0.1", "--port",
                            str(side.port)])
    assert rc == 1
    assert "Cannot bind" in capsys.readouterr().err


# -- tests/test_ingest_server.py -----------------------------------------------

def _rate(i):
    return {"event": "rate", "entityType": "user", "entityId": f"u{i}",
            "targetEntityType": "item", "targetEntityId": f"i{i}"}


def sc_concurrent_201s_are_immediately_readable(s):
    failures, statuses = [], []
    lock = threading.Lock()

    def client(b):
        try:
            for i in range(6):
                status, body, _ = s.call(
                    "POST", f"/events.json?accessKey={s.key}",
                    _rate(b * 100 + i))
                got = None
                if status == 201:
                    # read-your-writes: the 201 promises a committed row
                    got = s.call("GET", f"/events/{body['eventId']}.json"
                                        f"?accessKey={s.key}")[0]
                with lock:
                    statuses.append((status, got))
        except BaseException as e:  # noqa: BLE001
            failures.append(e)

    threads = [threading.Thread(target=client, args=(b,)) for b in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert failures == []
    assert statuses == [(201, 200)] * 48
    # concurrent: the transcript's order is the threads'; its content is
    # compared as a sorted list
    s.log = sorted(map(repr, s.log))


def sc_saturation_sheds_429_with_retry_after(s):
    """max_queue 1 and a storage slowed down: nothing but acks and sheds,
    both present, every 429 with a positive Retry-After."""
    real_insert = s.srv.ingest.insert_fn
    real_grouped = s.srv.ingest.grouped_fn
    s.srv.ingest.insert_fn = lambda e, a, c=None: (
        time.sleep(0.02), real_insert(e, a, c))[1]
    s.srv.ingest.grouped_fn = lambda items: (
        time.sleep(0.02), real_grouped(items))[1]
    tally, retry_afters, messages = {}, [], set()
    lock = threading.Lock()

    def client(b):
        for i in range(4):
            status, body, headers = s.call(
                "POST", f"/events.json?accessKey={s.key}",
                _rate(b * 100 + i))
            with lock:
                tally[status] = tally.get(status, 0) + 1
                if status == 429:
                    retry_afters.append(headers.get("Retry-After"))
                    messages.add(body["message"])

    threads = [threading.Thread(target=client, args=(b,)) for b in range(10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert set(tally) <= {201, 429}, tally
    assert tally.get(201) and tally.get(429), tally
    assert retry_afters and all(float(h) == 0.5 for h in retry_afters)
    # how many shed depends on the interleaving: compare what a 429 says
    s.log = [sorted(tally), sorted(messages)]


def sc_webhook_rides_the_write_plane(s):
    before = s.writer.COMMITS.labels().value
    status, body, _ = s.call(
        "POST", f"/webhooks/segmentio.json?accessKey={s.key}",
        {"type": "track", "event": "signup", "userId": "u9"})
    assert status == 201
    assert s.call("GET", f"/events/{body['eventId']}.json"
                         f"?accessKey={s.key}")[0] == 200
    assert s.writer.COMMITS.labels().value == before + 1


def sc_grouping_off_still_serves(s):
    status, body, _ = s.call("POST", f"/events.json?accessKey={s.key}",
                             _rate(1))
    assert status == 201
    assert s.call("GET", f"/events/{body['eventId']}.json"
                         f"?accessKey={s.key}")[0] == 200


def sc_batch_route_bypasses_plane_but_still_works(s):
    before = s.writer.COMMITS.labels().value
    status, body, _ = s.call(
        "POST", f"/batch/events.json?accessKey={s.key}",
        [_rate(i) for i in range(5)])
    assert status == 200
    assert all(r["status"] == 201 for r in body)
    assert s.writer.COMMITS.labels().value == before


def sc_metrics_expose_ingest_families(s):
    assert s.call("POST", f"/events.json?accessKey={s.key}",
                  _rate(1))[0] == 201
    with urllib.request.urlopen(
            f"http://127.0.0.1:{s.port}/metrics", timeout=60) as resp:
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith("text/plain")
        text = resp.read().decode()
    families = ("ingest_group_size", "ingest_commit_seconds",
                "ingest_commits_total", "ingest_shed_total",
                "ingest_in_flight", "ingest_queue_depth",
                "eventserver_events_total")
    for family in families:
        assert f"# TYPE {family} " in text, family
    samples = parse_prometheus(text)
    assert any(v >= 1 for v in samples["ingest_commits_total"].values())
    s.log.append(families)


INGEST_SCENARIOS = [
    (sc_concurrent_201s_are_immediately_readable, None),
    (sc_saturation_sheds_429_with_retry_after,
     {"max_queue": 1, "retry_after_s": 0.5}),
    (sc_webhook_rides_the_write_plane, None),
    (sc_grouping_off_still_serves, {"grouping": False}),
    (sc_batch_route_bypasses_plane_but_still_works, None),
    (sc_metrics_expose_ingest_families, None)]


@pytest.mark.parametrize("scenario,ingest_config", INGEST_SCENARIOS,
                         ids=[f.__name__[3:] for f, _ in INGEST_SCENARIOS])
def test_ingest_scenario(es, scenario, ingest_config):
    _check(es, scenario, app_name="IngestApp", ingest_config=ingest_config)


# -- a pio.db across both packages ---------------------------------------------

def _file_storage(registry_mod, path):
    src = registry_mod.SourceConfig(name="F", type="sqlite", path=str(path))
    return registry_mod.Storage(registry_mod.StorageConfig(
        metadata=src, modeldata=src, eventdata=src))


@pytest.mark.parametrize("writer_impl,reader_impl",
                         [("port", "reference"), ("reference", "port")])
def test_events_posted_by_one_package_read_back_by_the_other(
        tmp_path, writer_impl, reader_impl):
    """Events POSTed to one package's event server on a sqlite file: the
    other package's Storage reads every row back field for field (the
    `pio_lineage` envelope, stripped on read by both, aside), and both
    packages agree on the lineage context re-attached to each row."""
    w_api, _, w_base, w_reg, _ = IMPLS[writer_impl]
    _, _, _, r_reg, _ = IMPLS[reader_impl]
    db = tmp_path / "pio.db"
    storage = _file_storage(w_reg, db)
    app_id = storage.meta_apps().insert(w_base.App(id=0, name="X"))
    key = w_base.AccessKey.generate(app_id)
    storage.meta_access_keys().insert(key)
    storage.meta_channels().insert(w_base.Channel(id=0, name="ch1",
                                                  app_id=app_id))
    srv = w_api.EventServer(w_api.EventServerConfig(ip="127.0.0.1", port=0),
                            storage)
    srv.start()
    ids = []
    try:
        bodies = [RATE, dict(RATE, entityId="u2", properties={"rating": 1}),
                  {"event": "$set", "entityType": "item", "entityId": "i9",
                   "properties": {"categories": ["a", "b"]}},
                  dict(RATE, eventId="caller-id", tags=["t1"])]
        for n, body in enumerate(bodies):
            channel = "&channel=ch1" if n == 1 else ""
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/events.json?accessKey="
                f"{key.key}{channel}", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 201
                ids.append(json.loads(resp.read())["eventId"])
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/batch/events.json?accessKey="
            f"{key.key}", data=json.dumps([dict(RATE, entityId=f"b{i}")
                                           for i in range(3)]).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            ids += [r["eventId"] for r in json.loads(resp.read())]
    finally:
        srv.shutdown()
    written = storage.l_events()
    want = {e.event_id: e for e in written.find(app_id)}
    want.update({e.event_id: e for e in written.find(app_id, channel_id=1)})
    storage.close()
    reader = _file_storage(r_reg, db)
    try:
        le = reader.l_events()
        got = {e.event_id: e for e in le.find(app_id)}
        got.update({e.event_id: e for e in le.find(app_id, channel_id=1)})
        assert sorted(got) == sorted(want) == sorted(ids)
        for eid in ids:
            assert got[eid].to_dict() == want[eid].to_dict()
            assert "pio_lineage" not in got[eid].to_dict()["properties"]
            g, w = got[eid].lineage_ctx, want[eid].lineage_ctx
            assert g is not None and w is not None
            assert (g.trace_id, g.origin_wall, g.app) == \
                (w.trace_id, w.origin_wall, w.app)
            assert g.app == str(app_id)
        assert le.get("caller-id", app_id).tags == ["t1"]
    finally:
        reader.close()


# -- the console verbs ---------------------------------------------------------

def test_console_accesskey_and_channel_verbs(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    registry.Storage.reset(None)
    assert console.main(["app", "new", "A1"]) == 0
    assert console.main(["app", "channel-new", "A1", "ch1"]) == 0
    assert console.main(["app", "channel-new", "A1", "ch1"]) == 1
    assert console.main(["app", "channel-new", "nope", "ch1"]) == 1
    assert console.main(["accesskey", "new", "A1", "--event", "view",
                         "--event", "buy"]) == 0
    out = capsys.readouterr().out
    key = re.search(r"Created new access key: (\S+)", out).group(1)
    assert "Created channel ch1 (id=1) for app A1." in out
    assert console.main(["accesskey", "list", "A1"]) == 0
    listed = capsys.readouterr().out
    assert f"  {key} events=['view', 'buy']" in listed
    assert console.main(["accesskey", "new", "nope"]) == 1
    assert console.main(["accesskey", "delete", key]) == 0
    assert console.main(["accesskey", "delete", key]) == 1
    assert "No such key." in capsys.readouterr().out
    storage = _file_storage(registry, tmp_path / "pio.db")
    try:
        app = storage.meta_apps().get_by_name("A1")
        assert [c.name for c in storage.meta_channels().get_by_app_id(
            app.id)] == ["ch1"]
        assert len(storage.meta_access_keys().get_by_app_id(app.id)) == 1
    finally:
        storage.close()


def test_eventserver_verb_serves_until_sigterm(tmp_path):
    """`console eventserver --port 0` in a child: the reference's
    "listening on ip:port" line, a POST through it, exit 0 on SIGTERM,
    and CUDA never initialised in the child."""
    import os
    import signal
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, PIO_FS_BASEDIR=str(tmp_path))
    assert subprocess.run(
        [sys.executable, "-m", "predictionio_torch.tools.console", "app",
         "new", "A1"], env=env, capture_output=True, timeout=120,
        cwd=repo).returncode == 0
    child = (
        "import sys, torch\n"
        "from predictionio_torch.tools import console\n"
        "rc = console.main(sys.argv[1:])\n"
        "print('cuda initialised:', torch.cuda.is_initialized(), "
        "flush=True)\n"
        "sys.exit(rc)\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", child, "eventserver", "--ip", "127.0.0.1",
         "--port", "0"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=repo)
    try:
        line = proc.stdout.readline()
        assert re.match(r"Event Server \(stats=off\) listening on "
                        r"127\.0\.0\.1:\d+$", line.strip()), line
        port = int(line.rsplit(":", 1)[1])
        storage = _file_storage(registry, tmp_path / "pio.db")
        try:
            app = storage.meta_apps().get_by_name("A1")
            key = storage.meta_access_keys().get_by_app_id(app.id)[0].key
        finally:
            storage.close()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/events.json?accessKey={key}",
            data=json.dumps(RATE).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 201
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err[-2000:]
    assert "cuda initialised: False" in out


# -- through the front door to a served fold -----------------------------------

def test_a_rating_posted_through_the_event_server_is_folded_and_served(
        memory_storage, tmp_path, monkeypatch):
    """The port's event server and a port deploy with PIO_ONLINE=1 share a
    sqlite store; the reference's event server feeds the reference's
    plane the same events. Ratings POSTed one by one to /events.json
    change the never-seen user's answer within 30 s, and the port's
    folded user rows equal the reference's within rtol 2e-3 / atol 1e-5
    (tests/test_torch_online.py's fold bar)."""
    import numpy as np

    from predictionio_tpu.data.datamap import DataMap as RefDataMap
    from predictionio_tpu.data.events import Event as RefEvent
    from predictionio_torch import convert
    from predictionio_torch.storage.base import EngineInstance, Model
    from predictionio_torch.workflow.create_server import PredictionServer
    from predictionio_torch.workflow.workflow_utils import (
        engine_params_to_json,
    )
    from tests.test_experiment import train_variant
    from tests.test_online import online_server as ref_online_server
    from tests.test_torch_online_plane import (
        FACTORY,
        VARIANT,
        _ingest,
        _parts,
        _untied_equal,
        _variant_dict,
    )

    _ingest(memory_storage, ref_base.App, RefEvent, RefDataMap)
    ref_instance = train_variant(memory_storage, iters=15)
    storage = _file_storage(registry, tmp_path / "pio.db")
    _ingest(storage)
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps(_variant_dict()))
    monkeypatch.setenv("PIO_ONLINE", "1")
    monkeypatch.setenv("PIO_ONLINE_INTERVAL_S", "0.05")
    monkeypatch.setenv("PIO_ONLINE_FOLD_ITEMS", "0")
    with contextlib.ExitStack() as stack:
        ref_server = stack.enter_context(ref_online_server(
            memory_storage, interval_s=0.05, fold_items=False))
        ref_model = ref_server._states[VARIANT].models[0]
        seen = [(row, int(i)) for row in range(len(ref_model.user_ids))
                for i in ref_model.seen.get(row, [])]
        # the reference's trained model, carried into the port's store as
        # a completed instance that began when the reference's did
        model = convert.als_model_from_arrays(
            ref_model.user_factors, ref_model.item_factors,
            ref_model.user_ids.to_dict(), ref_model.item_ids.to_dict(),
            np.asarray([u for u, _ in seen]),
            np.asarray([i for _, i in seen]))
        _, engine, ep = _parts()
        instance = EngineInstance(
            id="", status="COMPLETED", start_time=ref_instance.start_time,
            end_time=ref_instance.end_time, engine_id=VARIANT,
            engine_version="1", engine_variant=VARIANT,
            engine_factory=FACTORY, **engine_params_to_json(ep))
        instance.id = storage.meta_engine_instances().insert(instance)
        storage.model_data_models().insert(
            Model(id=instance.id, models=engine.serialize_models([model])))

        server = PredictionServer(str(engine_json), ip="127.0.0.1", port=0,
                                  device="cpu", storage=storage)
        stack.callback(server.server_close)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        stack.callback(server.shutdown)
        servers = {}
        for name, (mod, store) in {"port": (api, storage),
                                   "ref": (ref_api, memory_storage)}.items():
            srv = mod.EventServer(mod.EventServerConfig(ip="127.0.0.1",
                                                        port=0), store)
            srv.start()
            stack.callback(srv.shutdown)
            app_id = store.meta_apps().get_by_name("RecApp").id
            base_mod = base if name == "port" else ref_base
            key = base_mod.AccessKey.generate(app_id)
            store.meta_access_keys().insert(key)
            servers[name] = (srv.port, key.key)

        def query(user):
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/queries.json",
                data=json.dumps({"user": user, "num": 3}).encode())
            with urllib.request.urlopen(req, timeout=30) as resp:
                return [s["item"] for s in json.loads(resp.read())[
                    "itemScores"]]

        before = query("fresh")
        rated = {"i1": 5.0, "i3": 4.0}
        rows = [("fresh", i, r) for i, r in rated.items()] + [
            ("u4", "i1", 2.0)]
        for n, (user, item, rating) in enumerate(rows):
            when = ref_instance.start_time + timedelta(seconds=1 + n)
            body = {"event": "rate", "entityType": "user", "entityId": user,
                    "targetEntityType": "item", "targetEntityId": item,
                    "properties": {"rating": rating},
                    "eventTime": when.isoformat().replace("+00:00", "Z")}
            for port, key in servers.values():
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/events.json?accessKey={key}",
                    data=json.dumps(body).encode())
                with urllib.request.urlopen(req, timeout=30) as resp:
                    assert resp.status == 201
        posted = time.monotonic()
        after = before
        while time.monotonic() - posted < 30.0:
            after = query("fresh")
            if (after and not set(after) & set(rated)
                    and server.online.events_folded >= len(rows)):
                break
            time.sleep(0.02)
        assert before == [] and after and not set(after) & set(rated), \
            (before, after)
        assert server.online.events_folded == len(rows)
        assert ref_server.online.poll_once() == len(rows)
        folded = server._states[VARIANT].models[0]
        ref_folded = ref_server._states[VARIANT].models[0]
        assert folded.user_ids.to_dict() == ref_folded.user_ids.to_dict()
        dirty = [folded.user_ids[u] for u in ("fresh", "u4")]
        np.testing.assert_allclose(
            np.asarray(folded.user_factors)[dirty],
            np.asarray(ref_folded.user_factors)[dirty],
            rtol=2e-3, atol=1e-5)
        for user in ("fresh", "u4"):
            _untied_equal(ref_folded.recommend_products(user, 3),
                          folded.recommend_products(user, 3))
        assert after == [i for i, _ in folded.recommend_products("fresh", 3)]
