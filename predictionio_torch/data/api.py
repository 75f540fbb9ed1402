"""Event server — REST ingest service. Own copy of the reference's
``predictionio_tpu/data/api.py``.

Parity with «data/.../data/api/EventServer.scala :: EventServer,
EventServiceActor» (SURVEY.md §2.2/§3.3 [U]). Routes:

    GET    /                              → {"status": "alive"}
    POST   /events.json?accessKey=K[&channel=C]      → 201 {"eventId": ...}
    GET    /events.json?accessKey=K&...filters...    → 200 [events]
    GET    /events/<id>.json?accessKey=K             → 200 event | 404
    DELETE /events/<id>.json?accessKey=K             → 200 | 404
    POST   /batch/events.json?accessKey=K            → 200 [per-event results]
    GET    /stats.json?accessKey=K                   → 200 (when --stats)
    POST   /webhooks/<connector>.json?accessKey=K    → 201 (connector-mapped)
    GET    /metrics                                  → the telemetry registry

Auth is by access key (query param or Basic `Authorization` header),
scoped to the key's app and optional event-name whitelist, exactly like
the reference. The handlers are plain `fn(Request) -> Response` functions
on a `Router`, served by a `ThreadingHTTPServer` (utils/routing.py).

Single-event writes (`POST /events.json` and the webhook connectors) go
through the ingest write plane (ingest/writer.py): concurrent inserts
coalesce into one shared transaction (group commit), the 201 is sent
only after that commit, and past the bounded in-flight budget the server
answers 429 + Retry-After. `POST /batch/events.json` commits its chunk
as one transaction on its direct path.

The event server does no device work: nothing here touches CUDA.
"""

from __future__ import annotations

import base64
import json
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs

from predictionio_torch.data.events import (
    Event,
    EventValidationError,
    parse_time,
    validate_event,
)
from predictionio_torch.data.webhooks import get_connector
from predictionio_torch.ingest.writer import (
    GroupCommitWriter,
    IngestConfig,
    IngestOverload,
)
from predictionio_torch.storage.registry import Storage
from predictionio_torch.telemetry import lineage
from predictionio_torch.telemetry.registry import (
    METRICS_CONTENT_TYPE,
    REGISTRY,
    capped_label,
)
from predictionio_torch.utils import fastjson
from predictionio_torch.utils.routing import (
    Request,
    Response,
    Router,
    handler_from_router,
    path_param,
)

BATCH_LIMIT = 50  # reference rejects >50 events per batch POST [U]
DEFAULT_FIND_LIMIT = 20


# Shared across all EventServer instances in the process; each Stats
# instance subtracts its construction-time baseline to keep the
# "since this server started" /stats.json contract.
EVENTS_TOTAL = REGISTRY.counter(
    "eventserver_events_total",
    "Events processed by the event server, by app/event/status",
    labelnames=("app_id", "event", "status"))


def _app_label(app_id) -> str:
    return capped_label("tenant", str(app_id))


class Stats:
    """Per-app event counters (the reference's `Stats`/`StatsActor` [U]),
    exposed at GET /stats.json, backed by the telemetry registry."""

    def __init__(self):
        self.start_time = time.time()
        self._baseline = self._totals()

    @staticmethod
    def _totals() -> dict:
        return dict(EVENTS_TOTAL.collect())

    def update(self, app_id: int, event_name: str, status: int) -> None:
        # both label values are request-derived: capped so a junk-event
        # flood cannot grow /metrics forever
        EVENTS_TOTAL.labels(app_id=_app_label(app_id),
                            event=capped_label("event_name", event_name),
                            status=str(status)).inc()

    def snapshot(self, app_id: int) -> dict:
        base = self._baseline
        items = []
        target = _app_label(app_id)
        for (aid, ev, status), n in sorted(self._totals().items()):
            n -= base.get((aid, ev, status), 0)
            if aid == target and n > 0:
                items.append({"event": ev, "status": int(status),
                              "count": int(n)})
        return {"uptime_s": round(time.time() - self.start_time, 1),
                "counts": items}


class EventServerConfig:
    def __init__(self, ip: str = "0.0.0.0", port: int = 7070,
                 stats: bool = False):
        self.ip = ip
        self.port = port
        self.stats = stats


# positive access-key lookups are cached this long: the key row is read
# on EVERY request, and under write load that SELECT costs as much
# interpreter time as the shared group commit itself. A revoked or
# narrowed key therefore keeps working for up to this window on a
# long-lived server, as in the reference.
_AKEY_CACHE_TTL_S = 5.0


def _authed(handler):
    """Auth around one route handler: 401 unless the access key (and its
    channel, when one is named) resolves. The reference also binds the
    key's app as the request's tenant and meters the request here; the
    port has no tenant plane yet (ROADMAP Queue 1 item 11)."""

    def wrapped(self, req: Request) -> Response:
        auth = self._auth(req)
        if auth is None:
            return self._UNAUTHORIZED
        return handler(self, req, auth)

    wrapped.__name__ = getattr(handler, "__name__", "authed")
    wrapped.__doc__ = handler.__doc__
    return wrapped


_ALIVE = Response(200, body=fastjson.dumps_bytes({"status": "alive"}))


def _metrics(req: Request) -> Response:
    return Response(200, body=REGISTRY.render().encode(),
                    content_type=METRICS_CONTENT_TYPE)


class _EventRoutes:
    """The event server's route handlers, bound once to server state."""

    def __init__(self, storage: Storage, stats: Optional[Stats],
                 ingest: GroupCommitWriter):
        self.storage = storage
        self.stats = stats
        self.ingest = ingest
        self.akey_cache: dict = {}

    def router(self) -> Router:
        r = Router()
        r.get("/", self._handle_root)
        r.get("/metrics", _metrics)
        r.get("/events.json", self._handle_find, blocking=True)
        r.get("/stats.json", self._handle_stats, blocking=True)
        r.add_prefix("GET", "/events/", ".json", self._handle_get_event,
                     template="/events/<id>.json", blocking=True)
        r.post("/events.json", self._handle_insert, blocking=True)
        r.post("/batch/events.json", self._handle_batch, blocking=True)
        r.add_prefix("POST", "/webhooks/", ".json", self._handle_webhook,
                     template="/webhooks/<connector>.json", blocking=True)
        r.add_prefix("DELETE", "/events/", ".json", self._handle_delete,
                     template="/events/<id>.json", blocking=True)
        return r

    # -- helpers -----------------------------------------------------------
    def _auth(self, req: Request):
        """Resolve access key → (AccessKey, app_id, channel_id) or None.
        `invalidate_access_key` drops cache entries eagerly, so a revoked
        key stops authenticating at once instead of after the TTL."""
        q = req.params
        key = q.get("accessKey")
        if key is None:
            auth = req.headers.get("Authorization", "")
            if auth.startswith("Basic "):
                try:
                    key = base64.b64decode(auth[6:]).decode().split(":", 1)[0]
                except Exception:  # noqa: BLE001 — malformed: no key
                    key = None
        if not key:
            return None
        now = time.monotonic()
        cached = self.akey_cache.get(key)
        if cached is not None and cached[2] > now:
            access_key = cached[0]
        else:
            access_key = self.storage.meta_access_keys().get(key)
            if access_key is not None:
                # misses (bad keys) are NOT cached, so a flood of junk
                # keys cannot grow this beyond the real key population
                self.akey_cache[key] = (access_key, access_key.app_id,
                                        now + _AKEY_CACHE_TTL_S)
        if access_key is None:
            return None
        channel_id = None
        channel_name = q.get("channel")
        if channel_name:
            channels = {
                c.name: c for c in
                self.storage.meta_channels().get_by_app_id(access_key.app_id)
            }
            if channel_name not in channels:
                return None
            channel_id = channels[channel_name].id
        return access_key, access_key.app_id, channel_id

    def invalidate_access_key(self, key: Optional[str] = None) -> None:
        """Drop one key (or all of them) from the positive auth cache."""
        if key is None:
            self.akey_cache.clear()
        else:
            self.akey_cache.pop(key, None)

    _UNAUTHORIZED = Response(
        401, body=fastjson.dumps_bytes({"message": "Invalid accessKey."}))

    def _validate_event(self, d: dict, access_key) -> Event:
        """Parse + validate + whitelist; storage untouched. (The
        reference's plugin gate, 403 on a blocking plugin, comes here:
        ROADMAP Queue 1 item 17.)"""
        event = Event.from_dict(d)
        validate_event(event)
        if access_key.events and event.event not in access_key.events:
            raise EventValidationError(
                f"event {event.event!r} is not allowed by this access key"
            )
        return event

    def _insert_event(self, d: dict, access_key, app_id: int,
                      channel_id) -> str:
        event = self._validate_event(d, access_key)
        # Causal lineage is born here: AFTER validate_event (which
        # rejects client pio_* property keys, so the envelope cannot be
        # spoofed), BEFORE the write plane (which records the commit
        # stage and persists the context with the event).
        event.lineage_ctx = lineage.mint(app_id)
        lineage.LINEAGE.record_stage(event.lineage_ctx, "ingest")
        le = self.storage.l_events()
        try:
            # through the write plane: coalesced with concurrent inserts,
            # committed before this returns, IngestOverload past the
            # bounded budget (→ 429 at the route)
            eid = self.ingest.submit(event, app_id, channel_id)
        except le.integrity_errors as e:
            raise EventValidationError(
                f"duplicate eventId {event.event_id!r}"
            ) from e
        if self.stats:
            self.stats.update(app_id, event.event, 201)
        return eid

    def _shed(self, app_id: int, e: IngestOverload) -> Response:
        """429 + Retry-After for a write-plane overload."""
        if self.stats:
            self.stats.update(app_id, "<shed>", 429)
        return Response.message(
            429, str(e), headers={"Retry-After": f"{e.retry_after_s:g}"})

    # -- routes ------------------------------------------------------------
    def _handle_root(self, req: Request) -> Response:
        return _ALIVE

    @_authed
    def _handle_find(self, req: Request, auth) -> Response:
        _, app_id, channel_id = auth
        q = req.params
        try:
            events = self.storage.l_events().find(
                app_id=app_id,
                channel_id=channel_id,
                start_time=(parse_time(q["startTime"])
                            if "startTime" in q else None),
                until_time=(parse_time(q["untilTime"])
                            if "untilTime" in q else None),
                entity_type=q.get("entityType"),
                entity_id=q.get("entityId"),
                event_names=[q["event"]] if "event" in q else None,
                target_entity_type=q.get("targetEntityType"),
                target_entity_id=q.get("targetEntityId"),
                limit=int(q.get("limit", DEFAULT_FIND_LIMIT)),
                reversed=q.get("reversed", "false").lower() == "true",
            )
        except (ValueError, EventValidationError) as e:
            return Response.message(400, str(e))
        return Response.json(200, [e.to_dict() for e in events])

    @_authed
    def _handle_get_event(self, req: Request, auth) -> Response:
        _, app_id, channel_id = auth
        eid = path_param(req.path, "/events/", ".json")
        event = self.storage.l_events().get(eid, app_id, channel_id)
        if event is None:
            return Response.message(404, "Not Found")
        return Response.json(200, event.to_dict())

    @_authed
    def _handle_stats(self, req: Request, auth) -> Response:
        _, app_id, _ = auth
        if self.stats is None:
            return Response.message(
                404, "To see stats, launch Event Server with --stats.")
        return Response.json(200, self.stats.snapshot(app_id))

    @_authed
    def _handle_insert(self, req: Request, auth) -> Response:
        access_key, app_id, channel_id = auth
        try:
            d = fastjson.loads(req.body or b"{}")
            eid = self._insert_event(d, access_key, app_id, channel_id)
        except IngestOverload as e:
            return self._shed(app_id, e)
        except (EventValidationError, json.JSONDecodeError, ValueError) as e:
            if self.stats:
                self.stats.update(app_id, "<invalid>", 400)
            return Response.message(400, str(e))
        return Response(201, body=fastjson.event_id_response(eid))

    @_authed
    def _handle_batch(self, req: Request, auth) -> Response:
        access_key, app_id, channel_id = auth
        try:
            items = fastjson.loads(req.body or b"[]")
            if not isinstance(items, list):
                raise ValueError("batch body must be a JSON array")
        except (json.JSONDecodeError, ValueError) as e:
            return Response.message(400, str(e))
        if len(items) > BATCH_LIMIT:
            return Response.message(
                400, f"Batch request must have less than or equal to "
                     f"{BATCH_LIMIT} events")
        # two-phase: validate every row first (per-row statuses), then
        # store the valid ones in ONE transaction via insert_batch
        results: list = []
        prepared: list[tuple[int, Event]] = []
        for i, d in enumerate(items):
            try:
                event = self._validate_event(d, access_key)
                # one lineage timeline per EVENT, not per request
                event.lineage_ctx = lineage.mint(app_id)
                lineage.LINEAGE.record_stage(event.lineage_ctx, "ingest")
                prepared.append((i, event))
                results.append(None)  # filled after the batch insert
            except (EventValidationError, ValueError) as e:
                results.append({"status": 400, "message": str(e)})
        if prepared:
            le = self.storage.l_events()
            try:
                ids = le.insert_batch(
                    [e for _, e in prepared], app_id, channel_id)
            except le.integrity_errors:
                # duplicate caller-set eventId somewhere in the chunk:
                # the transaction rolled back — redo per event so only
                # the offending rows 400. Each row commits on its own
                # here, so a non-integrity failure becomes THAT row's
                # status, not a request-wide 500 that would discard the
                # statuses of rows already committed.
                ids = []
                for _, event in prepared:
                    try:
                        ids.append(le.insert(event, app_id, channel_id))
                    except le.integrity_errors:
                        ids.append(None)
                    except Exception as e:  # noqa: BLE001
                        ids.append(e)
            for (i, event), eid in zip(prepared, ids):
                if eid is None:
                    results[i] = {"status": 400, "message":
                                  f"duplicate eventId {event.event_id!r}"}
                    continue
                if isinstance(eid, Exception):
                    results[i] = {"status": 500, "message": str(eid)}
                    continue
                results[i] = {"status": 201, "eventId": eid}
                lineage.LINEAGE.record_stage(event.lineage_ctx, "commit")
                if self.stats:
                    self.stats.update(app_id, event.event, 201)
            self.ingest.notify_committed(
                [e for (_, e), eid in zip(prepared, ids)
                 if eid is not None and not isinstance(eid, Exception)])
        return Response.json(200, results)

    @_authed
    def _handle_webhook(self, req: Request, auth) -> Response:
        access_key, app_id, channel_id = auth
        form = req.headers.get("Content-Type", "").startswith(
            "application/x-www-form-urlencoded")
        name = path_param(req.path, "/webhooks/", ".json")
        connector = get_connector(name, form=form)
        if connector is None:
            return Response.message(404, f"Unknown connector {name!r}")
        try:
            if form:
                payload = {k: v[0]
                           for k, v in parse_qs(req.body.decode()).items()}
            else:
                payload = fastjson.loads(req.body or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("webhook payload must be a JSON object")
            event_dict = connector.to_event_dict(payload)
            eid = self._insert_event(event_dict, access_key, app_id,
                                     channel_id)
        except IngestOverload as e:
            return self._shed(app_id, e)
        except (EventValidationError, json.JSONDecodeError, ValueError,
                KeyError) as e:
            return Response.message(400, str(e))
        return Response(201, body=fastjson.event_id_response(eid))

    @_authed
    def _handle_delete(self, req: Request, auth) -> Response:
        _, app_id, channel_id = auth
        eid = path_param(req.path, "/events/", ".json")
        ok = self.storage.l_events().delete(eid, app_id, channel_id)
        if ok:
            return Response.message(200, "Found")
        return Response.message(404, "Not Found")


class EventServer(ThreadingHTTPServer):
    """The event server on a `ThreadingHTTPServer`: bound at
    construction, served by `serve_forever` (or `start()`, on a thread of
    its own); `shutdown()` stops serving and drains the write plane.
    `create_event_server` is the reference's factory spelling.

    Left out of the reference's: the `X-PIO-Debug` header, request spans
    and tracing, and the alert watchdog (ROADMAP Queue 1 item 11), the
    plugin hook (item 17) and the selector event loop (item 16)."""

    daemon_threads = True
    # a burst of concurrent clients connects before any handler reads:
    # the standard library's listen backlog of 5 would drop the rest
    request_queue_size = 128

    def __init__(self, config: EventServerConfig,
                 storage: Optional[Storage] = None,
                 ingest_config: Optional[IngestConfig] = None):
        self.config = config
        self.storage = storage or Storage.get()
        self.stats = Stats() if config.stats else None
        # one write plane per server: every handler's single-event insert
        # funnels into it
        le = self.storage.l_events()
        self.ingest = GroupCommitWriter(
            insert_fn=le.insert,
            grouped_fn=le.insert_grouped,
            config=ingest_config or IngestConfig.from_env(),
            name="eventserver")
        self.routes = _EventRoutes(self.storage, self.stats, self.ingest)
        self._thread: Optional[threading.Thread] = None
        try:
            super().__init__((config.ip, config.port),
                             handler_from_router(self.routes.router()))
        except BaseException:
            self.ingest.close()
            raise

    @property
    def port(self) -> int:
        return self.server_address[1]

    def start(self) -> None:
        """Serve on a daemon thread of this process."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        name="eventserver", daemon=True)
        self._thread.start()

    def invalidate_access_key(self, key: Optional[str] = None) -> None:
        """Admin hook: evict a revoked/rotated key (or all keys) from the
        5 s auth cache so it stops authenticating immediately."""
        self.routes.invalidate_access_key(key)

    def shutdown(self) -> None:
        """Stop accepting first (blocks until `serve_forever` returns),
        then drain the write plane; the socket closes too when the server
        was started by `start()`."""
        super().shutdown()
        self.ingest.close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
            super().server_close()

    def server_close(self) -> None:
        self.ingest.close()
        super().server_close()


def create_event_server(
    config: Optional[EventServerConfig] = None,
    storage: Optional[Storage] = None,
) -> EventServer:
    return EventServer(config or EventServerConfig(), storage)
