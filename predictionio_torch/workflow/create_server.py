"""The `pio deploy` prediction server — the port of the reference's
``predictionio_tpu/workflow/create_server.py`` routes:

    POST /queries.json  {"user": "1", "num": 4}  → PredictedResult JSON
    POST /reload        → swap in the store's latest completed instance
    GET  /              → status (engine, instance id, the online block)
    GET  /metrics       → the telemetry registry, Prometheus text

It serves, on the standard library's `ThreadingHTTPServer`, either the
latest completed engine instance of the model repository (as the
reference does) or one model file; components are resolved once at load,
not per query. The served state sits in a table keyed by engine variant,
replaced whole under a lock by `/reload` and by the online plane
(`online/plane.py`, `PIO_ONLINE=1`), which folds new events from the
store into the served models. A deploy from a model file has no store:
it can neither reload nor run the plane.

Every `/queries.json` goes through the serving plane
(`serving/plane.py`, configured by `PIO_SERVING_*`): the opt-in result
cache, admission control (429 past the queue bound, 503 past the
client's `X-PIO-Deadline-Ms`, both with Retry-After), micro-batching into
`Engine.predict_batch` on a dispatcher thread (a lone request dispatches
inline on its handler thread), and the popularity answer with
`X-PIO-Degraded: 1` when admission sheds.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

import torch

from predictionio_torch.controller.engine import Engine, EngineParams
from predictionio_torch.data.events import format_time
from predictionio_torch.device import DeviceLike, resolve_device
from predictionio_torch.online.plane import OnlineConfig, OnlinePlane
from predictionio_torch.serving import (
    DeadlineExceeded,
    ServingConfig,
    ServingPlane,
    ShedLoad,
)
from predictionio_torch.storage import base as storage_base
from predictionio_torch.storage.registry import Storage
from predictionio_torch.telemetry.registry import (
    METRICS_CONTENT_TYPE,
    REGISTRY,
)
from predictionio_torch.utils import fastjson
from predictionio_torch.utils.faults import FaultInjected
from predictionio_torch.workflow.core_workflow import read_model_file
from predictionio_torch.workflow.workflow_utils import (
    EngineVariant,
    extract_engine_params,
    get_engine,
    read_engine_json,
)

log = logging.getLogger(__name__)

# The query hot path, separated from the HTTP envelope so engine time is
# distinguishable from request parsing/serialization in one scrape.
PREDICT_SECONDS = REGISTRY.histogram(
    "engine_predict_seconds",
    "Engine predict dispatch latency in seconds (one observation per "
    "batched dispatch; serving_batch_size gives queries per dispatch)")
QUERIES_FAILED = REGISTRY.counter(
    "engine_queries_failed_total", "Queries answered with a non-200 status")
_PREDICT_SECONDS = PREDICT_SECONDS.labels()
_QUERIES_FAILED = QUERIES_FAILED.labels()


@dataclasses.dataclass
class ServedState:
    """What serving one trained instance needs, resolved once."""

    instance: storage_base.EngineInstance
    engine: Engine
    engine_params: EngineParams
    models: list
    components: tuple


def _on_device(models: list, device: torch.device) -> list:
    """Set every model's bulk scoring to `device`: the device of the run,
    not the one pickled with the model."""
    for model in models:
        if hasattr(model, "device"):
            model.device = str(device)
    return models


def load_served_state(engine_json: str, model_path: str,
                      device: torch.device) -> ServedState:
    """Load a model file for the engine that engine.json names (refusing a
    model another engine trained), scoring on `device`."""
    variant = read_engine_json(engine_json)
    instance, models = read_model_file(model_path)
    if instance.engine_factory != variant.engine_factory:
        raise ValueError(
            f"model file {model_path} was trained by "
            f"{instance.engine_factory}, engine.json names "
            f"{variant.engine_factory}")
    engine = get_engine(variant.engine_factory)
    engine_params = extract_engine_params(engine, variant)
    return ServedState(instance, engine, engine_params,
                       _on_device(models, device),
                       engine.components(engine_params))


def _row_block(raw: str) -> dict:
    """An engine-instance row's params column as an engine.json block.
    Rows store the envelope {"name", "params"}; a bare params object is
    taken as the params."""
    d = json.loads(raw or "{}")
    if isinstance(d, dict) and "params" in d and set(d) <= {"name", "params"}:
        return d
    return {"params": d}


def variant_from_instance(
        instance: storage_base.EngineInstance) -> EngineVariant:
    """Rebuild an EngineVariant from the params JSON stored on the
    engine-instance row: a deploy reads the row, not engine.json."""
    return EngineVariant.from_dict({
        "id": instance.engine_id,
        "variant": instance.engine_variant,
        "engineFactory": instance.engine_factory,
        "datasource": _row_block(instance.data_source_params),
        "preparator": _row_block(instance.preparator_params),
        "algorithms": json.loads(instance.algorithms_params or "[]") or [{}],
        "serving": _row_block(instance.serving_params),
    })


def load_served_state_from_store(
        storage: Storage, engine_id: str, engine_version: str,
        engine_variant: str, device: torch.device) -> ServedState:
    """Load the latest completed engine instance of (`engine_id`,
    `engine_version`, `engine_variant`) and its model blob from
    `storage`, scoring on `device`."""
    instance = storage.meta_engine_instances().get_latest_completed(
        engine_id, engine_version, engine_variant)
    if instance is None:
        raise RuntimeError(
            f"No completed engine instance found for engine "
            f"{engine_id!r} v{engine_version} variant {engine_variant!r}. "
            "Run `train` first.")
    variant = variant_from_instance(instance)
    engine = get_engine(variant.engine_factory)
    engine_params = extract_engine_params(engine, variant)
    blob = storage.model_data_models().get(instance.id)
    if blob is None:
        raise RuntimeError(f"Model blob for instance {instance.id} is "
                           "missing.")
    models = engine.deserialize_models(blob.models)
    log.info("Loaded engine instance %s (trained %s)", instance.id,
             format_time(instance.start_time))
    return ServedState(instance, engine, engine_params,
                       _on_device(models, device),
                       engine.components(engine_params))


def load_engine_state(engine_json: str, model_path: Optional[str],
                      device: torch.device, engine_version: str = "1",
                      storage: Optional[Storage] = None) -> ServedState:
    """The served state of a batch predict: the model file `model_path`
    when given, else the latest completed instance of the engine
    engine.json names (its id and variant) in `storage` (None:
    `Storage.get()`)."""
    if model_path:
        return load_served_state(engine_json, model_path, device)
    variant = read_engine_json(engine_json)
    return load_served_state_from_store(
        storage or Storage.get(), variant.id, engine_version,
        variant.variant, device)


class PredictionServer(ThreadingHTTPServer):
    daemon_threads = True
    # a burst of concurrent clients connects before any handler reads:
    # the standard library's listen backlog of 5 would drop the rest
    request_queue_size = 128

    def __init__(self, engine_json: str, model_path: Optional[str] = None,
                 ip: str = "0.0.0.0", port: int = 8000,
                 device: DeviceLike = None, engine_version: str = "1",
                 storage: Optional[Storage] = None,
                 online: Optional[OnlineConfig] = None,
                 serving_config: Optional[ServingConfig] = None):
        """Serve the model file `model_path`, or without one the latest
        completed instance of engine.json's engine id and variant in
        `storage` (None: `Storage.get()`). `online` (None:
        `OnlineConfig.from_env()`, i.e. `PIO_ONLINE=1`) runs the online
        plane over that storage; asking for it with a model file raises.
        A plane that fails to start is logged and the server serves on
        without it, as the reference's does. `serving_config` (None:
        `ServingConfig.from_env()`) configures the serving plane that
        answers `/queries.json`."""
        self.device = resolve_device(device)
        self.engine_version = engine_version
        online_cfg = online if online is not None else OnlineConfig.from_env()
        if model_path:
            if online_cfg is not None:
                raise ValueError(
                    "the online plane tails the event store, and a deploy "
                    "from a model file has none: deploy from the store or "
                    "unset PIO_ONLINE")
            self.storage: Optional[Storage] = None
            self._variant = None
            state = load_served_state(engine_json, model_path, self.device)
        else:
            self.storage = storage or Storage.get()
            self._variant = read_engine_json(engine_json)
            state = self._load_from_store()
        # the served-state table: variant → ServedState, each entry
        # replaced whole under the lock (/reload, the plane's swaps) and
        # read once per query
        self._primary_variant = state.instance.engine_variant
        self._states = {self._primary_variant: state}
        self._state_lock = threading.Lock()
        # set before binding: a failed bind calls server_close
        self.online: Optional[OnlinePlane] = None
        self.serving = self._serving_plane(
            serving_config or ServingConfig.from_env())
        super().__init__((ip, port), _Handler)
        log.info("Deployed engine instance %s on %s", state.instance.id,
                 self.device)
        if online_cfg is not None:
            try:
                self.online = OnlinePlane(self, online_cfg)
                self.online.start()
            except Exception:  # noqa: BLE001 — serving must not go down
                log.exception("online plane failed to start; serving "
                              "continues without fold-in")
                self.online = None

    def _serving_plane(self, config: ServingConfig) -> ServingPlane:
        """The primary variant's plane. It outlives reloads and fold
        swaps: the dispatch reads `_states` when it runs, so a batch that
        spans a `/reload` or a swap scores on whichever state is
        current."""
        variant = self._primary_variant

        def dispatch(queries):
            st = self._states[variant]
            t0 = time.perf_counter()
            try:
                return st.engine.predict_batch(
                    st.engine_params, st.models, queries,
                    components=st.components)
            finally:
                _PREDICT_SECONDS.observe(time.perf_counter() - t0)

        def degraded(query):
            st = self._states[variant]
            return st.engine.degraded_predict(
                st.engine_params, st.models, query,
                components=st.components)

        return ServingPlane(dispatch, degraded_fn=degraded, config=config,
                            variant=variant)

    def _load_from_store(self) -> ServedState:
        return load_served_state_from_store(
            self.storage, self._variant.id, self.engine_version,
            self._variant.variant, self.device)

    @property
    def port(self) -> int:
        return self.server_address[1]

    @property
    def state(self) -> ServedState:
        """The primary variant's served state (the only one served)."""
        return self._states[self._primary_variant]

    def predict(self, query: Any) -> Any:
        """One query straight through the engine, outside the serving
        plane (no cache, admission or batching): for in-process callers."""
        st = self.state
        return st.engine.predict(st.engine_params, st.models, query,
                                 components=st.components)

    def reload(self) -> None:
        """Swap in the newest COMPLETED instance from the store. A failed
        load raises and keeps the current state."""
        if self.storage is None:
            raise RuntimeError("deployed from a model file: there is no "
                               "store to reload from")
        with self._state_lock:
            try:
                state = self._load_from_store()
            except Exception:
                log.exception("Reload failed; keeping instance %s",
                              self.state.instance.id)
                raise
            self._states[self._primary_variant] = state
            if self.serving.result_cache is not None:
                # answers cached against the outgoing instance are stale
                # the moment the swap lands
                self.serving.result_cache.invalidate_variant(
                    self._primary_variant)
        log.info("Reloaded engine instance %s", state.instance.id)
        if self.online is not None:
            # outside the state lock: a fold pass holds its own lock
            # while swapping (which takes the state lock), so rebasing
            # under the state lock would deadlock against it. A fold
            # racing this reload is refused by the swapper's stale-state
            # check and replays against the new instance.
            self.online.rebase()

    def status(self) -> dict:
        instance = self.state.instance
        payload = {
            "status": "alive",
            "engineId": instance.engine_id,
            "engineVariant": instance.engine_variant,
            "engineFactory": instance.engine_factory,
            "engineInstanceId": instance.id,
            "startTime": format_time(instance.start_time),
            "device": str(self.device),
        }
        if self.online is not None:
            payload["online"] = self.online.snapshot()
        return payload

    def shutdown(self) -> None:
        """Stop serving (blocks until `serve_forever` returns), then the
        online plane and the serving plane (its dispatcher thread and bus
        subscription)."""
        super().shutdown()
        if self.online is not None:
            self.online.stop()
        self.serving.close()

    def server_close(self) -> None:
        """Close the socket and stop both planes, also for a server that
        never served (`shutdown` waits for `serve_forever`)."""
        if self.online is not None:
            self.online.stop()
        self.serving.close()
        super().server_close()


class _Handler(BaseHTTPRequestHandler):
    server: PredictionServer
    protocol_version = "HTTP/1.1"
    # a response leaves as two writes (headers, body): with Nagle on, a
    # keep-alive client's delayed ACK holds the body back for tens of ms
    disable_nagle_algorithm = True

    def _send(self, code: int, body: bytes, content_type: str,
              headers: Optional[dict] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _reply(self, code: int, payload: Any,
               headers: Optional[dict] = None) -> None:
        self._send(code, fastjson.dumps_bytes(payload),
                   "application/json; charset=UTF-8", headers)

    def do_GET(self) -> None:  # noqa: N802 — http.server's spelling
        if self.path == "/":
            self._reply(200, self.server.status())
        elif self.path == "/metrics":
            self._send(200, REGISTRY.render().encode(),
                       METRICS_CONTENT_TYPE)
        else:
            self._reply(404, {"message": f"no route {self.path}"})

    def do_POST(self) -> None:  # noqa: N802
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        if self.path == "/reload":
            try:
                self.server.reload()
            except Exception as e:  # noqa: BLE001 — reported, state kept
                self._reply(500, {"message": str(e)})
                return
            self._reply(200, {
                "message": "Reloaded",
                "engineInstanceId": self.server.state.instance.id})
            return
        if self.path != "/queries.json":
            self._reply(404, {"message": f"no route {self.path}"})
            return
        self._query(body)

    def _query(self, body: bytes) -> None:
        """`/queries.json` through the serving plane, its outcomes mapped
        as the reference's handler maps them."""
        plane = self.server.serving
        try:
            query = fastjson.loads(body or b"{}")
            result, degraded = plane.handle_query(query, self.headers)
        except ShedLoad as e:
            # saturated and no degraded answer: an explicit, immediate
            # 429 beats queueing into collapse
            _QUERIES_FAILED.inc()
            self._reply(429, {"message": str(e)},
                        {"Retry-After": f"{e.retry_after_s:g}"})
            return
        except DeadlineExceeded as e:
            _QUERIES_FAILED.inc()
            retry_after = plane.config.admission.retry_after_s
            self._reply(503, {"message": str(e)},
                        {"Retry-After": f"{retry_after:g}"})
            return
        except FaultInjected as e:
            # an injected fault is a server error, not the client's
            _QUERIES_FAILED.inc()
            self._reply(500, {"message": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — a bad query is a 400
            _QUERIES_FAILED.inc()
            log.warning("Query failed: %s", e)
            self._reply(400, {"message": str(e)})
            return
        self._reply(200, result,
                    {"X-PIO-Degraded": "1"} if degraded else None)

    def log_message(self, fmt: str, *args) -> None:
        log.debug("%s - %s", self.address_string(), fmt % args)
