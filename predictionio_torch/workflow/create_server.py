"""The `pio deploy` prediction server — the port of the reference's
``predictionio_tpu/workflow/create_server.py`` query route:

    POST /queries.json  {"user": "1", "num": 4}  → PredictedResult JSON
    GET  /              → status (engine, instance id)

It serves, on the standard library's `ThreadingHTTPServer`, either the
latest completed engine instance of the model repository (as the
reference does) or one model file; components are resolved once at load,
not per query. The reference's serving plane (micro-batching,
admission), reload and online planes come in later slices.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

import torch

from predictionio_torch.controller.engine import Engine, EngineParams
from predictionio_torch.data.events import format_time
from predictionio_torch.device import DeviceLike, resolve_device
from predictionio_torch.storage import base as storage_base
from predictionio_torch.storage.registry import Storage
from predictionio_torch.workflow.core_workflow import read_model_file
from predictionio_torch.workflow.workflow_utils import (
    EngineVariant,
    extract_engine_params,
    get_engine,
    read_engine_json,
)

log = logging.getLogger(__name__)


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
    """The served state of a deploy or a batch predict: the model file
    `model_path` when given, else the latest completed instance of the
    engine engine.json names (its id and variant) in `storage` (None:
    `Storage.get()`)."""
    if model_path:
        return load_served_state(engine_json, model_path, device)
    variant = read_engine_json(engine_json)
    return load_served_state_from_store(
        storage or Storage.get(), variant.id, engine_version,
        variant.variant, device)


class PredictionServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, engine_json: str, model_path: Optional[str] = None,
                 ip: str = "0.0.0.0", port: int = 8000,
                 device: DeviceLike = None, engine_version: str = "1",
                 storage: Optional[Storage] = None):
        """Serve the model file `model_path`, or without one the latest
        completed instance in `storage` (see `load_engine_state`)."""
        self.device = resolve_device(device)
        self.state = load_engine_state(engine_json, model_path, self.device,
                                       engine_version, storage)
        super().__init__((ip, port), _Handler)
        log.info("Deployed engine instance %s on %s", self.state.instance.id,
                 self.device)

    @property
    def port(self) -> int:
        return self.server_address[1]

    def predict(self, query: Any) -> Any:
        st = self.state
        return st.engine.predict(st.engine_params, st.models, query,
                                 components=st.components)

    def status(self) -> dict:
        instance = self.state.instance
        return {
            "status": "alive",
            "engineId": instance.engine_id,
            "engineVariant": instance.engine_variant,
            "engineFactory": instance.engine_factory,
            "engineInstanceId": instance.id,
            "startTime": format_time(instance.start_time),
            "device": str(self.device),
        }


class _Handler(BaseHTTPRequestHandler):
    server: PredictionServer
    protocol_version = "HTTP/1.1"

    def _reply(self, code: int, payload: Any) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json; charset=UTF-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 — http.server's spelling
        if self.path == "/":
            self._reply(200, self.server.status())
        else:
            self._reply(404, {"message": f"no route {self.path}"})

    def do_POST(self) -> None:  # noqa: N802
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        if self.path != "/queries.json":
            self._reply(404, {"message": f"no route {self.path}"})
            return
        try:
            query = json.loads(body or b"{}")
            result = self.server.predict(query)
        except Exception as e:  # noqa: BLE001 — a bad query is a 400
            log.warning("Query failed: %s", e)
            self._reply(400, {"message": str(e)})
            return
        self._reply(200, result)

    def log_message(self, fmt: str, *args) -> None:
        log.debug("%s - %s", self.address_string(), fmt % args)
