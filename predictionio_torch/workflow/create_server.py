"""The `pio deploy` prediction server — the port of the reference's
``predictionio_tpu/workflow/create_server.py`` query route:

    POST /queries.json  {"user": "1", "num": 4}  → PredictedResult JSON
    GET  /              → status (engine, instance id)

It serves one model file on the standard library's `ThreadingHTTPServer`;
components are resolved once at load, not per query. The reference's
serving plane (micro-batching, admission), reload and online planes come
in later slices.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import torch

from predictionio_torch.controller.engine import Engine, EngineParams
from predictionio_torch.device import DeviceLike, resolve_device
from predictionio_torch.workflow.core_workflow import (
    EngineInstance,
    read_model_file,
)
from predictionio_torch.workflow.workflow_utils import (
    extract_engine_params,
    get_engine,
    read_engine_json,
)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ServedState:
    """What serving one model file needs, resolved once."""

    instance: EngineInstance
    engine: Engine
    engine_params: EngineParams
    models: list
    components: tuple


def load_served_state(engine_json: str, model_path: str,
                      device: torch.device) -> ServedState:
    """Load a model file for the engine that engine.json names (refusing a
    model another engine trained), with every model's bulk scoring set to
    `device`: the device of the run, not the one pickled with the model."""
    variant = read_engine_json(engine_json)
    instance, models = read_model_file(model_path)
    if instance.engine_factory != variant.engine_factory:
        raise ValueError(
            f"model file {model_path} was trained by "
            f"{instance.engine_factory}, engine.json names "
            f"{variant.engine_factory}")
    engine = get_engine(variant.engine_factory)
    engine_params = extract_engine_params(engine, variant)
    for model in models:
        if hasattr(model, "device"):
            model.device = str(device)
    return ServedState(instance, engine, engine_params, models,
                       engine.components(engine_params))


class PredictionServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, engine_json: str, model_path: str, ip: str = "0.0.0.0",
                 port: int = 8000, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.state = load_served_state(engine_json, model_path, self.device)
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
            "startTime": instance.start_time,
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
