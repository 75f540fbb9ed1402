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

import json
import logging
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from predictionio_torch.device import DeviceLike, resolve_device
from predictionio_torch.workflow.core_workflow import read_model_file
from predictionio_torch.workflow.workflow_utils import (
    extract_engine_params,
    get_engine,
    read_engine_json,
)

log = logging.getLogger(__name__)


class PredictionServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, engine_json: str, model_path: str, ip: str = "0.0.0.0",
                 port: int = 8000, device: DeviceLike = None):
        self.device = resolve_device(device)
        variant = read_engine_json(engine_json)
        self.instance, models = read_model_file(model_path)
        if self.instance.engine_factory != variant.engine_factory:
            raise ValueError(
                f"model file {model_path} was trained by "
                f"{self.instance.engine_factory}, engine.json names "
                f"{variant.engine_factory}")
        self.engine = get_engine(variant.engine_factory)
        self.engine_params = extract_engine_params(self.engine, variant)
        for model in models:
            # bulk scoring of a model runs on the server's device
            if hasattr(model, "device"):
                model.device = str(self.device)
        self.models = models
        self.components = self.engine.components(self.engine_params)
        super().__init__((ip, port), _Handler)
        log.info("Deployed engine instance %s on %s", self.instance.id,
                 self.device)

    @property
    def port(self) -> int:
        return self.server_address[1]

    def predict(self, query: Any) -> Any:
        return self.engine.predict(self.engine_params, self.models, query,
                                   components=self.components)

    def status(self) -> dict:
        return {
            "status": "alive",
            "engineId": self.instance.engine_id,
            "engineVariant": self.instance.engine_variant,
            "engineFactory": self.instance.engine_factory,
            "engineInstanceId": self.instance.id,
            "startTime": self.instance.start_time,
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
