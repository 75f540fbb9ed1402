"""BatchPredict — bulk scoring from a queries file: the port of
``predictionio_tpu/workflow/batch_predict.py``.

Reads JSON-lines queries, scores them all through the engine's
`predict_batch` (each algorithm's vectorized `batch_predict`, then Serving
per query) on the run's device, and writes JSON-lines
{"query": ..., "prediction": ...} results in input order. The model comes
from the model repository or a model file, as `console deploy` serves it.
"""

from __future__ import annotations

import json
import logging
from typing import Optional

from predictionio_torch.device import DeviceLike, resolve_device
from predictionio_torch.storage.registry import Storage
from predictionio_torch.workflow.create_server import load_engine_state

log = logging.getLogger(__name__)


def run_batch_predict(input_path: str, output_path: str, engine_json: str,
                      model_path: Optional[str] = None,
                      device: DeviceLike = None, engine_version: str = "1",
                      storage: Optional[Storage] = None) -> int:
    """Score every query of `input_path` into `output_path` with the model
    `load_engine_state` finds; returns the number of queries scored."""
    state = load_engine_state(engine_json, model_path,
                              resolve_device(device), engine_version,
                              storage)
    queries = []
    with open(input_path) as f:
        for line in f:
            line = line.strip()
            if line:
                queries.append(json.loads(line))
    predictions = state.engine.predict_batch(
        state.engine_params, state.models, queries,
        components=state.components)
    with open(output_path, "w") as f:
        for query, prediction in zip(queries, predictions):
            f.write(json.dumps({"query": query, "prediction": prediction})
                    + "\n")
    log.info("BatchPredict: scored %d queries → %s", len(queries),
             output_path)
    return len(queries)
