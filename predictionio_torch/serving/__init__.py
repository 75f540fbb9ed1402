"""Dynamic micro-batching serving plane — own copy of the reference's
``predictionio_tpu/serving``.

Sits between the HTTP layer (workflow/create_server.py) and the engine:

- `admission` — deadline-aware admission control: bounded queue depth,
  per-request deadlines from the `X-PIO-Deadline-Ms` header, load
  shedding (429 + Retry-After) when saturated, 503 on expired deadlines.
- `batcher` — per-engine-instance micro-batching: concurrent predict
  requests coalesce into one padded, fixed-bucket batched dispatch.
- `result_cache` — the opt-in per-user result cache, kept
  read-your-writes by the invalidation bus.
- `plane` — ServingPlane ties them together and carries the
  degraded-mode hook (the popularity answer instead of a 429).

The constraint inherited from ops/ranking.py stands: serving stays off
the device by default (max_batch ≤ the host-scoring threshold,
`SERVE_HOST_MAX_BATCH`); a configuration with a larger `max_batch`
scores its larger batches on the device.
"""

from predictionio_torch.serving.admission import (  # noqa: F401
    AdmissionConfig,
    AdmissionController,
    DeadlineExceeded,
    ShedLoad,
    deadline_from_headers,
)
from predictionio_torch.serving.batcher import (  # noqa: F401
    BatcherConfig,
    MicroBatcher,
)
from predictionio_torch.serving.plane import (  # noqa: F401
    ServingConfig,
    ServingPlane,
)
