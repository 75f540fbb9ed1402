"""Ingest: the event server's write plane and the store tailer — own copy
of the reference's ``predictionio_tpu/ingest``.

`GroupCommitWriter` sits between the event server's handlers and the
`LEvents` backends, coalescing concurrent single-event inserts into one
shared transaction and shedding with 429 + Retry-After past a bounded
in-flight budget (writer.py). `StoreTailer` turns the durable store into
a push feed for the online plane (tailer.py).
"""

from predictionio_torch.ingest.tailer import StoreTailer
from predictionio_torch.ingest.writer import (
    GroupCommitWriter,
    IngestConfig,
    IngestOverload,
)

__all__ = ["GroupCommitWriter", "IngestConfig", "IngestOverload",
           "StoreTailer"]
