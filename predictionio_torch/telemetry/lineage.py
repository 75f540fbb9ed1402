"""Causal event lineage — own copy of the parts of the reference's
``predictionio_tpu/telemetry/lineage.py`` that storage and the store
tailer call.

A `CausalContext` is minted (`mint`) when the event server admits a
write, rides through the group-commit writer into the durable store as a
`pio_lineage` properties envelope (written by the sqlite backend,
stripped again on read, so clients never see it) and is re-attached to
the event by the read path; the tailer reports each pickup through
`LINEAGE.record_stage`. The reference takes a context's trace id from
the open request trace and its app from the tenant binding; the port has
neither, so `mint` draws a fresh id and takes the app from its caller.
The reference's per-event timelines, tail sampling and debug routes come
with the port's serving plane; this recorder keeps the exact stage counts
and the latest origin→stage lag.
"""

from __future__ import annotations

import random
import time
from typing import Optional

from predictionio_torch.telemetry.registry import REGISTRY

# The properties key the storage layer carries the context under. Safe
# against spoofing: validate_event rejects any client-supplied property
# key starting with "pio_".
ENVELOPE_KEY = "pio_lineage"

LINEAGE_STAGES = REGISTRY.counter(
    "lineage_stages_total",
    "Lineage stage records, by stage (exact; unaffected by sampling)",
    labelnames=("stage",))
LINEAGE_STAGE_LAG = REGISTRY.gauge(
    "lineage_stage_lag_seconds",
    "Origin→stage lag of the most recent record, by stage "
    "(tailer_pickup = watermark lag)",
    labelnames=("stage",))


class CausalContext:
    """The compact per-event coordinates that cross the store boundary.

    `origin_wall` is the shared time axis (writer and tailer may be
    different processes over one database file); `origin_mono` is only
    meaningful inside the minting process. `hop` counts recorded
    stages."""

    __slots__ = ("trace_id", "origin_wall", "origin_mono", "hop", "debug",
                 "app")

    def __init__(self, trace_id: str, origin_wall: float,
                 origin_mono: Optional[float] = None, hop: int = 0,
                 debug: bool = False, app: str = ""):
        self.trace_id = trace_id
        self.origin_wall = origin_wall
        self.origin_mono = origin_mono
        self.hop = hop
        self.debug = debug
        self.app = app

    def to_dict(self) -> dict:
        # short keys: this rides inside every stored event's properties
        d = {"t": self.trace_id, "w": self.origin_wall, "h": self.hop}
        if self.debug:
            d["d"] = 1
        if self.app:
            d["a"] = self.app
        return d

    @classmethod
    def from_dict(cls, d) -> Optional["CausalContext"]:
        """Parse a stored envelope; None on junk (a hand-edited row must
        not wedge the tailer). Envelopes without "a" leave app ""."""
        try:
            return cls(trace_id=str(d["t"]), origin_wall=float(d["w"]),
                       hop=int(d.get("h", 0)), debug=bool(d.get("d")),
                       app=str(d.get("a", "")))
        except (TypeError, KeyError, ValueError):
            return None


def _new_id() -> str:
    """A 64-bit trace id, 16 hex digits (the reference's format)."""
    return f"{random.getrandbits(64):016x}"


def mint(app) -> CausalContext:
    """A fresh context, originating now, with a new trace id, for the app
    `app` (the access key's app id at the event server)."""
    return CausalContext(trace_id=_new_id(), origin_wall=time.time(),
                         origin_mono=time.monotonic(), app=str(app))


def context_of(event) -> Optional[CausalContext]:
    """The context attached to an event, if any plane attached one."""
    return getattr(event, "lineage_ctx", None)


class LineageRecorder:
    """Exact per-stage record counts and the latest origin→stage lag."""

    def record_stage(self, ctx: Optional[CausalContext], stage: str,
                     duration_s: float = 0.0, error: bool = False,
                     detail: Optional[str] = None,
                     now: Optional[float] = None) -> None:
        """Count one stage of the event's journey; no-op without a
        context."""
        if ctx is None:
            return
        if now is None:
            now = time.time()
        LINEAGE_STAGES.labels(stage=stage).inc()
        LINEAGE_STAGE_LAG.labels(stage=stage).set(
            max(0.0, now - ctx.origin_wall))
        ctx.hop += 1


LINEAGE = LineageRecorder()
