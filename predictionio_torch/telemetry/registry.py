"""Process-wide metrics registry with Prometheus text exposition — own copy
of the reference's ``predictionio_tpu/telemetry/registry.py``, without
its exemplars (they link a bucket to a request trace, and the port has
no request tracing yet) and its exposition parser.

Zero-dependency Counter/Gauge/Histogram in the Prometheus data model:
pull-based, rendered on demand by `MetricsRegistry.render()`.

Thread-safety: every metric family holds one lock guarding its child map
and all child values; render() takes the same locks family by family so
a scrape never sees a torn histogram (count ahead of buckets).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterable, Sequence, Tuple

# Latency-oriented defaults (seconds), the shape of prometheus/client_python's.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

_INF = float("inf")


def _format_value(v: float) -> str:
    if v == _INF:
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v)


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _render_labels(labelnames: Sequence[str], labelvalues: Sequence[str],
                   extra: Sequence[Tuple[str, str]] = ()) -> str:
    pairs = list(zip(labelnames, labelvalues)) + list(extra)
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(str(v))}"' for k, v in pairs)
    return "{" + inner + "}"


class _Child:
    """One labelled time series of a Counter or Gauge."""

    __slots__ = ("_value", "_lock")

    def __init__(self, lock: threading.Lock):
        self._value = 0.0
        self._lock = lock

    @property
    def value(self) -> float:
        return self._value

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value


class _HistogramChild:
    """One labelled histogram series: per-bucket counts + sum."""

    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, lock: threading.Lock, buckets: Tuple[float, ...]):
        self._lock = lock
        self.buckets = buckets
        self.counts = [0] * len(buckets)  # per-bucket (non-cumulative) counts
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        with self._lock:
            self.sum += value
            self.count += 1
            # above the last finite bound → only the implicit +Inf bucket,
            # which is rendered as `count`
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    self.counts[i] += 1
                    break


class _MetricFamily:
    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 metric_type: str):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.type = metric_type
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def _key(self, labelkw: Dict[str, str]) -> Tuple[str, ...]:
        if set(labelkw) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} expects labels {self.labelnames}, "
                f"got {tuple(sorted(labelkw))}")
        return tuple(str(labelkw[n]) for n in self.labelnames)


class Counter(_MetricFamily):
    """Monotonic counter family. `labels(**kw).inc()`; `inc()` shorthand
    when the family has no labels."""

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames, "counter")

    def labels(self, **labelkw: str) -> _Child:
        key = self._key(labelkw)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _Child(self._lock)
        return child

    def inc(self, amount: float = 1.0) -> None:
        if self.labelnames:
            raise ValueError(f"metric {self.name!r} needs labels()")
        self.labels().inc(amount)

    @property
    def value(self) -> float:
        if self.labelnames:
            raise ValueError(f"metric {self.name!r} needs labels()")
        return self.labels().value

    def collect(self) -> Iterable[Tuple[Tuple[str, ...], float]]:
        with self._lock:
            return [(k, c.value) for k, c in self._children.items()]


class Gauge(Counter):
    """Like Counter, but can go down (`set`, `dec`)."""

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        _MetricFamily.__init__(self, name, help, labelnames, "gauge")

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set(self, value: float) -> None:
        if self.labelnames:
            raise ValueError(f"metric {self.name!r} needs labels()")
        self.labels().set(value)


class Histogram(_MetricFamily):
    """Histogram family with fixed bucket boundaries (seconds by default)."""

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, "histogram")
        bl = tuple(sorted(float(b) for b in buckets))
        if not bl:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = bl

    def labels(self, **labelkw: str) -> _HistogramChild:
        key = self._key(labelkw)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _HistogramChild(
                    self._lock, self.buckets)
        return child

    def observe(self, value: float) -> None:
        if self.labelnames:
            raise ValueError(f"metric {self.name!r} needs labels()")
        self.labels().observe(value)

    def collect(self):
        with self._lock:
            return [(k, (list(c.counts), c.sum, c.count))
                    for k, c in self._children.items()]


class MetricsRegistry:
    """Get-or-create metric families; renders them all as Prometheus text."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _MetricFamily] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw) -> _MetricFamily:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or (
                        existing.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.type} with labels {existing.labelnames}")
                return existing
            metric = cls(name, help, labelnames, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def families(self) -> list:
        """All registered families, name-sorted (stable scrape order)."""
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: list[str] = []
        for m in self.families():
            lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.type}")
            if isinstance(m, Histogram):
                for key, (counts, total, count) in sorted(m.collect()):
                    cum = 0
                    for bound, n in zip(m.buckets, counts):
                        cum += n
                        labels = _render_labels(
                            m.labelnames, key,
                            extra=[("le", _format_value(bound))])
                        lines.append(f"{m.name}_bucket{labels} {cum}")
                    inf_labels = _render_labels(m.labelnames, key,
                                                extra=[("le", "+Inf")])
                    lines.append(f"{m.name}_bucket{inf_labels} {count}")
                    labels = _render_labels(m.labelnames, key)
                    lines.append(f"{m.name}_sum{labels} {_format_value(total)}")
                    lines.append(f"{m.name}_count{labels} {count}")
            else:
                for key, value in sorted(m.collect()):
                    labels = _render_labels(m.labelnames, key)
                    lines.append(f"{m.name}{labels} {_format_value(value)}")
        return "\n".join(lines) + "\n"


# The process-wide default registry.
REGISTRY = MetricsRegistry()

# the Prometheus text exposition format the servers' GET /metrics answers
METRICS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# Bounded label cardinality for request-derived label values (an event
# name straight from a client payload): the first DEFAULT_LABEL_CAP
# distinct values of a group keep their own series, later ones collapse
# to LABEL_OVERFLOW.
LABEL_OVERFLOW = "<other>"
DEFAULT_LABEL_CAP = 64

_label_caps_lock = threading.Lock()
_label_caps: Dict[str, set] = {}


def capped_label(group: str, value: str,
                 cap: int = DEFAULT_LABEL_CAP) -> str:
    """Admit `value` into the named label group until `cap` distinct
    values exist; later never-seen values collapse to ``<other>``. Values
    seen before the cap keep resolving to themselves."""
    value = str(value)
    with _label_caps_lock:
        seen = _label_caps.setdefault(group, set())
        if value in seen:
            return value
        if len(seen) < cap:
            seen.add(value)
            return value
    return LABEL_OVERFLOW


def _reinit_locks_after_fork() -> None:
    # a child inheriting a lock held by another thread of the parent would
    # deadlock on its first metric touch; locks only guard intra-process
    # consistency, so fresh ones are safe
    global _label_caps_lock
    REGISTRY._lock = threading.Lock()
    _label_caps_lock = threading.Lock()
    for family in REGISTRY._metrics.values():
        new_lock = threading.Lock()
        family._lock = new_lock
        for child in family._children.values():
            child._lock = new_lock


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reinit_locks_after_fork)
