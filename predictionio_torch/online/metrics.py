"""online_* telemetry families for the online-learning plane — own copy
of the reference's ``predictionio_tpu/online/metrics.py``.

Module-level families, registered once on import. The fold-in
(`online/foldin.py`) counts `online_rows_folded_total` and
`online_cold_start_rows_total`; the other families are the online
plane's, which the port's plane will feed. The north-star series is
`online_event_to_servable_seconds`: observed once per folded event as
(swap time − event_time), i.e. the full event→servable path including
tail-poll latency, fold-in solve and the hot delta-swap.
"""

from predictionio_torch.telemetry.registry import REGISTRY

# event→servable spans group-commit + poll interval + solve + swap, so
# the interesting range is tenths of a second up to the 5 s bar and a
# decade past it for regressions
_E2S_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 3.0, 5.0, 10.0, 30.0)
_FOLD_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                 2.5, 5.0)

ONLINE_EVENTS_FOLDED = REGISTRY.counter(
    "online_events_folded_total",
    "Events consumed by the online plane and reflected in a served model")
ONLINE_ROWS_FOLDED = REGISTRY.counter(
    "online_rows_folded_total",
    "Factor rows re-solved by fold-in, by side", ("side",))
ONLINE_COLD_START_ROWS = REGISTRY.counter(
    "online_cold_start_rows_total",
    "Factor rows appended for never-seen entity ids, by side", ("side",))
ONLINE_SWAPS = REGISTRY.counter(
    "online_swaps_total",
    "Hot delta-swaps published into the served-state table", ("variant",))
ONLINE_STALE_SWAPS = REGISTRY.counter(
    "online_stale_swaps_total",
    "Delta-swaps dropped because a full /reload landed mid-fold (the "
    "batch is replayed against the new state on the next poll)")
ONLINE_FOLD_ERRORS = REGISTRY.counter(
    "online_fold_errors_total",
    "Fold passes that raised; the tail loop survives and replays")
ONLINE_FOLDIN_SECONDS = REGISTRY.histogram(
    "online_foldin_seconds",
    "Wall time of one fold pass (history gather + solves + swap)",
    buckets=_FOLD_BUCKETS)
ONLINE_EVENT_TO_SERVABLE = REGISTRY.histogram(
    "online_event_to_servable_seconds",
    "North star: event_time → served-model swap latency, one observation "
    "per folded event",
    buckets=_E2S_BUCKETS)
ONLINE_FAMILY_FRESHNESS = REGISTRY.histogram(
    "online_family_event_to_servable_seconds",
    "Per-model-family slice of event→servable latency (family=als|"
    "sessionrec|…), one observation per folded event per family that "
    "folded it",
    ("family",), buckets=_E2S_BUCKETS)
SESSION_WINDOWS_FOLDED = REGISTRY.counter(
    "session_windows_folded_total",
    "Per-user session windows rebuilt (and session embeddings "
    "recomputed) by the online session fold")
SESSION_COLD_ITEMS = REGISTRY.counter(
    "session_cold_items_total",
    "Distinct item ids dropped from session windows because the last "
    "retrain never embedded them (cold items fold in at the next "
    "retrain, mirroring ALS cold opposing rows)")
ONLINE_LAG = REGISTRY.gauge(
    "online_lag_seconds",
    "Age of the fold watermark at the end of the latest poll")
ONLINE_PARITY_DRIFT = REGISTRY.gauge(
    "online_parity_drift",
    "Max |served − re-solved| factor element over common rows at the "
    "latest full-retrain parity check, by variant", ("variant",))
ONLINE_PARITY_CHECKS = REGISTRY.counter(
    "online_parity_checks_total",
    "Full-retrain parity checks completed", ("variant",))
