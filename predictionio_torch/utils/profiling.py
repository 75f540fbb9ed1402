"""Tracing, per-epoch metrics and numeric-debug flags — the port of the
parts of ``predictionio_tpu/utils/profiling.py`` that need no telemetry
plane:

- `maybe_trace(profile_dir)`: a `torch.profiler` capture of the host and
  the card, written as a Chrome trace (`trace.json`, loadable in Perfetto
  or chrome://tracing) into `profile_dir`. `console train --profile-dir`.
- `annotate(name)`: a named range on that trace.
- `MetricsLogger`: one JSON-lines record a metric emission (per-epoch
  RMSE and epoch time), appended to a file, and a log line.
  `console train --metrics-file`.
- `set_debug_flags`: the numeric asserts of `--debug-nans` and
  `--check-asserts`.

The reference's `metered_jit` and its xplane readers wait for the port's
device telemetry.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Any, Optional, TextIO

log = logging.getLogger(__name__)

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def maybe_trace(profile_dir: Optional[str]):
    """Capture a host and device trace of the block into
    `profile_dir`/trace.json when `profile_dir` is set, else nothing. The
    device half is traced only where CUDA is available."""
    if not profile_dir:
        yield None
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    log.info("profiling: tracing to %s", profile_dir)
    with torch.profiler.profile(activities=activities) as prof:
        yield profile_dir
    path = os.path.join(profile_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    log.info("profiling: trace written to %s", path)


def annotate(name: str):
    """A named range on the trace's timeline (around DASE stages)."""
    import torch

    return torch.profiler.record_function(name)


def set_debug_flags(nan_check: bool = False,
                    check_asserts: bool = False) -> None:
    """Numeric asserts for the train loop. `check_asserts` arms the assert
    mode of `utils/checks.py`: the factors are checked finite after each
    half-epoch. torch has no counterpart of the reference's
    `jax_debug_nans` (which re-runs every jitted program with NaN
    detection), so `nan_check` arms the same finite asserts."""
    if nan_check or check_asserts:
        from predictionio_torch.utils import checks

        checks.enable(True)
        if nan_check:
            log.info("profiling: --debug-nans armed as finite asserts")


class MetricsLogger:
    """Structured metrics → the log and, with a path, one JSON line each,
    appended:

        {"ts": ..., "stage": "train/als", "run": "...", "step": 3,
         "rmse": 0.81, "epoch_time_s": 0.011}
    """

    def __init__(self, path: Optional[str] = None, run: str = ""):
        self.run = run
        self._fh: Optional[TextIO] = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def emit(self, stage: str, step: Optional[int] = None,
             **metrics: Any) -> dict:
        record: dict[str, Any] = {"ts": time.time(), "stage": stage}
        if self.run:
            record["run"] = self.run
        if step is not None:
            record["step"] = step
        record.update(metrics)
        pretty = " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in metrics.items())
        log.info("metrics[%s]%s %s", stage,
                 f" step={step}" if step is not None else "", pretty)
        if self._fh:
            json.dump(record, self._fh)
            self._fh.write("\n")
        return record

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NullMetricsLogger(MetricsLogger):
    """Emits to the log only; a context's default."""

    def __init__(self):
        super().__init__(path=None)
