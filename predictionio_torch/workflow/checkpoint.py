"""Per-step checkpoint/resume of a training run — the port of
``predictionio_tpu/workflow/checkpoint.py``, on the same on-disk format,
so a step written by either package restores in the other.

Format: one directory per step, ``step_N``, holding ``arrays.npz`` (the
numpy tree's leaves) and ``meta.json`` (the tree's structure and the
caller's metadata). A save writes a temporary directory and publishes it
with ``os.replace``: a crash mid-write never corrupts the latest complete
step. An overwrite renames the old step aside first (``step_N.old``), and
a manager salvages such a copy at construction.

The reference also opens a span around each save and restore
(`telemetry.spans`); the port has no span plane yet, and keeps the four
``checkpoint_*`` metrics on its registry.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import time
from typing import Any, Optional

import numpy as np

from predictionio_torch.telemetry.registry import REGISTRY
from predictionio_torch.utils import faults

log = logging.getLogger(__name__)

_STEP_RE = re.compile(r"^step_(\d+)$")

CKPT_SAVE_SECONDS = REGISTRY.histogram(
    "checkpoint_save_seconds", "Checkpoint save latency in seconds")
CKPT_RESTORE_SECONDS = REGISTRY.histogram(
    "checkpoint_restore_seconds", "Checkpoint restore latency in seconds")
CKPT_SAVES = REGISTRY.counter(
    "checkpoint_saves_total", "Checkpoint steps saved")
CKPT_RESTORES = REGISTRY.counter(
    "checkpoint_restores_total", "Checkpoint steps restored")


def _flatten(tree: Any, prefix: str = "") -> tuple[dict, Any]:
    """A (dict | list | tuple | leaf) tree → ({path: ndarray}, spec). The
    spec mirrors the tree with each leaf replaced by its path."""
    if isinstance(tree, dict):
        arrays: dict = {}
        spec = {}
        for k in sorted(tree):
            sub_arrays, sub_spec = _flatten(tree[k], f"{prefix}{k}/")
            arrays.update(sub_arrays)
            spec[k] = sub_spec
        return arrays, {"__dict__": spec}
    if isinstance(tree, (list, tuple)):
        arrays = {}
        spec_items = []
        for idx, item in enumerate(tree):
            sub_arrays, sub_spec = _flatten(item, f"{prefix}{idx}/")
            arrays.update(sub_arrays)
            spec_items.append(sub_spec)
        return arrays, {"__list__": spec_items,
                        "__tuple__": isinstance(tree, tuple)}
    path = prefix.rstrip("/") or "value"
    return {path: np.asarray(tree)}, {"__leaf__": path}


def _unflatten(spec: Any, arrays: dict) -> Any:
    if "__dict__" in spec:
        return {k: _unflatten(v, arrays) for k, v in spec["__dict__"].items()}
    if "__list__" in spec:
        items = [_unflatten(v, arrays) for v in spec["__list__"]]
        return tuple(items) if spec.get("__tuple__") else items
    return arrays[spec["__leaf__"]]


class CheckpointManager:
    """Save and restore numpy trees keyed by integer step, keeping the
    `keep` highest steps."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = max(1, keep)
        os.makedirs(self.directory, exist_ok=True)
        # a save that crashed between renaming a step aside and publishing
        # its replacement left `step_N.old`, the only complete copy
        for name in os.listdir(self.directory):
            if not name.endswith(".old"):
                continue
            orig = os.path.join(self.directory, name[: -len(".old")])
            aside = os.path.join(self.directory, name)
            if _STEP_RE.match(name[: -len(".old")]):
                if os.path.exists(orig):
                    shutil.rmtree(aside, ignore_errors=True)  # publish won
                else:
                    os.rename(aside, orig)
                    log.info("checkpoint: salvaged %s from interrupted "
                             "overwrite", orig)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def all_steps(self) -> list[int]:
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        steps = []
        for name in names:
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "meta.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any,
             metadata: Optional[dict] = None) -> str:
        t0 = time.perf_counter()
        out = self._save(step, tree, metadata)
        CKPT_SAVE_SECONDS.observe(time.perf_counter() - t0)
        CKPT_SAVES.inc()
        return out

    def _save(self, step: int, tree: Any, metadata: Optional[dict]) -> str:
        arrays, spec = _flatten(tree)
        tmp = os.path.join(self.directory, f".tmp_step_{step}_{os.getpid()}")
        final = self._step_dir(step)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        try:
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"step": step, "spec": spec,
                           "metadata": metadata or {}}, f)
            # overwrite: rename the old step aside (a crash between a
            # delete and the publish would lose it), publish, drop it
            old = None
            if os.path.exists(final):
                old = final + ".old"
                if os.path.exists(old):
                    shutil.rmtree(old)
                os.rename(final, old)
            faults.inject("checkpoint.pre_replace")
            os.replace(tmp, final)
            if old is not None:
                shutil.rmtree(old, ignore_errors=True)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        log.info("checkpoint: saved step %d → %s", step, final)
        return final

    def restore(self, step: Optional[int] = None) -> tuple[Any, dict]:
        """(tree, metadata) of `step`; None restores the latest."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"No checkpoints under {self.directory}")
        t0 = time.perf_counter()
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        out = _unflatten(meta["spec"], arrays), meta.get("metadata", {})
        CKPT_RESTORE_SECONDS.observe(time.perf_counter() - t0)
        CKPT_RESTORES.inc()
        return out

    def _gc(self) -> None:
        for step in self.all_steps()[: -self.keep]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def keep_only(self, step: Optional[int]) -> None:
        """Delete every saved step but `step` (None: every step). A run
        calls it at its first save: a previous run's higher steps would
        otherwise outrank the new saves under the keep-highest GC."""
        for s in self.all_steps():
            if s != step:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
