"""Chunked training with fingerprinted checkpoints — the port of
``predictionio_tpu/workflow/segmented.py``, single-process.

The checkpoint/resume contract of any step-loop trainer, `ops.als.als_train`
first. A trainer gives four callbacks over an opaque state and gets:

- without `checkpoint_dir`: the whole run as one chunk;
- with it: `checkpoint_every`-step chunks, the state saved after each
  (`CheckpointManager`), and a killed run resumed from its latest step to
  the uninterrupted result;
- a checkpoint resumes only the same run: a fingerprint of data and
  config that differs trains from scratch;
- a previous run's steps are purged at this run's first save, not at its
  start (which would leave a crash before that save nothing to resume);
- `faults.inject(fault_site)` at every chunk boundary, between the
  computed chunk and its save, so a kill drill reaches any trainer
  through one site name.

The reference also resolves a persist rank for multi-process runs (every
rank computes, one writes); the port runs one process, which writes.
"""

from __future__ import annotations

import hashlib
import logging
from typing import Any, Callable, Optional

import numpy as np

from predictionio_torch.utils import faults
from predictionio_torch.workflow.checkpoint import CheckpointManager

log = logging.getLogger(__name__)


def fingerprint_of(*parts: Any) -> str:
    """blake2b (8 bytes, hex) over bytes, ndarray and repr'd parts."""
    h = hashlib.blake2b(digest_size=8)
    for p in parts:
        if isinstance(p, bytes):
            h.update(p)
        elif isinstance(p, np.ndarray):
            h.update(np.ascontiguousarray(p).tobytes())
        else:
            h.update(repr(p).encode())
    return h.hexdigest()


def segmented_train(
    *,
    total_steps: int,
    init_state: Callable[[], Any],
    run_chunk: Callable[[Any, int, int], tuple[Any, list]],
    state_to_host: Callable[[Any], dict],
    state_from_host: Callable[[dict], Any],
    fingerprint: str,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    fault_site: str = "segment.boundary",
    name: str = "train",
    resume: bool = True,
    history_key: str = "history",
    metadata: Optional[dict] = None,
) -> tuple[Any, list, int]:
    """Run `total_steps` steps of a trainer, checkpointed when
    `checkpoint_dir` is set. Returns `(state, history, start_step)`:
    `history` holds one metric per absolute step (a resumed prefix from
    the checkpoint's metadata), `start_step` the step resumed from (0 for
    a fresh run).

    Callbacks:
    - `init_state()` → a fresh state.
    - `run_chunk(state, n_steps, done)` → `(state, step_metrics)`, `done`
      the steps before the chunk. It must finish the device work before
      it returns, so that the fault site and the save see it.
    - `state_to_host(state)` → a numpy tree for `CheckpointManager.save`.
    - `state_from_host(tree)` → a state; raising on a foreign or
      mismatched tree trains from scratch.

    The history is saved in each step's metadata under `history_key`,
    beside `metadata` (the trainer's own keys); a restored history
    shorter than its step is padded with NaN, so that it stays one entry
    a step.
    """
    history: list = []
    start_step = 0
    state = None
    manager = None
    restore_step = None
    if checkpoint_dir and total_steps > 0:
        manager = CheckpointManager(checkpoint_dir)
        if resume:
            usable = [s for s in manager.all_steps() if s <= total_steps]
            if usable:
                tree, meta = manager.restore(usable[-1])
                if meta.get("fingerprint") == fingerprint:
                    try:
                        state = state_from_host(tree)
                    except Exception as e:  # noqa: BLE001 — any misfit
                        log.warning("%s: checkpoint step %d unusable (%s) "
                                    "— training from scratch",
                                    name, usable[-1], e)
                        state = None
                if state is not None:
                    start_step = restore_step = usable[-1]
                    history = list(meta.get(history_key, []))[:start_step]
                    history += [float("nan")] * (start_step - len(history))
                    log.info("%s: resumed from checkpoint step %d",
                             name, restore_step)
                else:
                    log.warning(
                        "%s: checkpoint at %s is from different data/config "
                        "(or a foreign tree) — training from scratch",
                        name, checkpoint_dir)
    if state is None:
        state = init_state()

    every = max(1, checkpoint_every or total_steps)
    done = start_step
    first_save_done = False
    while done < total_steps:
        n_steps = (min(every, total_steps - done)
                   if manager else total_steps - done)
        state, metrics = run_chunk(state, n_steps, done)
        done += n_steps
        history.extend(metrics)
        faults.inject(fault_site)
        if manager:
            if not first_save_done:
                manager.keep_only(restore_step)
                first_save_done = True
            manager.save(done, state_to_host(state),
                         metadata={**(metadata or {}),
                                   history_key: [float(v) for v in history],
                                   "total_steps": total_steps,
                                   "fingerprint": fingerprint})
    if manager and not first_save_done and restore_step is not None:
        # a fully resumed run saved nothing: purge the stale steps now
        # (the restore point stays, so no crash window opens)
        manager.keep_only(restore_step)
    return state, history, start_step
