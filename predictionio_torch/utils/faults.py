"""Fault-injection points — own copy of the reference's
``predictionio_tpu/utils/faults.py``.

Production code marks the moments a crash-consistency or resilience
claim is about with `faults.inject("site")`; a test arms a site via the
`PIO_FAULTS` env var:

    PIO_FAULTS=events.batch.pre_commit:3     # hard-die at the 3rd hit
    PIO_FAULTS=a.site,b.site:2               # multiple sites
    PIO_FAULTS=sqlite.pre_commit=delay:300   # sleep 300 ms per hit
    PIO_FAULTS=sqlite.pre_commit:2=error     # raise FaultInjected from the 2nd hit on

Modes:
- (default) `die` — `os._exit(137)`: no atexit handlers, no flushing,
  like SIGKILL. Fires once the hit count is reached.
- `delay:<ms>` — sleep that many milliseconds at the site, every hit
  from the armed count onward.
- `error` — raise `FaultInjected` at the site, every hit from the armed
  count onward.

Unarmed sites cost one dict lookup on a module-level map that is empty
when PIO_FAULTS is unset.

Sites in the port:
- `sqlite.pre_commit` — in the sqlite backend between a transaction's
  statements and its COMMIT; `delay:` here widens the write-lock window
  to reproduce `database is locked` contention
- `events.batch.pre_commit` — after a batch insert's `executemany`,
  before the transaction commits
- `events.group.pre_commit` — after a group-commit insert's
  `executemany`, before the shared transaction commits
- `als.epoch_boundary` — in `ops.als.als_train` (its `segmented_train`) after each chunk of
  epochs is computed, before its checkpoint save (`:N` dies after the
  N-th chunk, which leaves step N − 1 to resume from at
  `--checkpoint-every 1`)
- `logreg.step_boundary` — in `ops.classify.logreg_train` (its
  `segmented_train`) after each chunk of Adam steps is computed, before
  its checkpoint save (`:N` dies after the N-th chunk)
- `w2v.step_boundary` — in `ops.text.word2vec_fit_pairs` (its
  `segmented_train`) after each chunk of SGNS steps is computed, before
  its checkpoint save (`:N` dies after the N-th chunk)
- `checkpoint.pre_replace` — in `CheckpointManager.save`, the step written
  to its temporary directory and the old step renamed aside, before the
  publishing `os.replace`
- `segment.boundary` — `workflow.segmented.segmented_train`'s default
  site, at each chunk boundary before its save
"""

from __future__ import annotations

import os
import threading
import time


class FaultInjected(RuntimeError):
    """Raised by an armed `error`-mode fault site."""


# site -> (hit threshold, mode, delay_ms)
_armed: dict[str, tuple[int, str, int]] = {}
_hits: dict[str, int] = {}
_hits_lock = threading.Lock()
_parsed_from: str = ""


def _parse() -> None:
    global _parsed_from, _armed, _hits
    spec = os.environ.get("PIO_FAULTS", "")
    if spec == _parsed_from:
        return
    # mark the spec seen (and disarm) before parsing: a bad spec raises
    # once, at arm time — later inject() calls must not re-raise it
    _parsed_from = spec
    _armed = {}
    _hits = {}
    armed: dict[str, tuple[int, str, int]] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        mode, delay_ms = "die", 0
        if "=" in part:
            part, mode_spec = part.split("=", 1)
            if mode_spec.startswith("delay:"):
                mode, delay_ms = "delay", int(mode_spec[len("delay:"):])
            elif mode_spec == "error":
                mode = "error"
            elif mode_spec == "die":
                mode = "die"
            else:
                raise ValueError(f"unknown PIO_FAULTS mode {mode_spec!r}")
        if ":" in part:
            site, n = part.rsplit(":", 1)
            armed[site] = (int(n), mode, delay_ms)
        else:
            armed[part] = (1, mode, delay_ms)
    # rebind, don't clear-and-refill: an inject() racing the re-arm must
    # see either the old map or the new one, never a half-built map
    _armed = armed


def inject(site: str) -> None:
    """Fire `site`'s armed fault if its hit count is reached. A no-op
    (one env read + dict lookup) otherwise.

    `die` fires once (the process exits). `delay`/`error` fire on every
    hit from the armed count onward — a misbehaving dependency stays
    misbehaving until the supervisor (or the test) intervenes."""
    _parse()
    if not _armed:
        return
    entry = _armed.get(site)
    if entry is None:
        return
    n, mode, delay_ms = entry
    with _hits_lock:
        hits = _hits[site] = _hits.get(site, 0) + 1
    if hits < n:
        return
    if mode == "die":
        # stderr survives even though buffers don't get flushed on _exit
        os.write(2, f"PIO_FAULTS: dying at {site}\n".encode())
        os._exit(137)
    elif mode == "delay":
        time.sleep(delay_ms / 1000.0)
    else:  # error
        raise FaultInjected(f"PIO_FAULTS: injected error at {site}")
