"""FoldIn: incremental single-side ALS solves against fixed opposing
factors — the port of ``predictionio_tpu/online/foldin.py``.

ALS alternation already solves each side's rows independently — one row's
normal equations (Σ_j y_j y_jᵀ + λ·n·I) x = Σ_j r_j y_j never read another
row of the same side. Fold-in exploits that: when events touch a handful
of users/items, re-solve exactly those rows against the *fixed* opposite
factors instead of retraining. The solve is one
`ops.als._solve_buckets_device` half-epoch restricted to the dirty rows —
same `bucket_ragged` capacity ladder and per-row column sort, same masked
f32 Gram products, same weighted regularization and solver, so on the
card it launches the same solve kernels as training.

The buckets are built on the host (numpy, as training's are) and
uploaded; the opposing factors stay on the device. Every solve is one
bucket whose shape sits on fixed ladders: rows on the power-of-4 tier
{8, 32, 128} (`MAX_ROWS_PER_SOLVE` chunks a larger batch), capacity on
the power-of-4 tier {8, 32, 128, …} of the widest history, the opposing
matrix padded to its own power-of-4 tier. PyTorch does not recompile per
shape, but the shapes pick the kernels and the batched products'
reductions, so the ladders are what make a row folded alone bit-equal to
the same row folded inside a batch of the same tier.

Never-seen entity ids get appended rows: the BiMap grows at the end (old
codes keep their factor rows), the factor matrix gains zero rows, and the
next solve fills them. A zero opposing row contributes nothing to a
neighbor's normal equations, so cold items referenced from a user's
history before their own fold are simply ignored — matching what a
retrain without that item would have served.

Hot rows are NOT segment-split here (train's `bucket_ragged_split`): a
fold batch touches few rows, so one bucket per cap is cheap, and
splitting would change f32 partial-sum association.

The reference attributes each fold's device time to the online plane;
the port's device telemetry is not ported yet, so nothing is attributed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_torch.data.bimap import BiMap
from predictionio_torch.device import DeviceLike, resolve_device
from predictionio_torch.models.als_model import ALSModel
from predictionio_torch.online.metrics import (
    ONLINE_COLD_START_ROWS,
    ONLINE_ROWS_FOLDED,
)
from predictionio_torch.ops.als import (
    ALSConfig,
    Bucket,
    _bucket_chunk_rows,
    _put_buckets,
    _solve_buckets_device,
    bucket_ragged,
    resolve_solver,
)
from predictionio_torch.ops.ranking import Factors

# fold batches chunk into row-tier-ladder solves — see solve_rows
MAX_ROWS_PER_SOLVE = 128


def _tier(n: int) -> int:
    """The power-of-4 tier {8, 32, 128, …} that holds `n`."""
    t = 8
    while t < n:
        t *= 4
    return t


def fold_bucket(entries: Sequence[Tuple[np.ndarray, np.ndarray]], k: int,
                cap_growth: float) -> tuple[Bucket, int]:
    """The host half of a fold solve: the one bucket that holds every
    entry's row, and the row tier it is padded to (the solve's output
    rows). Row i of the batch is bucket row id i; scratch rows carry id
    n = len(entries), which the solve writes and the caller slices off."""
    n = len(entries)
    rows = np.concatenate([
        np.full(len(c), i, dtype=np.int32)
        for i, (c, _) in enumerate(entries)] or [np.zeros(0, np.int32)])
    cols = np.concatenate([np.asarray(c, np.int32) for c, _ in entries])
    vals = np.concatenate([np.asarray(v, np.float32) for _, v in entries])
    buckets = bucket_ragged(rows, cols, vals, n_rows=n,
                            cap_growth=cap_growth)
    # one bucket on a coarse ladder: all ragged buckets pad to the
    # power-of-4 cap tier of the WIDEST history and merge (a masked pad
    # entry adds an exact-zero term to the Gram sum, so rows stay
    # bit-identical to their own-capacity solve)
    tcap = _tier(max(b.cols.shape[1] for b in buckets))
    parts = []
    for b in buckets:
        wpad = ((0, 0), (0, tcap - b.cols.shape[1]))
        parts.append((b.rows, np.pad(b.cols, wpad), np.pad(b.vals, wpad),
                      np.pad(b.mask, wpad)))
    br, bc, bv, bm = (np.concatenate([p[i] for p in parts])
                      for i in range(4))
    # bucket_ragged pads each bucket's rows to a multiple of 8 with
    # scratch rows (id = n, mask 0); after a merge that leftover varies
    # with how the ladder happened to group histories, which would leak
    # data-dependent row counts into the solve's shape. Strip it, leaving
    # exactly one bucket row per entry, then re-pad onto the
    # deterministic tier for `n`...
    real = br != n
    br, bc, bv, bm = br[real], bc[real], bv[real], bm[real]
    target = _tier(n)
    # ... and to a chunk multiple so _solve_buckets_device's chunk walk
    # covers the bucket exactly
    chunk = _bucket_chunk_rows(target, tcap, k, 8)
    pad = (target - n) + ((-target) % chunk)
    if pad:
        br = np.concatenate([br, np.full(pad, n, np.int32)])
        bc = np.concatenate([bc, np.zeros((pad, tcap), bc.dtype)])
        bv = np.concatenate([bv, np.zeros((pad, tcap), bv.dtype)])
        bm = np.concatenate([bm, np.zeros((pad, tcap), bm.dtype)])
    return Bucket(br, bc, bv, bm), target


def solve_rows(opposing: Factors,
               entries: Sequence[Tuple[np.ndarray, np.ndarray]],
               cfg: ALSConfig, device: DeviceLike = None) -> torch.Tensor:
    """Solve the normal equations of `len(entries)` independent rows
    against fixed `opposing` [V, K] factors.

    `entries[i]` is `(cols, vals)` — opposing-row ids and ratings of the
    i-th dirty row's FULL history. Tensor `opposing` solves on its own
    device; numpy `opposing` is uploaded to `device`
    (`device.resolve_device`). Returns a [len(entries), K] tensor there.
    A row with an empty history solves to zeros (its bucket row is all
    padding), same as an eventless row in train."""
    cfg = resolve_solver(cfg)
    if isinstance(opposing, torch.Tensor):
        dev = opposing.device
    else:
        dev = resolve_device(device)
        opposing = torch.as_tensor(np.asarray(opposing), device=dev)
    n = len(entries)
    k = opposing.shape[-1]
    if n == 0:
        return torch.zeros((0, k), dtype=opposing.dtype, device=dev)
    if n > MAX_ROWS_PER_SOLVE:
        # rows are independent (the whole fold-in premise), so a large
        # backlog chunks into solves on the fixed row ladder
        return torch.cat([
            solve_rows(opposing, entries[i:i + MAX_ROWS_PER_SOLVE], cfg)
            for i in range(0, n, MAX_ROWS_PER_SOLVE)])
    bucket, target = fold_bucket(entries, k, cfg.cap_growth)
    # the opposing matrix grows a few rows per cold append; pad it to its
    # power-of-4 tier. Padding rows are never gathered (history cols all
    # point below the real row count), so they change no bit of a solve.
    vtier = _tier(opposing.shape[0])
    if vtier > opposing.shape[0]:
        opposing = torch.cat([opposing, opposing.new_zeros(
            (vtier - opposing.shape[0], k))])
    # solve into the row tier and slice: scratch rows scatter into row
    # `n`, inside the padded range and sliced off with the rest of it
    out = _solve_buckets_device(opposing, target,
                                _put_buckets([bucket], dev), cfg)
    return out[:n]


class SeenOverlay:
    """Immutable seen-items view: a base SeenItems/dict plus per-row
    overrides for folded users. Overlay-on-overlay flattens, so repeated
    fold passes don't build a lookup chain."""

    __slots__ = ("_base", "_delta")

    def __init__(self, base, delta: Dict[int, np.ndarray]):
        if isinstance(base, SeenOverlay):
            merged = dict(base._delta)
            merged.update(delta)
            base, delta = base._base, merged
        self._base = base
        self._delta = delta

    def get(self, user_row: int, default=None):
        hit = self._delta.get(user_row)
        if hit is not None:
            return hit
        if not self._base:
            return default
        return self._base.get(user_row, default)

    def __len__(self) -> int:
        return (len(self._base) if self._base else 0) + len(self._delta)

    def __bool__(self) -> bool:
        return True


def extend_bimap(bimap: BiMap, ids: Sequence[str]) -> Tuple[BiMap, List[str]]:
    """Append never-seen ids with the next dense codes. Existing codes are
    untouched (factor rows stay valid); returns (bimap', appended_ids)."""
    new = [i for i in ids if i not in bimap]
    if not new:
        return bimap, []
    fwd = bimap.to_dict()
    for i in new:
        fwd[i] = len(fwd)
    return BiMap(fwd), new


def _pad_rows(factors: torch.Tensor, n_rows: int) -> torch.Tensor:
    if factors.shape[0] >= n_rows:
        return factors
    return torch.cat([factors, factors.new_zeros(
        (n_rows - factors.shape[0], factors.shape[1]))])


@dataclasses.dataclass
class FoldStats:
    folded_users: int = 0
    folded_items: int = 0
    new_users: int = 0
    new_items: int = 0


def fold_model(model: ALSModel, cfg: ALSConfig,
               user_hist: Dict[str, List[Tuple[str, float]]],
               item_hist: Optional[Dict[str, List[Tuple[str, float]]]] = None,
               device: DeviceLike = None,
               ) -> Tuple[ALSModel, FoldStats]:
    """Fold dirty users (and optionally items) into a NEW ALSModel.

    `user_hist[user_id]` is the user's full `(item_id, value)` history —
    full, not delta, so replaying a batch after a crash re-solves to the
    identical factors (idempotence is what makes the tailer's
    at-least-once delivery safe). Users fold first against the current
    item factors, then items against the *updated* user factors — the
    same alternation order as a training epoch. The input model is never
    mutated; serving keeps reading the old immutable state until the
    caller swaps.

    The solves run where the model's factors are: on their device when
    they are tensors, else on `device` (None: the model's `device`, then
    `device.resolve_device`'s default). The folded model's factors live
    where the input's did (numpy stays numpy)."""
    item_hist = item_hist or {}
    stats = FoldStats()

    # grow the id spaces first so every history row has a factor row to
    # point at (zero rows until their own side solves)
    new_user_ids = set(user_hist)
    new_item_ids = set(item_hist)
    for h in user_hist.values():
        new_item_ids.update(i for i, _ in h)
    for h in item_hist.values():
        new_user_ids.update(u for u, _ in h)
    user_ids, added_users = extend_bimap(model.user_ids, sorted(new_user_ids))
    item_ids, added_items = extend_bimap(model.item_ids, sorted(new_item_ids))
    on_host = not isinstance(model.user_factors, torch.Tensor)
    dev = (resolve_device(device if device is not None else model.device)
           if on_host else model.user_factors.device)
    # the input's arrays are only read: index_copy below is out of place
    user_factors = _pad_rows(torch.as_tensor(model.user_factors, device=dev),
                             len(user_ids))
    item_factors = _pad_rows(torch.as_tensor(model.item_factors, device=dev),
                             len(item_ids))
    stats.new_users, stats.new_items = len(added_users), len(added_items)
    if added_users:
        ONLINE_COLD_START_ROWS.labels(side="user").inc(len(added_users))
    if added_items:
        ONLINE_COLD_START_ROWS.labels(side="item").inc(len(added_items))

    def entries(hist, col_map):
        out = []
        for _, pairs in hist:
            cols = np.asarray([col_map[i] for i, _ in pairs], np.int32)
            vals = np.asarray([v for _, v in pairs], np.float32)
            out.append((cols, vals))
        return out

    def rows_of(hist, row_map) -> torch.Tensor:
        return torch.as_tensor([row_map[e] for e, _ in hist],
                               dtype=torch.int64, device=dev)

    seen_delta: Dict[int, np.ndarray] = {}
    if user_hist:
        hist = sorted(user_hist.items())
        solved = solve_rows(item_factors, entries(hist, item_ids), cfg)
        user_factors = user_factors.index_copy(
            0, rows_of(hist, user_ids), solved.to(user_factors.dtype))
        stats.folded_users = len(hist)
        ONLINE_ROWS_FOLDED.labels(side="user").inc(len(hist))
        for u, pairs in hist:
            seen_delta[int(user_ids[u])] = np.unique(np.asarray(
                [item_ids[i] for i, _ in pairs], np.int32))
    if item_hist:
        hist = sorted(item_hist.items())
        solved = solve_rows(user_factors, entries(hist, user_ids), cfg)
        item_factors = item_factors.index_copy(
            0, rows_of(hist, item_ids), solved.to(item_factors.dtype))
        stats.folded_items = len(hist)
        ONLINE_ROWS_FOLDED.labels(side="item").inc(len(hist))

    if on_host:
        user_factors = user_factors.cpu().numpy()
        item_factors = item_factors.cpu().numpy()
    seen = model.seen
    if seen_delta:
        seen = SeenOverlay(seen, seen_delta)
    folded = dataclasses.replace(
        model, user_factors=user_factors, item_factors=item_factors,
        user_ids=user_ids, item_ids=item_ids, seen=seen)
    return folded, stats


# -- FoldModel protocol -------------------------------------------------------
# The online plane folds MODEL FAMILIES, not ALS specifically: a fold
# handle owns everything family-specific (what a "fold" recomputes, from
# which slice of the histories) while the plane keeps everything
# family-agnostic (tailing, watermarks, history gathering, delta-swap). A
# handle implements:
#
#     family: str                      # metric label ("als", "sessionrec")
#     fold(model, user_hist, item_hist) -> (new_model, stats)
#
# where `user_hist[user]` / `item_hist[item]` are the entity's FULL
# keep-last history as [(opposing_id, value, event_time)] triples — full,
# not delta, so any handle's fold is idempotent under the tailer's
# at-least-once replay. Handles must never mutate the input model
# (serving reads the old immutable state until the swap).


class FoldModel:
    """Protocol base for online fold handles (duck-typed; subclassing is
    optional and exists for isinstance-based documentation/tests)."""

    family: str = ""

    def fold(self, model, user_hist, item_hist):  # pragma: no cover - protocol
        raise NotImplementedError


def _strip_times(hist: Optional[Dict[str, list]]) -> Dict[str, list]:
    """[(id, value, t)] → [(id, value)], order preserved — exactly the
    pairs `fold_model` consumes, so the adapter changes no bit of the ALS
    fold inputs."""
    if not hist:
        return {}
    return {k: [(o, v) for o, v, _ in triples]
            for k, triples in hist.items()}


class ALSFold(FoldModel):
    """The ALS family as a fold handle: a thin adapter over `fold_model`
    (which stays the public entry point) — it only drops the event times
    the generalized history form carries, because an ALS re-solve is a
    pure function of (opposing id, value) pairs."""

    family = "als"

    def __init__(self, cfg: ALSConfig):
        self.cfg = cfg

    def fold(self, model: ALSModel, user_hist, item_hist):
        return fold_model(model, self.cfg, _strip_times(user_hist),
                          _strip_times(item_hist))
