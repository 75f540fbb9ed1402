"""ALS (alternating least squares) matrix factorization — the port of
``predictionio_tpu/ops/als.py``.

Same math as the reference: the ragged interaction matrix is bucketed by
row nnz into padded dense blocks (the host half below is an own copy of
the reference's bucketizer: the C++ loader of `predictionio_torch.native`,
and its numpy fallback); each half-epoch gathers the opposing
factor rows, forms every row's normal equations
(Yᵀ_r Y_r + λ(n_r)I) x_r = Yᵀ_r v_r with f32 batched products, solves the
batch, and scatters the solved rows into a fresh factor matrix. Implicit
mode uses the Hu-Koren-Volinsky weighting with the global Gram computed
once per half-epoch.

The port runs eagerly on one device: the reference's `lax.scan` epoch
loop is a Python loop and its `fori_loop` chunk walk a loop over row
slices. JAX scatters drop out-of-range ids (`mode="drop"`); torch's
`index_copy_`/`index_add_` do not, so every scatter target carries one
extra sentinel row that is sliced off. Accumulators and the solved-row
matrix are updated in place.

Rows split into segments (`bucket_ragged_split`) sum their segments'
partial normal equations in a fixed order: each segment row's partials go
to a position of its own in a table, and each split row adds its
segments up one after another (`_sum_segments`). A float `index_add_`
with repeated indices accumulates through atomics on CUDA, in no fixed
order, and would give two runs of one train different bits.

The host half can keep its buckets on disk (`bucketize_cached`), and a
train can checkpoint its factors and resume (`als_train`'s
`checkpoint_dir`), as the reference's can.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import math
import os
import tempfile
import time
import zipfile
from typing import Optional, Sequence

import numpy as np
import torch

from predictionio_torch.device import (
    DeviceLike,
    make_generator,
    resolve_device,
    synchronize,
)
from predictionio_torch.ops import spd_solve
from predictionio_torch.utils import checks

log = logging.getLogger(__name__)

MIN_CAP = 8  # smallest bucket width


# -- host half: bucketing (own copy of the reference's C++/numpy path) ------

@dataclasses.dataclass
class Bucket:
    """Padded dense block of ragged rows with equal capacity."""

    rows: np.ndarray  # [R] int32 — row ids; padding rows get `n_rows` (sentinel)
    cols: np.ndarray  # [R, C] int32 — column ids, 0-padded
    vals: np.ndarray  # [R, C] float32 — values, 0-padded
    mask: np.ndarray  # [R, C] float32 — 1 where real
    # [R] int32 index into the split-row table for segment rows,
    # == n_split (sentinel) for whole rows/padding; None without segments
    segmap: Optional[np.ndarray] = None


def cap_ladder(max_count: int, min_cap: int, growth: float) -> np.ndarray:
    """Bucket capacity ladder: min_cap, then ceil(prev·growth/8)·8."""
    if growth <= 1.0:
        raise ValueError(f"cap_growth must be > 1.0, got {growth}")
    ladder = [min_cap]
    while ladder[-1] < max_count:
        nxt = int(math.ceil(ladder[-1] * growth / 8.0)) * 8
        if nxt <= ladder[-1]:
            nxt = ladder[-1] + 8
        ladder.append(nxt)
    return np.asarray(ladder, dtype=np.int64)


def bucket_ragged(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    row_multiple: int = 8,
    cap_growth: float = 1.5,
) -> list[Bucket]:
    """COO triplets → per-row padded buckets, bucketed by nnz.

    Rows with no entries are skipped; `row_multiple` pads each bucket's
    row count; `cap_growth` sets the capacity ladder (`cap_ladder`).

    The hot path runs in the native C++ loader (native/pio_native.cpp,
    bit-identical output) when a toolchain is available; PIO_NATIVE=0 or
    a failed build falls back to the numpy body below."""
    from predictionio_torch import native

    nb = native.bucket_ragged_native(rows, cols, vals, n_rows, row_multiple,
                                     None, MIN_CAP, cap_growth)
    if nb is not None:
        return nb
    rows = np.asarray(rows, dtype=np.int32)
    cols = np.asarray(cols, dtype=np.int32)
    vals = np.asarray(vals, dtype=np.float32)
    order = np.argsort(rows, kind="stable")
    rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
    uniq, start, counts = np.unique(rows_s, return_index=True,
                                    return_counts=True)

    ladder = cap_ladder(int(counts.max(initial=1)), MIN_CAP, cap_growth)
    caps = ladder[np.searchsorted(ladder, np.maximum(counts, 1))]

    buckets: list[Bucket] = []
    for cap in np.unique(caps):
        sel = np.nonzero(caps == cap)[0]
        r = len(sel)
        r_pad = -(-r // row_multiple) * row_multiple
        b_rows = np.full(r_pad, n_rows, dtype=np.int32)  # sentinel padding
        b_cols = np.zeros((r_pad, cap), dtype=np.int32)
        b_vals = np.zeros((r_pad, cap), dtype=np.float32)
        b_mask = np.zeros((r_pad, cap), dtype=np.float32)
        for i, j in enumerate(sel):
            c = counts[j]
            s = start[j]
            b_rows[i] = uniq[j]
            b_cols[i, :c] = cols_s[s : s + c]
            b_vals[i, :c] = vals_s[s : s + c]
            b_mask[i, :c] = 1.0
        # sort each padded row by column id (order-invariant sums,
        # monotonic gather indices)
        order = np.argsort(b_cols, axis=1, kind="stable")
        b_cols = np.take_along_axis(b_cols, order, axis=1)
        b_vals = np.take_along_axis(b_vals, order, axis=1)
        b_mask = np.take_along_axis(b_mask, order, axis=1)
        buckets.append(Bucket(b_rows, b_cols, b_vals, b_mask))
    return buckets


def bucket_ragged_split(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    row_multiple: int = 8,
    split_cap: Optional[int] = None,
    cap_growth: float = 1.5,
) -> tuple[list[Bucket], np.ndarray]:
    """`bucket_ragged`, but rows with more than `split_cap` entries are
    split into segments whose partial normal equations are summed before
    the solve. Returns (buckets, split_rows): split_rows[u] is the row id
    of split-table slot u (empty when nothing was split)."""
    if split_cap is None or len(rows) == 0:
        return (bucket_ragged(rows, cols, vals, n_rows, row_multiple,
                              cap_growth=cap_growth),
                np.zeros(0, np.int32))
    rows = np.asarray(rows, dtype=np.int32)
    counts = np.bincount(rows, minlength=n_rows)
    hot = np.nonzero(counts > split_cap)[0].astype(np.int32)
    if hot.size == 0:
        return (bucket_ragged(rows, cols, vals, n_rows, row_multiple,
                              cap_growth=cap_growth),
                np.zeros(0, np.int32))

    cols = np.asarray(cols, dtype=np.int32)
    vals = np.asarray(vals, dtype=np.float32)
    order = np.argsort(rows, kind="stable")
    rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
    starts = np.concatenate(([0], np.cumsum(counts)))
    rank = np.arange(len(rows_s), dtype=np.int64) - starts[rows_s]
    seg = (rank // split_cap).astype(np.int64)

    # pseudo-row numbering: hot row h's segment s → n_rows + base[h] + s
    nseg = -(-counts[hot] // split_cap)
    base = np.concatenate(([0], np.cumsum(nseg)))[:-1]
    hot_slot = np.full(n_rows, -1, np.int64)
    hot_slot[hot] = np.arange(hot.size)
    idx_hot = np.nonzero(hot_slot[rows_s] >= 0)[0]
    rows2 = rows_s.astype(np.int32, copy=True)
    rows2[idx_hot] = (n_rows + base[hot_slot[rows_s[idx_hot]]]
                      + seg[idx_hot]).astype(np.int32)
    n_rows_eff = int(n_rows + nseg.sum())

    buckets = bucket_ragged(rows2, cols_s, vals_s, n_rows_eff, row_multiple,
                            cap_growth=cap_growth)

    # map pseudo ids back: real row ids + segmap into the split table
    pseudo_to_slot = np.repeat(hot_slot[hot], nseg).astype(np.int32)
    for b in buckets:
        is_pseudo = (b.rows >= n_rows) & (b.rows < n_rows_eff)
        if not is_pseudo.any():
            b.rows = np.where(b.rows >= n_rows, n_rows, b.rows).astype(np.int32)
            continue
        slot = np.where(
            is_pseudo,
            pseudo_to_slot[(b.rows - n_rows).clip(0, pseudo_to_slot.size - 1)],
            hot.size).astype(np.int32)
        real = np.where(is_pseudo, hot[slot.clip(0, hot.size - 1)], b.rows)
        b.rows = np.where(real >= n_rows, n_rows, real).astype(np.int32)
        b.segmap = slot
    return buckets, hot


# -- host half: the on-disk bucket cache ----------------------------------------

_BUCKET_CACHE_VERSION = 1
# part of every key and file name: PIO_FS_BASEDIR is one directory for both
# packages, and an entry the reference wrote is never loaded here (nor
# counted or swept by this package's GC)
_BUCKET_CACHE_TAG = "predictionio_torch"
_BUCKET_CACHE_PREFIX = "torch-"


def _bucket_cache_keep() -> int:
    """Entries kept a cache dir (`PIO_BUCKET_CACHE_KEEP`, default 4). The
    dir is shared by every ALS template on the host: hosts that alternate
    more datasets than this rebucketize each time."""
    return max(1, int(os.environ.get("PIO_BUCKET_CACHE_KEEP", "4")))


def _arrays_digest(*arrays, extra: str = "") -> str:
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(extra.encode())
    return h.hexdigest()


def _bucket_cache_path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"{_BUCKET_CACHE_PREFIX}{key}.npz")


def _bucket_cache_save(cache_dir: str, key: str,
                       user_buckets: list, u_split: np.ndarray,
                       item_buckets: list, i_split: np.ndarray) -> None:
    """Both sides' buckets as one npz, written atomically (a temporary
    file renamed: a killed writer leaves no half entry), then the GC: the
    newest `_bucket_cache_keep()` entries by mtime stay, and temporary
    files older than an hour (a killed writer's) go."""
    arrays: dict[str, np.ndarray] = {"u_split": u_split, "i_split": i_split}
    for side, buckets in (("u", user_buckets), ("i", item_buckets)):
        for n, b in enumerate(buckets):
            arrays[f"{side}{n}_rows"] = b.rows
            arrays[f"{side}{n}_cols"] = b.cols
            arrays[f"{side}{n}_vals"] = b.vals
            arrays[f"{side}{n}_mask"] = b.mask
            if b.segmap is not None:
                arrays[f"{side}{n}_segmap"] = b.segmap
    os.makedirs(cache_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=cache_dir, prefix=_BUCKET_CACHE_PREFIX,
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)  # uncompressed: load speed is the point
        os.replace(tmp, _bucket_cache_path(cache_dir, key))
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    entries = []
    for e in os.scandir(cache_dir):
        if not e.name.startswith(_BUCKET_CACHE_PREFIX):
            continue
        try:  # another process's GC may unlink between scandir and stat
            mtime = e.stat().st_mtime
        except OSError:
            continue
        if e.name.endswith(".npz"):
            entries.append((mtime, e.path))
        elif e.name.endswith(".tmp") and mtime < time.time() - 3600:
            try:
                os.unlink(e.path)
            except OSError:
                pass
    entries.sort(reverse=True)
    for _, stale in entries[_bucket_cache_keep():]:
        try:
            os.unlink(stale)
        except OSError:
            pass


def _bucket_cache_load(cache_dir: str, key: str):
    """(user_buckets, u_split, item_buckets, i_split), or None on a miss
    or an unreadable entry (logged)."""
    path = _bucket_cache_path(cache_dir, key)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            sides = []
            for side in ("u", "i"):
                buckets = []
                n = 0
                while f"{side}{n}_rows" in z:
                    buckets.append(Bucket(
                        rows=z[f"{side}{n}_rows"],
                        cols=z[f"{side}{n}_cols"],
                        vals=z[f"{side}{n}_vals"],
                        mask=z[f"{side}{n}_mask"],
                        segmap=(z[f"{side}{n}_segmap"]
                                if f"{side}{n}_segmap" in z else None),
                    ))
                    n += 1
                sides.append(buckets)
            try:
                os.utime(path)  # freshen for the keep-newest GC
            except OSError:
                pass  # a read-only cache dir: loaded all the same
            return sides[0], z["u_split"], sides[1], z["i_split"]
    except (OSError, ValueError, KeyError, EOFError,
            zipfile.BadZipFile) as e:
        log.warning("bucket cache at %s unreadable (%s) — rebucketing",
                    path, e)
        return None


def bucketize_cached(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    ratings: np.ndarray,
    n_users: int,
    n_items: int,
    row_multiple: int,
    split_cap: Optional[int],
    cap_growth: float,
    bucket_cache_dir: Optional[str],
    data_digest=None,
):
    """Both sides' `bucket_ragged_split`, behind the on-disk cache when
    `bucket_cache_dir` is set. `als_train` and the grid evaluator share
    it: the key covers the training data and every bucketizer input, and
    no solver hyperparameter, so a grid over (λ, α) reuses a train's
    entry. New events, or another split cap or ladder, miss. A corrupt
    entry is logged and rebucketized; a failed save is logged and the
    train goes on. `data_digest`: an optional zero-argument digest of the
    COO arrays (memoized by the caller).

    Returns (user_buckets, u_split, item_buckets, i_split)."""
    if data_digest is None:
        def data_digest():
            return _arrays_digest(user_idx, item_idx, ratings)
    cached = None
    bucket_key = None
    if bucket_cache_dir:
        bucket_key = hashlib.blake2b(
            (data_digest() + repr((n_users, n_items, row_multiple,
                                   split_cap, cap_growth,
                                   _BUCKET_CACHE_VERSION,
                                   _BUCKET_CACHE_TAG))).encode(),
            digest_size=16).hexdigest()
        cached = _bucket_cache_load(bucket_cache_dir, bucket_key)
    if cached is not None:
        log.info("als_train: bucket cache hit %s (host bucketize skipped)",
                 bucket_key)
        return cached
    user_buckets, u_split = bucket_ragged_split(
        user_idx, item_idx, ratings, n_users, row_multiple, split_cap,
        cap_growth=cap_growth)
    item_buckets, i_split = bucket_ragged_split(
        item_idx, user_idx, ratings, n_items, row_multiple, split_cap,
        cap_growth=cap_growth)
    if bucket_cache_dir:
        try:
            # an atomic write: processes racing on one key write one entry
            _bucket_cache_save(bucket_cache_dir, bucket_key, user_buckets,
                               u_split, item_buckets, i_split)
            log.info("als_train: bucket cache miss — saved %s", bucket_key)
        except OSError as e:
            log.warning("als_train: bucket cache save failed (%s) — "
                        "continuing uncached", e)
    return user_buckets, u_split, item_buckets, i_split


# -- host half: where split rows' segments are summed ---------------------------

@dataclasses.dataclass
class SplitPlan:
    """One side's split rows on the device, for `_solve_buckets_device`.

    A half-epoch writes each segment row's partial normal equations to a
    position of its own in a table of `n_segments + 2` rows (row
    `n_segments` takes the other rows' writes; row `n_segments + 1` stays
    zero), then sums each split row's segments in bucket-walk order."""

    rows: torch.Tensor  # [U] int64 — row id of each split row
    segments: torch.Tensor  # [U, L] int64 — its segments' positions, in
    # bucket-walk order; n_segments + 1 (the zero row) past its last
    n_segments: int


def _split_positions(buckets: list[Bucket], n_split: int):
    """(positions, segments, n_segments): per bucket, each row's position
    in the partials table (`n_segments` for whole and padding rows; None
    for a bucket without segments), and the [n_split, L] table of
    `SplitPlan.segments`."""
    positions: list = []
    slots = []
    p = 0
    for b in buckets:
        if b.segmap is None:
            positions.append(None)
            continue
        seg = np.nonzero(b.segmap < n_split)[0]
        pos = np.full(len(b.segmap), -1, np.int64)
        pos[seg] = np.arange(p, p + len(seg))
        p += len(seg)
        slots.append(b.segmap[seg].astype(np.int64))
        positions.append(pos)
    positions = [None if pos is None else np.where(pos < 0, p, pos)
                 for pos in positions]
    slots = np.concatenate(slots) if slots else np.zeros(0, np.int64)
    order = np.argsort(slots, kind="stable")  # by row, in walk order
    counts = np.bincount(slots, minlength=n_split)
    starts = np.concatenate(([0], np.cumsum(counts)))[:-1]
    segments = np.full((n_split, int(counts.max(initial=1))), p + 1,
                       np.int64)
    sorted_slots = slots[order]
    segments[sorted_slots,
             np.arange(len(order)) - starts[sorted_slots]] = order
    return positions, segments, p


def _sum_segments(segments: torch.Tensor, *tables: torch.Tensor) -> list:
    """Per table, each split row's partials summed over its segments:
    table[segments[:, 0]] + table[segments[:, 1]] + …, one column at a
    time. Every element is added in the same order on every run (no
    atomics), so a train gives the same bits each time."""
    out = []
    for t in tables:
        acc = t.index_select(0, segments[:, 0])
        for j in range(1, segments.shape[1]):
            acc = acc + t.index_select(0, segments[:, j])
        out.append(acc)
    return out


# -- configuration ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ALSConfig:
    rank: int = 10
    iterations: int = 10
    reg: float = 0.01
    weighted_reg: bool = True  # λ·n_r (ALS-WR, MLlib's scheme) vs plain λ
    implicit: bool = False
    alpha: float = 1.0  # implicit confidence scale
    seed: int = 0
    dtype: str = "float32"
    # Gram/RHS product inputs: "bfloat16" rounds the inputs to bf16 and
    # accumulates in f32; "float32" keeps them f32
    compute_dtype: str = "float32"
    # normal-equation solver:
    #   "auto" — "gj" when the rank is ≤ 256 (gj_applicable), else "chol"
    #   "gj"   — batched Gauss-Jordan (ops/spd_solve.py): the CUDA kernel
    #            on the card, its plain version on the CPU
    #   "chol" — Cholesky + two triangular solves
    #   "lu"   — torch.linalg.solve
    #   "cg"   — Jacobi-preconditioned batched conjugate gradient
    solver: str = "auto"
    cg_iters: int = 0  # 0 = auto: rank//2 clamped to [8, 32]
    # rows with more entries than this are split into segments whose
    # partial normal equations are summed before solving; 0 disables
    split_cap: int = 32768
    cap_growth: float = 1.5  # bucket capacity ladder growth (cap_ladder)


# device-memory budget for one bucket chunk's [R, C, K] gathered-factor
# block; larger buckets are walked in row chunks
_CHUNK_BUDGET_BYTES = 1 << 30


def _bucket_chunk_rows(r: int, c: int, k: int, row_multiple: int) -> int:
    """Rows per chunk for a [r, c] bucket at rank k (== r when no chunking
    is needed); a multiple of row_multiple."""
    per_row = c * k * 4
    if r * per_row <= _CHUNK_BUDGET_BYTES:
        return r
    chunk = max(1, _CHUNK_BUDGET_BYTES // (per_row * row_multiple)) * row_multiple
    return min(r, chunk)


# -- device half ----------------------------------------------------------------

def _gather_rows(table: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """[R, C] row-id gather from [V, K] → [R, C, K]. Ids are clamped into
    range, as the reference's `mode="clip"` take."""
    r, c = cols.shape
    idx = cols.reshape(-1).clamp(0, table.shape[0] - 1)
    return table.index_select(0, idx).reshape(r, c, table.shape[-1])


def _walk_bucket_chunks(arrays: tuple, cap: int, k: int, row_multiple: int,
                        fn, carry):
    """Fold `fn(sliced_arrays, carry) -> carry` over one bucket's rows in
    chunks of `_bucket_chunk_rows` rows (None entries pass through)."""
    r_total = arrays[0].shape[0]
    chunk = _bucket_chunk_rows(r_total, cap, k, row_multiple)
    for s in range(0, r_total, chunk):
        sliced = tuple(None if a is None else a[s : s + chunk] for a in arrays)
        carry = fn(sliced, carry)
    return carry


def _chol_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # cholesky_ex: padding systems (A = 0) must not raise; their rows are
    # scattered into the sentinel row
    chol, _ = torch.linalg.cholesky_ex(a)
    return torch.cholesky_solve(b[..., None], chol)[..., 0]


def _cg_solve(a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Jacobi-preconditioned batched conjugate gradient."""
    dinv = 1.0 / torch.clamp(torch.diagonal(a, dim1=-2, dim2=-1), min=1e-12)
    x = torch.zeros_like(b)
    r = b
    z = dinv * r
    p = z
    rz = (r * z).sum(-1)
    for _ in range(iters):
        ap = torch.bmm(a, p[..., None])[..., 0]
        alpha = rz / torch.clamp((p * ap).sum(-1), min=1e-30)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        z = dinv * r
        rz_new = (r * z).sum(-1)
        p = z + (rz_new / torch.clamp(rz, min=1e-30))[:, None] * p
        rz = rz_new
    return x


def _solve_spd(a: torch.Tensor, b: torch.Tensor, cfg: ALSConfig) -> torch.Tensor:
    if cfg.solver == "gj":
        return spd_solve.gj_solve(a.float(), b.float()).to(a.dtype)
    if cfg.solver == "chol":
        return _chol_solve(a, b)
    if cfg.solver == "cg":
        k = a.shape[-1]
        return _cg_solve(a, b, cfg.cg_iters or max(8, min(32, k // 2)))
    if cfg.solver == "lu":
        x, _ = torch.linalg.solve_ex(a, b[..., None])
        return x[..., 0]
    raise ValueError(f"unknown ALS solver {cfg.solver!r} "
                     "(want auto/gj/chol/lu/cg)")


def _solve_buckets_device(
    opposing: torch.Tensor,  # [n_cols, K]
    out_rows: int,
    buckets_dev: Sequence[tuple],  # per bucket: (rows, cols, vals, mask, segpos)
    cfg: ALSConfig,
    split: Optional[SplitPlan] = None,
    row_multiple: int = 8,
) -> torch.Tensor:
    """One half-epoch: solve every row's normal equations and scatter the
    solutions into a fresh [out_rows, K] matrix.

    Segment rows write their partial (A, b, n) to their positions
    (`segpos`) in a partials table; after the bucket loop each split row
    sums its segments (`_sum_segments`) and is solved once."""
    k = opposing.shape[-1]
    dev = opposing.device
    f32 = torch.float32
    bf16 = cfg.compute_dtype == "bfloat16"
    # row `out_rows` is the sentinel: padding rows and inline solves of
    # split segments land there and are sliced off
    new = torch.zeros((out_rows + 1, k), dtype=opposing.dtype, device=dev)
    n_seg = 0 if split is None else split.n_segments
    if split is not None:
        part_a = torch.zeros((n_seg + 2, k, k), dtype=f32, device=dev)
        part_b = torch.zeros((n_seg + 2, k), dtype=f32, device=dev)
        part_n = torch.zeros((n_seg + 2,), dtype=f32, device=dev)
    eye = torch.eye(k, dtype=f32, device=dev)

    def compute(t: torch.Tensor) -> torch.Tensor:
        # bf16 inputs, f32 accumulation: products of bf16 values are exact
        # in f32, so rounding the inputs and multiplying in f32 is exact
        return t.to(torch.bfloat16).to(f32) if bf16 else t.to(f32)

    if cfg.implicit:
        op_c = compute(opposing)
        gram = op_c.T @ op_c

    def partial_gram(cols_c, vals_c, mask_c):
        """Raw per-row partial normal equations (no global Gram, no reg):
        associative over any split of a row's entries, f32."""
        ym = compute(_gather_rows(opposing, cols_c) * mask_c[..., None])
        ymt = ym.transpose(1, 2)
        if cfg.implicit:
            conf = cfg.alpha * vals_c  # C - I, zero at padding
            a = torch.bmm(ymt, ym * compute(conf)[..., None])
            b = torch.bmm(ymt, compute(1.0 + conf)[..., None])[..., 0]
        else:
            a = torch.bmm(ymt, ym)
            b = torch.bmm(ymt, compute(vals_c)[..., None])[..., 0]
        return a, b

    def finalize(a, b, n):
        """Partial (A, b, n) → solved factors (adds Gram and reg)."""
        if cfg.implicit:
            a = a + gram[None]
        reg = cfg.reg * (n if cfg.weighted_reg else torch.ones_like(n))
        a = a + reg[:, None, None] * eye[None]
        return _solve_spd(a.to(opposing.dtype), b.to(opposing.dtype), cfg)

    def process(sliced, _carry):
        rows_c, cols_c, vals_c, mask_c, segpos_c = sliced
        n = mask_c.sum(-1)
        a, b = partial_gram(cols_c, vals_c, mask_c)
        rows_eff = rows_c
        if segpos_c is not None:
            # one position a segment row (the others all write row
            # n_seg, never read): no two writes meet, no atomics
            part_a.index_copy_(0, segpos_c, a)
            part_b.index_copy_(0, segpos_c, b)
            part_n.index_copy_(0, segpos_c, n)
            # segment rows are solved after the loop: drop their partials
            rows_eff = torch.where(segpos_c < n_seg,
                                   torch.full_like(rows_c, out_rows), rows_c)
        x = finalize(a, b, n)
        new.index_copy_(0, rows_eff, x.to(new.dtype))
        return None

    for bucket in buckets_dev:
        cap = bucket[1].shape[1]
        _walk_bucket_chunks(bucket, cap, k, row_multiple, process, None)

    if split is not None:
        x_u = finalize(*_sum_segments(split.segments, part_a, part_b,
                                      part_n))
        new.index_copy_(0, split.rows, x_u.to(new.dtype))
    return new[:out_rows]


def _predict_sq_err(u_factors: torch.Tensor, i_factors: torch.Tensor,
                    buckets_dev: Sequence[tuple], row_multiple: int = 8):
    """Σ (uᵀv − r)² over all real entries and their count (RMSE history)."""

    def err_chunk(sliced, carry):
        rows_c, cols_c, vals_c, mask_c, _segmap = sliced
        total, count = carry
        u = u_factors[rows_c.clamp(0, u_factors.shape[0] - 1)]  # [R, K]
        v = _gather_rows(i_factors, cols_c)  # [R, C, K]
        pred = torch.bmm(v, u[..., None])[..., 0]
        err = (pred - vals_c) * mask_c
        return total + (err * err).sum(), count + mask_c.sum()

    k = u_factors.shape[-1]
    dev = u_factors.device
    carry = (torch.zeros((), dtype=torch.float32, device=dev),
             torch.zeros((), dtype=torch.float32, device=dev))
    for bucket in buckets_dev:
        cap = bucket[1].shape[1]
        carry = _walk_bucket_chunks(bucket, cap, k, row_multiple, err_chunk,
                                    carry)
    return carry


def resolve_solver(cfg: ALSConfig) -> ALSConfig:
    """Resolve `solver='auto'` for this rank, and downgrade a 'gj' request
    above `gj_applicable`'s rank bound to 'chol' (with a warning). On
    every device 'gj' stays 'gj': the CUDA kernel on the card, the plain
    version on the CPU."""
    if cfg.solver == "auto":
        use_gj = spd_solve.gj_applicable(cfg.rank)
        cfg = dataclasses.replace(cfg, solver="gj" if use_gj else "chol")
        log.info("als_train: solver='auto' resolved to %r (rank=%d)",
                 cfg.solver, cfg.rank)
    elif cfg.solver == "gj" and not spd_solve.gj_applicable(cfg.rank):
        log.warning("als_train: solver='gj' rank %d exceeds the Gauss-"
                    "Jordan rank bound; falling back to 'chol'", cfg.rank)
        cfg = dataclasses.replace(cfg, solver="chol")
    return cfg


@dataclasses.dataclass
class ALSResult:
    user_factors: np.ndarray  # [n_users, K]
    item_factors: np.ndarray  # [n_items, K]
    rmse_history: list[float]
    # wall seconds of each epoch run in this call (a resumed run skips
    # its first start_epoch epochs; a fully resumed one has none)
    epoch_times: list[float] = dataclasses.field(default_factory=list)
    start_epoch: int = 0  # first epoch run in this call (> 0: resumed)


def _put_buckets(buckets: list[Bucket], device: torch.device,
                 positions: Optional[list] = None) -> list[tuple]:
    """Each bucket on `device` as (rows, cols, vals, mask, segpos):
    `segpos` from `positions` (`_split_positions`), None for a bucket
    without segments."""
    def put(a, dtype):
        return None if a is None else torch.as_tensor(a, dtype=dtype,
                                                      device=device)

    if positions is None:
        positions = [None] * len(buckets)
    return [(put(b.rows, torch.int64), put(b.cols, torch.int64),
             put(b.vals, torch.float32), put(b.mask, torch.float32),
             put(pos, torch.int64)) for b, pos in zip(buckets, positions)]


def _put_side(buckets: list[Bucket], split_rows: np.ndarray,
              device: torch.device) -> tuple[list[tuple], Optional[SplitPlan]]:
    """One side's buckets and split plan on `device` (no plan when no row
    is split)."""
    if len(split_rows) == 0:
        return _put_buckets(buckets, device), None
    positions, segments, n_seg = _split_positions(buckets, len(split_rows))
    plan = SplitPlan(
        rows=torch.as_tensor(split_rows, dtype=torch.int64, device=device),
        segments=torch.as_tensor(segments, device=device),
        n_segments=n_seg)
    return _put_buckets(buckets, device, positions), plan


def als_train(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    ratings: np.ndarray,
    n_users: int,
    n_items: int,
    cfg: ALSConfig,
    device: DeviceLike = None,
    compute_rmse: bool = False,
    init_item_factors: Optional[np.ndarray] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: Optional[int] = 1,
    resume: bool = True,
    bucket_cache_dir: Optional[str] = None,
) -> ALSResult:
    """Train ALS factors from COO ratings on one device.

    device: where the half-epochs run (see `device.resolve_device`).
    init_item_factors: [n_items, rank] initial item factors; None draws
    N(0, 1)/√rank from a `torch.Generator` seeded with `cfg.seed` on the
    device (not the reference's numbers: its draws come from
    `jax.random`). Users are solved first, from zeros.

    checkpoint_dir: the factors are saved there every `checkpoint_every`
    epochs (None or ≤ 0 acts as 1), and with `resume` a run restarts from the
    largest saved step ≤ `cfg.iterations` that is this run's: the same
    data digest, (n_users, n_items, rank, reg, weighted_reg, implicit,
    alpha, seed, dtype) and shapes. Anything else trains from scratch. A
    resumed run goes through the same kernels at the same shapes, so it
    ends on the uninterrupted run's bits. The chunks, saves and resume
    are `workflow.segmented.segmented_train`'s, with the fault site
    `als.epoch_boundary` after each chunk of epochs, before its save
    (after the whole run without a checkpoint dir).

    bucket_cache_dir: the host bucketing is kept on disk there
    (`bucketize_cached`) and reused by every train over the same data.

    Under the assert mode (`utils/checks.py`) the factors are checked
    finite after each half-epoch.
    """
    dev = resolve_device(device)
    cfg = resolve_solver(cfg)
    row_multiple = 8
    split_cap = cfg.split_cap if cfg.split_cap > 0 else None

    # the training arrays are hashed at most once a train: the bucket
    # cache's key and the checkpoint's fingerprint both start from it
    digest_memo: list[str] = []

    def data_digest() -> str:
        if not digest_memo:
            digest_memo.append(_arrays_digest(user_idx, item_idx, ratings))
        return digest_memo[0]

    user_buckets, u_split, item_buckets, i_split = bucketize_cached(
        user_idx, item_idx, ratings, n_users, n_items, row_multiple,
        split_cap, cfg.cap_growth, bucket_cache_dir, data_digest)
    log.info(
        "als_train: %d ratings, %d users (%d buckets, %d split), %d items "
        "(%d buckets, %d split), rank %d, solver %s, device %s",
        len(ratings), n_users, len(user_buckets), len(u_split), n_items,
        len(item_buckets), len(i_split), cfg.rank, cfg.solver, dev)

    dtype = getattr(torch, cfg.dtype)
    ub_dev, u_plan = _put_side(user_buckets, u_split, dev)
    ib_dev, i_plan = _put_side(item_buckets, i_split, dev)

    if init_item_factors is None:
        gen = make_generator(dev, cfg.seed)
        item_f0 = torch.randn((n_items, cfg.rank), generator=gen,
                              device=dev, dtype=dtype) / math.sqrt(cfg.rank)
    else:
        item_f0 = torch.tensor(np.asarray(init_item_factors), dtype=dtype,
                               device=dev)
        if tuple(item_f0.shape) != (n_items, cfg.rank):
            raise ValueError(f"init_item_factors has shape "
                             f"{tuple(item_f0.shape)}, want "
                             f"{(n_items, cfg.rank)}")
    user_f0 = torch.zeros((n_users, cfg.rank), dtype=dtype, device=dev)

    from predictionio_torch.workflow.segmented import segmented_train

    fingerprint = ""
    if checkpoint_dir:
        # a checkpoint resumes only the same run: new ratings (a nightly
        # retrain into the same dir) or another rank, reg or seed train
        # from scratch, never return yesterday's factors
        fingerprint = hashlib.blake2b(
            (data_digest()
             + repr((n_users, n_items, cfg.rank, cfg.reg, cfg.weighted_reg,
                     cfg.implicit, cfg.alpha, cfg.seed,
                     cfg.dtype))).encode(),
            digest_size=8).hexdigest()
    shapes = {"user_factors": (n_users, cfg.rank),
              "item_factors": (n_items, cfg.rank)}
    epoch_times = []

    def run_chunk(state, n_epochs, done):
        user_f, item_f = state
        rmses = []
        for _ in range(n_epochs):
            t0 = time.perf_counter()
            user_f = _solve_buckets_device(item_f, n_users, ub_dev, cfg,
                                           u_plan, row_multiple)
            if checks.enabled():
                checks.require_finite(user_f)
            item_f = _solve_buckets_device(user_f, n_items, ib_dev, cfg,
                                           i_plan, row_multiple)
            if checks.enabled():
                checks.require_finite(item_f)
            if compute_rmse:
                total, count = _predict_sq_err(user_f, item_f, ub_dev,
                                               row_multiple)
                rmses.append(torch.sqrt(total.clamp(min=0.0)
                                        / count.clamp(min=1.0)))
            synchronize(dev)  # epoch times need the device work done
            epoch_times.append(time.perf_counter() - t0)
        # NaN keeps the history one entry an epoch when no RMSE is kept
        return (user_f, item_f), ([float(x) for x in torch.stack(rmses).cpu()]
                                  if rmses else [float("nan")] * n_epochs)

    def state_from_host(tree):
        if {k: np.shape(tree.get(k)) for k in shapes} != shapes:
            raise ValueError("factor shapes differ")
        return tuple(torch.as_tensor(tree[k], dtype=dtype, device=dev)
                     for k in shapes)

    (user_f, item_f), rmse_history, start = segmented_train(
        total_steps=cfg.iterations,
        init_state=lambda: (user_f0, item_f0),
        run_chunk=run_chunk,
        state_to_host=lambda st: {k: t.cpu().numpy()
                                  for k, t in zip(shapes, st)},
        state_from_host=state_from_host,
        fingerprint=fingerprint,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=max(1, checkpoint_every or 1),
        fault_site="als.epoch_boundary",
        name="als_train",
        resume=resume,
        history_key="rmse_history",
        metadata={"iterations": cfg.iterations, "rank": cfg.rank})
    if not compute_rmse:
        rmse_history = []
    if rmse_history:
        log.info("als_train: rmse %.4f → %.4f over %d iters",
                 rmse_history[0], rmse_history[-1], cfg.iterations)
    return ALSResult(
        user_factors=user_f.cpu().numpy(),
        item_factors=item_f.cpu().numpy(),
        rmse_history=rmse_history,
        epoch_times=epoch_times,
        start_epoch=start,
    )
