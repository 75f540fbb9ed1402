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
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
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
    buckets_dev: Sequence[tuple],  # per bucket: (rows, cols, vals, mask, segmap)
    cfg: ALSConfig,
    split_rows: Optional[torch.Tensor] = None,  # [U] row ids of split rows
    row_multiple: int = 8,
) -> torch.Tensor:
    """One half-epoch: solve every row's normal equations and scatter the
    solutions into a fresh [out_rows, K] matrix.

    Split rows' partial (A, b, n) are added into [U, ...] accumulators
    keyed by segmap and solved once after the bucket loop."""
    k = opposing.shape[-1]
    dev = opposing.device
    f32 = torch.float32
    bf16 = cfg.compute_dtype == "bfloat16"
    # row `out_rows` is the sentinel: padding rows and inline solves of
    # split segments land there and are sliced off
    new = torch.zeros((out_rows + 1, k), dtype=opposing.dtype, device=dev)
    n_split = 0 if split_rows is None else int(split_rows.shape[0])
    if n_split:
        acc_a = torch.zeros((n_split + 1, k, k), dtype=f32, device=dev)
        acc_b = torch.zeros((n_split + 1, k), dtype=f32, device=dev)
        acc_n = torch.zeros((n_split + 1,), dtype=f32, device=dev)
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
        rows_c, cols_c, vals_c, mask_c, segmap_c = sliced
        n = mask_c.sum(-1)
        a, b = partial_gram(cols_c, vals_c, mask_c)
        rows_eff = rows_c
        if segmap_c is not None:
            acc_a.index_add_(0, segmap_c, a)
            acc_b.index_add_(0, segmap_c, b)
            acc_n.index_add_(0, segmap_c, n)
            # segment rows are solved after the loop: drop their partials
            rows_eff = torch.where(segmap_c < n_split,
                                   torch.full_like(rows_c, out_rows), rows_c)
        x = finalize(a, b, n)
        new.index_copy_(0, rows_eff, x.to(new.dtype))
        return None

    for bucket in buckets_dev:
        cap = bucket[1].shape[1]
        _walk_bucket_chunks(bucket, cap, k, row_multiple, process, None)

    if n_split:
        x_u = finalize(acc_a[:n_split], acc_b[:n_split], acc_n[:n_split])
        new.index_copy_(0, split_rows, x_u.to(new.dtype))
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
    epoch_times: list[float] = dataclasses.field(default_factory=list)


def _put_buckets(buckets: list[Bucket], device: torch.device) -> list[tuple]:
    def put(a, dtype):
        return None if a is None else torch.as_tensor(a, dtype=dtype,
                                                      device=device)

    return [(put(b.rows, torch.int64), put(b.cols, torch.int64),
             put(b.vals, torch.float32), put(b.mask, torch.float32),
             put(b.segmap, torch.int64)) for b in buckets]


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
) -> ALSResult:
    """Train ALS factors from COO ratings on one device.

    device: where the half-epochs run (see `device.resolve_device`).
    init_item_factors: [n_items, rank] initial item factors; None draws
    N(0, 1)/√rank from a `torch.Generator` seeded with `cfg.seed` on the
    device (not the reference's numbers: its draws come from
    `jax.random`). Users are solved first, from zeros.
    """
    dev = resolve_device(device)
    cfg = resolve_solver(cfg)
    row_multiple = 8
    split_cap = cfg.split_cap if cfg.split_cap > 0 else None
    user_buckets, u_split = bucket_ragged_split(
        user_idx, item_idx, ratings, n_users, row_multiple, split_cap,
        cap_growth=cfg.cap_growth)
    item_buckets, i_split = bucket_ragged_split(
        item_idx, user_idx, ratings, n_items, row_multiple, split_cap,
        cap_growth=cfg.cap_growth)
    log.info(
        "als_train: %d ratings, %d users (%d buckets, %d split), %d items "
        "(%d buckets, %d split), rank %d, solver %s, device %s",
        len(ratings), n_users, len(user_buckets), len(u_split), n_items,
        len(item_buckets), len(i_split), cfg.rank, cfg.solver, dev)

    dtype = getattr(torch, cfg.dtype)
    ub_dev = _put_buckets(user_buckets, dev)
    ib_dev = _put_buckets(item_buckets, dev)
    u_split_dev = torch.as_tensor(u_split, dtype=torch.int64, device=dev)
    i_split_dev = torch.as_tensor(i_split, dtype=torch.int64, device=dev)

    if init_item_factors is None:
        gen = make_generator(dev, cfg.seed)
        item_f = torch.randn((n_items, cfg.rank), generator=gen, device=dev,
                             dtype=dtype) / math.sqrt(cfg.rank)
    else:
        item_f = torch.tensor(np.asarray(init_item_factors), dtype=dtype,
                              device=dev)
        if tuple(item_f.shape) != (n_items, cfg.rank):
            raise ValueError(f"init_item_factors has shape "
                             f"{tuple(item_f.shape)}, want "
                             f"{(n_items, cfg.rank)}")
    user_f = torch.zeros((n_users, cfg.rank), dtype=dtype, device=dev)

    rmses = []
    epoch_times = []
    for _ in range(cfg.iterations):
        t0 = time.perf_counter()
        user_f = _solve_buckets_device(item_f, n_users, ub_dev, cfg,
                                       u_split_dev, row_multiple)
        item_f = _solve_buckets_device(user_f, n_items, ib_dev, cfg,
                                       i_split_dev, row_multiple)
        if compute_rmse:
            total, count = _predict_sq_err(user_f, item_f, ub_dev,
                                           row_multiple)
            rmses.append(torch.sqrt(total.clamp(min=0.0)
                                    / count.clamp(min=1.0)))
        synchronize(dev)  # epoch times need the device work done
        epoch_times.append(time.perf_counter() - t0)
    rmse_history = ([float(x) for x in torch.stack(rmses).cpu()]
                    if rmses else [])
    if rmse_history:
        log.info("als_train: rmse %.4f → %.4f over %d iters",
                 rmse_history[0], rmse_history[-1], cfg.iterations)
    return ALSResult(
        user_factors=user_f.cpu().numpy(),
        item_factors=item_f.cpu().numpy(),
        rmse_history=rmse_history,
        epoch_times=epoch_times,
    )
