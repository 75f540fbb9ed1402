"""Grid-batched ALS: the cells of a hyperparameter grid trained together —
the port of ``predictionio_tpu/ops/als_grid.py``.

Grid cells that differ only in (λ, α, seed, iterations) share the
bucketed interaction matrix, the gather indices and every shape. Their
factor tables are stacked along the feature axis, [V, G, K], and gathered
as [V, G·K] rows, so one gather feeds every cell. Each row's normal
equations grow a `g` axis, and the solve flattens [R, G, K, K] into the
[R·G, K, K] batch that `als_train`'s solvers take (`ops/spd_solve.py` on
the `gj` path): the solver never knows a grid is running.

The reference's jitted `lax.scan` over epochs is a Python loop here, with
the same per-cell horizon: a cell past its own iteration count keeps both
factor tables frozen, so it ends on exactly what its own sequential train
gives while longer cells keep iterating. Each cell's initial item factors
are drawn as `als_train` draws them (a `torch.Generator` seeded with the
cell's seed), so a cell equals its sequential train in the port.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from predictionio_torch.device import (
    DeviceLike,
    make_generator,
    resolve_device,
    synchronize,
)
from predictionio_torch.ops.als import (
    ALSConfig,
    ALSResult,
    SplitPlan,
    _put_side,
    _solve_spd,
    _sum_segments,
    _walk_bucket_chunks,
    bucketize_cached,
    resolve_solver,
)
from predictionio_torch.utils import checks

log = logging.getLogger(__name__)

# config fields that may vary across grid cells (every other field must be
# equal for the cells to share one bucketing and one batched train)
VARIABLE_FIELDS = ("reg", "alpha", "seed", "iterations")

# one record per `als_train_grid` call in this process: its grid points,
# rank, set-up seconds (bucketing, upload, init), steps and their seconds
grid_log: list[dict] = []


def _static_fields() -> list[str]:
    return [f.name for f in dataclasses.fields(ALSConfig)
            if f.name not in VARIABLE_FIELDS]


def grid_compatible(cfgs: Sequence[ALSConfig]) -> Optional[str]:
    """None when `cfgs` can train as one grid, else the reason they can't
    (callers log it and fall back to sequential trains). `iterations` may
    differ: each cell stops at its own count."""
    if not cfgs:
        return "empty grid"
    base = cfgs[0]
    static = _static_fields()
    for i, c in enumerate(cfgs[1:], 1):
        for name in static:
            if getattr(c, name) != getattr(base, name):
                return (f"grid point {i} differs from point 0 in "
                        f"{name!r} ({getattr(c, name)!r} != "
                        f"{getattr(base, name)!r})")
    if base.solver == "cg":
        return "solver='cg' is not grid-batched"
    return None


def grid_groups(cfgs: Sequence[ALSConfig]) -> list[list[int]]:
    """Partition grid-cell indices into maximal batchable groups: cells
    that agree on every static field share a group (the stock rank × λ
    grid becomes one group per rank); solver='cg' cells come back as
    singletons. Groups keep first-appearance order, indices caller
    order."""
    static = _static_fields()
    groups: dict = {}
    for idx, c in enumerate(cfgs):
        if c.solver == "cg":
            groups[("cg", idx)] = [idx]
            continue
        key = tuple(getattr(c, n) for n in static)
        groups.setdefault(key, []).append(idx)
    return list(groups.values())


def _gather_rows_grid(table: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """[R, C] row-id gather from [V, G, K] → [R, C, G, K]: one
    `index_select` of the [V, G·K] view, ids clamped into range."""
    v, g, k = table.shape
    r, c = cols.shape
    idx = cols.reshape(-1).clamp(0, v - 1)
    return table.reshape(v, g * k).index_select(0, idx).reshape(r, c, g, k)


def _solve_buckets_grid(
    opposing: torch.Tensor,  # [V, G, K]
    out_rows: int,
    buckets_dev: Sequence[tuple],  # per bucket: (rows, cols, vals, mask, segpos)
    cfg: ALSConfig,  # static fields only: λ and α come from `regs`/`alphas`
    regs: torch.Tensor,  # [G] f32
    alphas: torch.Tensor,  # [G] f32 (implicit mode)
    split: Optional[SplitPlan] = None,
    row_multiple: int = 8,
) -> torch.Tensor:
    """One grid half-epoch: per row, solve the G systems that share the
    row's gathered entries; returns the fresh [out_rows, G, K] factors.
    `als._solve_buckets_device` with a `g` axis, down to the sentinel row
    that catches padding and segment rows and the split rows' segments
    summed in a fixed order."""
    v, g, k = opposing.shape
    dev = opposing.device
    f32 = torch.float32
    bf16 = cfg.compute_dtype == "bfloat16"
    new = torch.zeros((out_rows + 1, g, k), dtype=opposing.dtype, device=dev)
    n_seg = 0 if split is None else split.n_segments
    if split is not None:
        part_a = torch.zeros((n_seg + 2, g, k, k), dtype=f32, device=dev)
        part_b = torch.zeros((n_seg + 2, g, k), dtype=f32, device=dev)
        part_n = torch.zeros((n_seg + 2,), dtype=f32, device=dev)
    eye = torch.eye(k, dtype=f32, device=dev)

    def compute(t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.bfloat16).to(f32) if bf16 else t.to(f32)

    if cfg.implicit:
        op_c = compute(opposing).permute(1, 0, 2)  # [G, V, K]
        gram = torch.bmm(op_c.transpose(1, 2), op_c)  # [G, K, K]

    def partial_gram(cols_c, vals_c, mask_c):
        """Raw per-(row, cell) partial normal equations, f32."""
        r, c = cols_c.shape
        y = _gather_rows_grid(opposing, cols_c) * mask_c[..., None, None]
        # [R, C, G, K] → [R·G, C, K]: one bmm batch entry per (row, cell)
        ym = compute(y).permute(0, 2, 1, 3).reshape(r * g, c, k)
        ymt = ym.transpose(1, 2)
        if cfg.implicit:
            conf = (alphas[None, :, None] * vals_c[:, None, :]).reshape(
                r * g, c)  # C - I per cell, zero at padding
            a = torch.bmm(ymt, ym * compute(conf)[..., None])
            b = torch.bmm(ymt, compute(1.0 + conf)[..., None])[..., 0]
        else:
            v_c = compute(vals_c)[:, None, :].expand(r, g, c)
            b = torch.bmm(ymt, v_c.reshape(r * g, c, 1))[..., 0]
            a = torch.bmm(ymt, ym)
        return a.reshape(r, g, k, k), b.reshape(r, g, k)

    def finalize(a, b, n):
        """Partial (A, b, n) → solved [R, G, K] (adds Gram and λ)."""
        if cfg.implicit:
            a = a + gram[None]
        # [R, G] regulariser: per-row n_r (ALS-WR) × per-cell λ
        n_rg = n[:, None] if cfg.weighted_reg else torch.ones_like(n)[:, None]
        a = a + (regs[None, :] * n_rg)[..., None, None] * eye
        r = a.shape[0]
        x = _solve_spd(a.reshape(r * g, k, k).to(opposing.dtype),
                       b.reshape(r * g, k).to(opposing.dtype), cfg)
        return x.reshape(r, g, k)

    def process(sliced, _carry):
        rows_c, cols_c, vals_c, mask_c, segpos_c = sliced
        n = mask_c.sum(-1)
        a, b = partial_gram(cols_c, vals_c, mask_c)
        rows_eff = rows_c
        if segpos_c is not None:
            part_a.index_copy_(0, segpos_c, a)
            part_b.index_copy_(0, segpos_c, b)
            part_n.index_copy_(0, segpos_c, n)
            # segment rows are solved after the loop: drop their partials
            rows_eff = torch.where(segpos_c < n_seg,
                                   torch.full_like(rows_c, out_rows), rows_c)
        new.index_copy_(0, rows_eff, finalize(a, b, n).to(new.dtype))
        return None

    for bucket in buckets_dev:
        # the chunk budget sees the grid's G·K-wide gather as its rank
        _walk_bucket_chunks(bucket, bucket[1].shape[1], g * k, row_multiple,
                            process, None)

    if split is not None:
        x_u = finalize(*_sum_segments(split.segments, part_a, part_b,
                                      part_n))
        new.index_copy_(0, split.rows, x_u.to(new.dtype))
    return new[:out_rows]


def _predict_sq_err_grid(u_factors: torch.Tensor, i_factors: torch.Tensor,
                         buckets_dev: Sequence[tuple], row_multiple: int = 8):
    """Per cell Σ (uᵀv − r)² over all real entries → ([G], count)."""
    _, g, k = u_factors.shape

    def err_chunk(sliced, carry):
        rows_c, cols_c, vals_c, mask_c, _segmap = sliced
        total, count = carry
        r, c = cols_c.shape
        u = u_factors[rows_c.clamp(0, u_factors.shape[0] - 1)]  # [R, G, K]
        y = _gather_rows_grid(i_factors, cols_c)  # [R, C, G, K]
        pred = torch.bmm(y.permute(0, 2, 1, 3).reshape(r * g, c, k),
                         u.reshape(r * g, k, 1)).reshape(r, g, c)
        err = (pred - vals_c[:, None, :]) * mask_c[:, None, :]
        return total + (err * err).sum(dim=(0, 2)), count + mask_c.sum()

    dev = u_factors.device
    carry = (torch.zeros((g,), dtype=torch.float32, device=dev),
             torch.zeros((), dtype=torch.float32, device=dev))
    for bucket in buckets_dev:
        carry = _walk_bucket_chunks(bucket, bucket[1].shape[1], g * k,
                                    row_multiple, err_chunk, carry)
    return carry


def als_train_grid(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    ratings: np.ndarray,
    n_users: int,
    n_items: int,
    cfgs: Sequence[ALSConfig],
    device: DeviceLike = None,
    compute_rmse: bool = False,
    host_factors: bool = True,
    init_item_factors: Optional[np.ndarray] = None,
    bucket_cache_dir: Optional[str] = None,
) -> list[ALSResult]:
    """Train every cell of `cfgs` together; one `ALSResult` per cell, each
    what a sequential `als_train` with that cell's config gives (same init
    per seed, same math; float reassociation in the batched products
    aside). Raises ValueError unless `grid_compatible(cfgs)` is None.

    Each result's `epoch_times` is the shared wall of the whole grid over
    its steps: G cells cost about one train, so per-cell times would be
    fiction. host_factors=False keeps each cell's factors as tensors on
    `device` (slices of the [V, G, K] stack); the eval path scores them
    there. init_item_factors: [n_items, G, rank] initial item factors;
    None draws each cell's from its seed as `als_train` does.
    bucket_cache_dir: the bucketing goes through `als.bucketize_cached`,
    whose key holds no solver hyperparameter: a grid over (λ, α) reuses
    the entry a train on the same data left there."""
    reason = grid_compatible(cfgs)
    if reason:
        raise ValueError(f"grid not batchable: {reason}")
    t_call = time.perf_counter()
    dev = resolve_device(device)
    n_grid = len(cfgs)
    # static config: the variable fields are pinned, read per cell below
    cfg = dataclasses.replace(resolve_solver(cfgs[0]), reg=0.0, alpha=1.0,
                              seed=0, iterations=0)
    row_multiple = 8
    split_cap = cfg.split_cap if cfg.split_cap > 0 else None
    user_buckets, u_split, item_buckets, i_split = bucketize_cached(
        user_idx, item_idx, ratings, n_users, n_items, row_multiple,
        split_cap, cfg.cap_growth, bucket_cache_dir)
    iters_list = [c.iterations for c in cfgs]
    log.info("als_train_grid: %d grid points × (%d ratings, %d users, %d "
             "items, rank %d, %s iters), solver %s, device %s", n_grid,
             len(ratings), n_users, n_items, cfg.rank,
             "-".join(map(str, sorted(set(iters_list)))), cfg.solver, dev)

    dtype = getattr(torch, cfg.dtype)
    ub_dev, u_plan = _put_side(user_buckets, u_split, dev)
    ib_dev, i_plan = _put_side(item_buckets, i_split, dev)

    if init_item_factors is None:
        item_f = torch.stack([
            torch.randn((n_items, cfg.rank), generator=make_generator(
                dev, c.seed), device=dev, dtype=dtype) / math.sqrt(cfg.rank)
            for c in cfgs], dim=1)
    else:
        item_f = torch.tensor(np.asarray(init_item_factors), dtype=dtype,
                              device=dev)
        if tuple(item_f.shape) != (n_items, n_grid, cfg.rank):
            raise ValueError(f"init_item_factors has shape "
                             f"{tuple(item_f.shape)}, want "
                             f"{(n_items, n_grid, cfg.rank)}")
    user_f = torch.zeros((n_users, n_grid, cfg.rank), dtype=dtype,
                         device=dev)
    regs = torch.tensor([c.reg for c in cfgs], dtype=torch.float32,
                        device=dev)
    alphas = torch.tensor([c.alpha for c in cfgs], dtype=torch.float32,
                          device=dev)

    n_steps = max(iters_list)
    rmses = []
    t_start = time.perf_counter()
    for t in range(n_steps):
        # per-cell horizon: a finished cell still computes (one batch,
        # uniform shapes) and its result is discarded
        act = torch.tensor([t < n for n in iters_list], device=dev)[
            None, :, None]
        user_f = torch.where(act, _solve_buckets_grid(
            item_f, n_users, ub_dev, cfg, regs, alphas, u_plan,
            row_multiple), user_f)
        item_f = torch.where(act, _solve_buckets_grid(
            user_f, n_items, ib_dev, cfg, regs, alphas, i_plan,
            row_multiple), item_f)
        if compute_rmse:
            total, count = _predict_sq_err_grid(user_f, item_f, ub_dev,
                                                row_multiple)
            rmses.append(torch.sqrt(total.clamp(min=0.0)
                                    / count.clamp(min=1.0)))
    synchronize(dev)
    wall = time.perf_counter() - t_start
    log.info("als_train_grid: set-up %.6f s (bucketing, upload, init), "
             "%d steps %.6f s", t_start - t_call, n_steps, wall)
    grid_log.append({"cells": n_grid, "rank": cfg.rank,
                     "setup_s": t_start - t_call, "steps": n_steps,
                     "steps_s": wall})

    rmse_g = torch.stack(rmses).cpu().numpy() if rmses else None
    if host_factors:
        uf, vf = user_f.cpu().numpy(), item_f.cpu().numpy()
    else:
        uf, vf = user_f, item_f
    out = []
    for gi, n_it in enumerate(iters_list):
        out.append(ALSResult(
            user_factors=uf[:, gi, :],
            item_factors=vf[:, gi, :],
            # a frozen cell's later rows re-measure its final factors
            rmse_history=([float(x) for x in rmse_g[:n_it, gi]]
                          if rmse_g is not None else []),
            epoch_times=[wall / n_steps] * n_it if n_it else [],
        ))
    return out


def grid_dispatch(
    ctx,
    cfgs: Sequence[ALSConfig],
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    values: np.ndarray,
    n_users: int,
    n_items: int,
    train_one: Callable[[int], object],
    build_model: Callable[[int, ALSResult], object],
    log_prefix: str,
    *,
    rmse_flags: Optional[Sequence[bool]] = None,
    host_factors: bool = True,
    cache_dir: Optional[str] = None,
) -> Optional[list]:
    """Partition the grid and train each batchable group as one grid on
    `ctx.device`; the skeleton behind an ALS template's `train_grid`.

    Returns None when no two cells are batchable, or under the assert
    mode (`utils/checks.py`: the grid has no checked loop, so every cell
    must take the checked `als_train`), and the caller trains them
    sequentially; otherwise one model per cell. `train_one(i)` trains
    cell i the ordinary way (singleton groups); `build_model(i, result)`
    wraps cell i's `ALSResult` into the template's model. A group computes
    an RMSE history when any member's `rmse_flags` entry asks for one.
    `cache_dir`: the bucket cache the groups' bucketing goes through."""
    n = len(cfgs)
    if checks.enabled():
        log.info("%s: --check-asserts armed — training %d grid points "
                 "sequentially (checked)", log_prefix, n)
        return None
    groups = grid_groups(cfgs)
    if max(len(g) for g in groups) == 1:
        log.info("%s: no two of the %d grid points share shapes — "
                 "sequential trains", log_prefix, n)
        return None
    models: list = [None] * n
    for group in groups:
        if len(group) == 1:
            models[group[0]] = train_one(group[0])
            continue
        results = als_train_grid(
            user_idx, item_idx, values, n_users=n_users, n_items=n_items,
            cfgs=[cfgs[i] for i in group], device=ctx.device,
            compute_rmse=bool(rmse_flags is not None
                              and any(rmse_flags[i] for i in group)),
            host_factors=host_factors, bucket_cache_dir=cache_dir,
        )
        for i, r in zip(group, results):
            models[i] = build_model(i, r)
    return models
