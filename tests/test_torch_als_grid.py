"""The port's grid-batched ALS (predictionio_torch/ops/als_grid.py) on the
CPU: against the reference's `als_train_grid` (solver="gj" with the Pallas
kernels in interpret mode, the reference's per-seed initial factors carried
in), and within the port against sequential `als_train` runs. The bar is
the reference's own for grid ≡ sequential: factors rel < 1e-4
(tests/test_als_grid.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as ref_als
from predictionio_tpu.ops import als_grid as ref_grid
from predictionio_tpu.parallel.mesh import make_mesh
from predictionio_torch.ops import als, als_grid, spd_solve

# one intra-op thread: these tests use small tensors, and the suite's
# parallel workers share the machine's cores with timing-sensitive tests
torch.set_num_threads(1)


def _coo(n=4000, n_u=80, n_i=60, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_u, n).astype(np.int32),
            rng.integers(0, n_i, n).astype(np.int32),
            rng.uniform(1, 5, n).astype(np.float32), n_u, n_i)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-9)


def _ref_init(n_items, rank, seeds):
    """The reference grid's initial item factors, [n_items, G, rank]."""
    per_seed = [np.asarray(jax.random.normal(jax.random.key(s),
                                             (n_items, rank), jnp.float32))
                / np.sqrt(rank) for s in seeds]
    return np.stack(per_seed, axis=1)


def _port_cfg(ref_cfg, **overrides):
    fields = {f.name for f in dataclasses.fields(als.ALSConfig)}
    kw = {k: v for k, v in dataclasses.asdict(ref_cfg).items() if k in fields}
    kw.update(overrides)
    return als.ALSConfig(**kw)


@pytest.fixture(autouse=True)
def _cpu_never_launches():
    spd_solve.reset_launches()
    yield
    assert not any(spd_solve.launches.values()), spd_solve.launches


@pytest.mark.parametrize("implicit", [False, True])
def test_grid_matches_reference(implicit):
    """Explicit λ × seed cells (with hot rows split into segments) and
    implicit α cells: each port cell against the reference's cell."""
    u, i, v, n_u, n_i = _coo(seed=1 + implicit)
    base = ref_als.ALSConfig(rank=8, iterations=3, reg=0.1, seed=0,
                             split_cap=32, implicit=implicit, solver="gj",
                             pallas="interpret")
    cfgs = [dataclasses.replace(base, reg=r, alpha=a, seed=s)
            for r, a, s in ((0.05, 1.0, 0), (0.5, 4.0, 3))]
    mesh = make_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1])
    ref = ref_grid.als_train_grid(u, i, v, n_u, n_i, cfgs, mesh=mesh,
                                  compute_rmse=True)
    port = als_grid.als_train_grid(
        u, i, v, n_u, n_i, [_port_cfg(c) for c in cfgs], device="cpu",
        compute_rmse=True,
        init_item_factors=_ref_init(n_i, 8, [c.seed for c in cfgs]))
    for p, r in zip(port, ref):
        assert _rel(p.user_factors, r.user_factors) < 1e-4
        assert _rel(p.item_factors, r.item_factors) < 1e-4
        assert p.rmse_history == pytest.approx(r.rmse_history, rel=1e-4)
    assert _rel(port[0].user_factors, port[1].user_factors) > 1e-3


def test_grid_equals_sequential_per_cell():
    """Within the port each cell is its sequential `als_train`: the same
    per-seed draw, the same half-epochs, segment rows included."""
    u, i, v, n_u, n_i = _coo(n=6000, seed=3)
    base = als.ALSConfig(rank=12, iterations=3, seed=7, split_cap=48)
    cfgs = [dataclasses.replace(base, reg=r, seed=s)
            for r, s in ((0.01, 7), (0.1, 8), (1.0, 7))]
    grid = als_grid.als_train_grid(u, i, v, n_u, n_i, cfgs, device="cpu",
                                   compute_rmse=True)
    assert len(grid) == 3
    for cfg, cell in zip(cfgs, grid):
        seq = als.als_train(u, i, v, n_u, n_i, cfg, device="cpu",
                            compute_rmse=True)
        assert _rel(cell.user_factors, seq.user_factors) < 1e-4
        assert _rel(cell.item_factors, seq.item_factors) < 1e-4
        assert cell.rmse_history == pytest.approx(seq.rmse_history, rel=1e-4)
        assert isinstance(cell.user_factors, np.ndarray)
    assert _rel(grid[0].user_factors, grid[2].user_factors) > 1e-3


def test_mixed_iterations_freeze_per_cell():
    """Cells with their own iteration counts in one grid: a finished cell
    keeps its factors, so each equals its own sequential train, and its
    RMSE history has its own length."""
    u, i, v, n_u, n_i = _coo(seed=5)
    base = als.ALSConfig(rank=8, iterations=0, seed=5, split_cap=64)
    cfgs = [dataclasses.replace(base, iterations=n, reg=r)
            for n, r in ((2, 0.1), (5, 0.1), (3, 0.02))]
    grid = als_grid.als_train_grid(u, i, v, n_u, n_i, cfgs, device="cpu",
                                   compute_rmse=True)
    for cfg, cell in zip(cfgs, grid):
        seq = als.als_train(u, i, v, n_u, n_i, cfg, device="cpu",
                            compute_rmse=True)
        assert _rel(cell.user_factors, seq.user_factors) < 1e-4
        assert _rel(cell.item_factors, seq.item_factors) < 1e-4
        assert len(cell.rmse_history) == cfg.iterations
        assert len(cell.epoch_times) == cfg.iterations
        assert cell.rmse_history == pytest.approx(seq.rmse_history, rel=1e-4)
    # same λ, 2 against 5 iterations: the horizon made them differ
    assert _rel(grid[0].user_factors, grid[1].user_factors) > 1e-3


@pytest.mark.parametrize("layout", ["packed", "blocked2"])
def test_forced_layouts_under_the_grid_match_aug(layout, monkeypatch):
    """PIO_GJ_LAYOUT reaches the grid's flattened [R·G, K, K] solves."""
    u, i, v, n_u, n_i = _coo(n=3000, seed=7)
    cfgs = [als.ALSConfig(rank=8, iterations=3, reg=r, seed=1, solver="gj")
            for r in (0.05, 0.5)]
    aug = als_grid.als_train_grid(u, i, v, n_u, n_i, cfgs, device="cpu",
                                  compute_rmse=True)
    called = []
    # packed and blocked2 at K ≤ 64 run gj_packed_reg's and
    # gj_blocked2_reg's plain versions
    plain = {"packed": "gj_solve_packed_reg_plain",
             "blocked2": "gj_solve_pair_plain"}[layout]
    real = getattr(spd_solve, plain)
    monkeypatch.setattr(spd_solve, plain,
                        lambda *a, **k: called.append(1) or real(*a, **k))
    monkeypatch.setenv("PIO_GJ_LAYOUT", layout)
    forced = als_grid.als_train_grid(u, i, v, n_u, n_i, cfgs, device="cpu",
                                     compute_rmse=True)
    assert called
    for f, a in zip(forced, aug):
        assert _rel(f.user_factors, a.user_factors) < 1e-4
        assert _rel(f.item_factors, a.item_factors) < 1e-4
        np.testing.assert_allclose(f.rmse_history, a.rmse_history,
                                   rtol=2e-3)


def test_grid_groups_match_reference():
    """The stock rank × λ grid partitions into one group per rank, and a
    cg cell stands alone — the reference's partition."""
    base = ref_als.ALSConfig(rank=8, iterations=3, reg=0.1)
    ref_cfgs = [dataclasses.replace(base, rank=r, reg=lam)
                for r in (8, 16) for lam in (0.01, 0.1)]
    ref_cfgs += [dataclasses.replace(base, solver="cg"),
                 dataclasses.replace(base, iterations=7, seed=3)]
    port_cfgs = [_port_cfg(c) for c in ref_cfgs]
    assert als_grid.grid_groups(port_cfgs) == ref_grid.grid_groups(ref_cfgs)
    assert als_grid.grid_groups(port_cfgs) == [[0, 1, 5], [2, 3], [4]]


@pytest.mark.parametrize("field,value", [
    ("rank", 16), ("implicit", True), ("split_cap", 64), ("cap_growth", 2.0),
    ("compute_dtype", "bfloat16"), ("weighted_reg", False)])
def test_grid_compatible_matches_reference(field, value):
    base = ref_als.ALSConfig(rank=8, iterations=3, reg=0.1)
    ref_cfgs = [base, dataclasses.replace(base, **{field: value})]
    port_cfgs = [_port_cfg(c) for c in ref_cfgs]
    reason = als_grid.grid_compatible(port_cfgs)
    assert reason == ref_grid.grid_compatible(ref_cfgs)
    assert field in reason
    ok = [dataclasses.replace(base, reg=r, alpha=a, seed=s, iterations=n)
          for r, a, s, n in ((0.01, 1.0, 0, 2), (0.1, 2.0, 1, 5))]
    assert als_grid.grid_compatible([_port_cfg(c) for c in ok]) is None
    cg = [_port_cfg(dataclasses.replace(base, solver="cg"))] * 2
    assert "cg" in als_grid.grid_compatible(cg)
    assert als_grid.grid_compatible([]) == "empty grid"


def test_device_factors_stay_tensors():
    u, i, v, n_u, n_i = _coo(n=1500, seed=9)
    cfgs = [als.ALSConfig(rank=4, iterations=2, reg=r) for r in (0.1, 1.0)]
    host = als_grid.als_train_grid(u, i, v, n_u, n_i, cfgs, device="cpu")
    dev = als_grid.als_train_grid(u, i, v, n_u, n_i, cfgs, device="cpu",
                                  host_factors=False)
    for h, d in zip(host, dev):
        assert isinstance(d.user_factors, torch.Tensor)
        assert isinstance(d.item_factors, torch.Tensor)
        np.testing.assert_array_equal(d.user_factors.numpy(), h.user_factors)
        np.testing.assert_array_equal(d.item_factors.numpy(), h.item_factors)


def test_grid_log_records_each_call(monkeypatch):
    """Each call leaves one record: grid points, rank, the longest cell's
    steps, and its set-up and step seconds."""
    monkeypatch.setattr(als_grid, "grid_log", [])
    u, i, v, n_u, n_i = _coo(n=1500, seed=11)
    cfgs = [als.ALSConfig(rank=4, iterations=n, reg=0.1) for n in (2, 3)]
    als_grid.als_train_grid(u, i, v, n_u, n_i, cfgs, device="cpu")
    (record,) = als_grid.grid_log
    assert {k: record[k] for k in ("cells", "rank", "steps")} == {
        "cells": 2, "rank": 4, "steps": 3}
    assert record["setup_s"] > 0 and record["steps_s"] > 0


def test_bad_grids_raise():
    u, i, v, n_u, n_i = _coo(n=500, n_u=30, n_i=20)
    with pytest.raises(ValueError, match="rank"):
        als_grid.als_train_grid(u, i, v, n_u, n_i,
                                [als.ALSConfig(rank=8), als.ALSConfig(rank=16)],
                                device="cpu")
    with pytest.raises(ValueError, match="init_item_factors"):
        als_grid.als_train_grid(
            u, i, v, n_u, n_i, [als.ALSConfig(rank=4, iterations=1)] * 2,
            device="cpu", init_item_factors=np.zeros((n_i, 3, 4), np.float32))
