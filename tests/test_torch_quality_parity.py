"""The port's quality-parity harness (`quality/mllib_als.py`,
`quality/parity.py`, `python -m predictionio_torch.quality`) on the CPU:

- every case of the reference's tests/test_quality_parity.py, run on the
  port: the MLlib-faithful row solves, and the port's ALS against the
  MLlib-faithful ALS on held-out RMSE and MAP@10 at CI size;
- the port's copies beside the reference's: `mllib_als_train` bit for
  bit, `rmse_heldout` and `map_at_k_heldout` equal on the same factors,
  and `run_parity` at `100k` (the port's ALS started from the
  reference's initial item factors) with the same MLlib-faithful side and
  the port's RMSE within rel 2e-3 of the reference's (the ALS trajectory
  bar, tests/test_pallas_solve.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.quality import mllib_als as ref_mllib
from predictionio_tpu.quality import parity as ref_parity
from predictionio_torch.ops.als import ALSConfig, als_train
from predictionio_torch.quality import datasets
from predictionio_torch.quality.__main__ import main as quality_main
from predictionio_torch.quality.mllib_als import mllib_als_train, solve_one_row
from predictionio_torch.quality.parity import (
    map_at_k_heldout,
    parity_split,
    reference_side,
    rmse_heldout,
    run_parity,
)

torch.set_num_threads(1)


def _ref_init(n_items, rank, seed):
    """The reference's initial item factors (ops/als.py::als_train)."""
    return np.asarray(jax.random.normal(jax.random.key(seed),
                                        (n_items, rank), dtype=jnp.float32)
                      / np.sqrt(rank))


# -- the reference's cases --------------------------------------------------

def test_solve_one_row_matches_batched_explicit():
    """The standalone Cholesky row solve and the batched _solve_side path
    must agree (two independent factorizations of the same system)."""
    rng = np.random.default_rng(0)
    n_items, k = 50, 8
    Y = rng.standard_normal((n_items, k)).astype(np.float32)
    cols = rng.choice(n_items, 12, replace=False).astype(np.int32)
    vals = rng.uniform(1, 5, 12).astype(np.float32)
    x1 = solve_one_row(Y, cols, vals, reg=0.1)
    res = mllib_als_train(np.zeros(12, np.int32), cols, vals, 1, n_items,
                          rank=k, iterations=1, reg=0.1, seed=0)
    # after one iteration the user row was solved against the *updated*
    # item factors, so recompute the expected row against those
    expect = solve_one_row(res.item_factors, cols, vals, reg=0.1)
    np.testing.assert_allclose(res.user_factors[0], expect, rtol=1e-5)
    assert x1.shape == (k,)


def test_weighted_reg_scales_with_count():
    """ALS-WR: duplicating every rating doubles A, b and λn uniformly, so
    the solution is the same."""
    rng = np.random.default_rng(1)
    Y = rng.standard_normal((20, 4)).astype(np.float32)
    cols = np.array([1, 5, 9], np.int32)
    vals = np.array([4.0, 2.0, 5.0], np.float32)
    x1 = solve_one_row(Y, cols, vals, reg=0.3)
    x2 = solve_one_row(Y, np.tile(cols, 2), np.tile(vals, 2), reg=0.3)
    np.testing.assert_allclose(x1, x2, rtol=1e-6)


def test_implicit_row_matches_hkv_formula():
    rng = np.random.default_rng(2)
    Y = rng.standard_normal((30, 6)).astype(np.float32)
    cols = np.array([0, 7, 19], np.int32)
    vals = np.array([3.0, 1.0, 2.0], np.float32)
    alpha, reg = 2.0, 0.5
    x = solve_one_row(Y, cols, vals, reg, implicit=True, alpha=alpha)
    Y64 = Y.astype(np.float64)
    C = np.ones(len(Y64))
    C[cols] += alpha * vals  # c = 1 + αr on observed, 1 elsewhere
    p = np.zeros(len(Y64))
    p[cols] = 1.0
    A = Y64.T @ (C[:, None] * Y64) + reg * len(cols) * np.eye(6)
    b = Y64.T @ (C * p)
    np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=1e-5)


def test_explicit_parity_small():
    """Both implementations reach the same held-out RMSE (±0.01) on the
    `100k` planted dataset, through disjoint code paths."""
    split = datasets.synth_explicit("100k", seed=3)
    rank, iters, reg = 16, 8, 0.1
    ours = als_train(split.train_u, split.train_i, split.train_r,
                     split.n_users, split.n_items,
                     ALSConfig(rank=rank, iterations=iters, reg=reg, seed=3),
                     device="cpu")
    ref = mllib_als_train(split.train_u, split.train_i, split.train_r,
                          split.n_users, split.n_items, rank=rank,
                          iterations=iters, reg=reg, seed=3)
    r_ours = rmse_heldout(ours.user_factors, ours.item_factors, split)
    r_ref = rmse_heldout(ref.user_factors, ref.item_factors, split)
    assert abs(r_ours - r_ref) < 0.01, (r_ours, r_ref)
    # both learned (the global-mean predictor's RMSE is about 1.1 here)
    assert r_ours < 1.0 and r_ref < 1.0


def test_implicit_parity_small():
    split = datasets.synth_implicit("100k", seed=4)
    n_tr, n_te = 30_000, 3_000
    split = datasets.RatingSplit(
        split.train_u[:n_tr], split.train_i[:n_tr], split.train_r[:n_tr],
        split.test_u[:n_te], split.test_i[:n_te], split.test_r[:n_te],
        split.n_users, split.n_items)
    rank, iters, reg, alpha = 16, 8, 0.05, 40.0
    ours = als_train(split.train_u, split.train_i, split.train_r,
                     split.n_users, split.n_items,
                     ALSConfig(rank=rank, iterations=iters, reg=reg,
                               implicit=True, alpha=alpha, seed=4),
                     device="cpu")
    ref = mllib_als_train(split.train_u, split.train_i, split.train_r,
                          split.n_users, split.n_items, rank=rank,
                          iterations=iters, reg=reg, implicit=True,
                          alpha=alpha, seed=4)
    m_ours = map_at_k_heldout(ours.user_factors, ours.item_factors, split,
                              10, max_users=3000)
    m_ref = map_at_k_heldout(ref.user_factors, ref.item_factors, split,
                             10, max_users=3000)
    # MAP is noisier than RMSE at this scale; relative agreement
    assert m_ours > 0.5 * m_ref and m_ref > 0.5 * m_ours, (m_ours, m_ref)
    assert m_ours > 0.01 and m_ref > 0.01  # both learned a ranking signal


def test_run_parity_smoke():
    out = run_parity(mode="explicit", scale="100k", rank=8, iterations=3,
                     reg=0.1, seed=5, device="cpu")
    assert out["metric"] == "rmse"
    assert "rmse" in out["ours"] and "rmse" in out["ref"]
    assert out["ours"]["device"] == "cpu"
    assert abs(out["delta"]) < 0.1


# -- the port's copies beside the reference's -------------------------------

@pytest.mark.parametrize("implicit", [False, True])
def test_mllib_als_train_bitwise_the_reference(implicit):
    rng = np.random.default_rng(7)
    n_u, n_i, nnz = 60, 45, 900
    u = rng.integers(0, n_u, nnz).astype(np.int32)
    i = rng.integers(0, n_i, nnz).astype(np.int32)
    r = (rng.integers(-2, 11, nnz) / 2).astype(np.float32)
    kw = dict(rank=6, iterations=3, reg=0.07, implicit=implicit, alpha=3.0,
              seed=11)
    got = mllib_als_train(u, i, r, n_u + 3, n_i + 2, **kw)
    want = ref_mllib.mllib_als_train(u, i, r, n_u + 3, n_i + 2, **kw)
    assert np.array_equal(got.user_factors, want.user_factors)
    assert np.array_equal(got.item_factors, want.item_factors)
    assert len(got.epoch_times) == len(want.epoch_times) == 3
    np.testing.assert_array_equal(
        solve_one_row(got.item_factors, i[:9], r[:9], 0.07, implicit, 3.0),
        ref_mllib.solve_one_row(want.item_factors, i[:9], r[:9], 0.07,
                                implicit, 3.0))


def test_heldout_metrics_equal_the_reference():
    split = datasets.synth_implicit("100k", seed=2)
    rng = np.random.default_rng(9)
    uf = rng.standard_normal((split.n_users, 8)).astype(np.float32)
    itf = rng.standard_normal((split.n_items, 8)).astype(np.float32)
    assert (rmse_heldout(uf, itf, split)
            == ref_parity.rmse_heldout(uf, itf, split))
    for max_users, chunk in ((None, 2048), (300, 128)):
        assert (map_at_k_heldout(uf, itf, split, 10, max_users, chunk)
                == ref_parity.map_at_k_heldout(uf, itf, split, 10,
                                               max_users, chunk))


def test_run_parity_against_the_reference():
    """`run_parity` at `100k` beside the reference's: the same
    MLlib-faithful side, and the port's ALS (from the reference's initial
    item factors) within the trajectory bar. A side trained apart
    (`reference_side`) gives the same result."""
    kw = dict(mode="explicit", scale="100k", rank=8, iterations=3, reg=0.1,
              seed=5)
    want = ref_parity.run_parity(**kw)
    split = parity_split("explicit", "100k", 5)
    init = _ref_init(split.n_items, 8, 5)
    got = run_parity(**kw, device="cpu", split=split, init_item_factors=init)
    assert got["ref"]["rmse"] == want["ref"]["rmse"]
    assert got["ref"].keys() == want["ref"].keys()
    assert got["metric"] == want["metric"] == "rmse"
    assert (got["n_train"], got["n_test"]) == (want["n_train"],
                                               want["n_test"])
    np.testing.assert_allclose(got["ours"]["rmse"], want["ours"]["rmse"],
                               rtol=2e-3)
    side = reference_side(split, "explicit", 8, 3, 0.1, seed=5)
    apart = run_parity(**kw, device="cpu", split=split, ref_side=side,
                       init_item_factors=init)
    assert apart["ref"]["rmse"] == got["ref"]["rmse"]
    assert apart["ours"]["rmse"] == got["ours"]["rmse"]


def test_command_line_on_the_cpu(capsys):
    assert quality_main(["--mode", "implicit", "--scale", "100k", "--rank",
                         "4", "--iters", "2", "--reg", "0.05", "--cpu",
                         "--map-max-users", "200"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "map10" and out["mode"] == "implicit"
    assert out["ours"]["device"] == "cpu"
    assert out["ours"]["map10"] > 0 and out["ref"]["map10"] > 0
    assert out["delta"] == round(out["ours"]["map10"]
                                 - out["ref"]["map10"], 4)
