"""The port's ALS (predictionio_torch/ops/als.py) on the CPU against the
reference's `als_train`, fed the same COO ratings and the reference's own
initial item factors: RMSE trajectories within rtol 2e-3 (the reference's
gj-vs-chol bar, tests/test_pallas_solve.py) and the factors allclose."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as ref_als
from predictionio_tpu.parallel.mesh import make_mesh
from predictionio_torch.ops import als, spd_solve

# one intra-op thread: these tests use small tensors, and the suite's
# parallel workers share the machine's cores with timing-sensitive tests
torch.set_num_threads(1)


def _data(seed=3, n_u=40, n_i=30, nnz=600):
    rng = np.random.default_rng(seed)
    ui = rng.integers(0, n_u, nnz).astype(np.int32)
    ii = rng.integers(0, n_i, nnz).astype(np.int32)
    r = rng.uniform(1, 5, nnz).astype(np.float32)
    return ui, ii, r, n_u, n_i


def _ref_init(n_items, rank, seed):
    """The reference's initial item factors (ops/als.py::als_train)."""
    key = jax.random.key(seed)
    return np.asarray(jax.random.normal(key, (n_items, rank),
                                        dtype=jnp.float32) / np.sqrt(rank))


def _ref_train(ui, ii, r, n_u, n_i, cfg):
    mesh = make_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1])
    return ref_als.als_train(ui, ii, r, n_u, n_i, cfg, mesh=mesh,
                             compute_rmse=True)


def _port_train(ui, ii, r, n_u, n_i, ref_cfg, **overrides):
    fields = {f.name for f in dataclasses.fields(als.ALSConfig)}
    kw = {k: v for k, v in dataclasses.asdict(ref_cfg).items() if k in fields}
    kw.update(overrides)
    cfg = als.ALSConfig(**kw)
    return als.als_train(ui, ii, r, n_u, n_i, cfg, device="cpu",
                         compute_rmse=True,
                         init_item_factors=_ref_init(n_i, cfg.rank, cfg.seed))


def _assert_parity(port, ref):
    np.testing.assert_allclose(port.rmse_history, ref.rmse_history, rtol=2e-3)
    np.testing.assert_allclose(port.user_factors, ref.user_factors,
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(port.item_factors, ref.item_factors,
                               rtol=2e-3, atol=2e-4)


@pytest.fixture(autouse=True)
def _cpu_never_launches():
    spd_solve.reset_launches()
    yield
    assert not any(spd_solve.launches.values()), spd_solve.launches


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("port_solver", ["gj", "chol"])
def test_matches_reference_trajectory(implicit, port_solver):
    ui, ii, r, n_u, n_i = _data()
    cfg = ref_als.ALSConfig(rank=8, iterations=5, reg=0.05, seed=0,
                            implicit=implicit, solver="chol", pallas="off")
    ref = _ref_train(ui, ii, r, n_u, n_i, cfg)
    port = _port_train(ui, ii, r, n_u, n_i, cfg, solver=port_solver)
    _assert_parity(port, ref)


@pytest.mark.parametrize("solver", ["lu", "cg"])
def test_other_solvers_match_reference(solver):
    ui, ii, r, n_u, n_i = _data(seed=5)
    cfg = ref_als.ALSConfig(rank=8, iterations=4, reg=0.05, seed=1,
                            solver=solver, pallas="off")
    ref = _ref_train(ui, ii, r, n_u, n_i, cfg)
    port = _port_train(ui, ii, r, n_u, n_i, cfg)
    if solver == "cg":
        # a fixed number of CG steps stops short of the exact solve, so the
        # two sums' rounding carries into the factors: hold the trajectory
        np.testing.assert_allclose(port.rmse_history, ref.rmse_history,
                                   rtol=2e-3)
    else:
        _assert_parity(port, ref)


@pytest.mark.parametrize("implicit", [False, True])
def test_split_rows_accumulate_like_reference(implicit):
    """split_cap below the row counts: hot rows train as summed segments
    through the sentinel-row accumulators."""
    ui, ii, r, n_u, n_i = _data(seed=7, n_u=12, n_i=50, nnz=500)
    buckets, split = als.bucket_ragged_split(ui, ii, r, n_u, 8, 16)
    assert len(split) > 0 and any(b.segmap is not None for b in buckets)
    cfg = ref_als.ALSConfig(rank=6, iterations=4, reg=0.1, seed=2,
                            implicit=implicit, split_cap=16, solver="chol",
                            pallas="off")
    ref = _ref_train(ui, ii, r, n_u, n_i, cfg)
    port = _port_train(ui, ii, r, n_u, n_i, cfg, solver="gj")
    _assert_parity(port, ref)


def test_chunked_bucket_walk_matches_reference(monkeypatch):
    """A shrunken chunk budget walks every bucket in row chunks; the math
    per row is unchanged."""
    ui, ii, r, n_u, n_i = _data(seed=9)
    cfg = ref_als.ALSConfig(rank=8, iterations=3, reg=0.05, seed=3,
                            solver="chol", pallas="off")
    ref = _ref_train(ui, ii, r, n_u, n_i, cfg)
    monkeypatch.setattr(als, "_CHUNK_BUDGET_BYTES", 8 * 8 * 4 * 16)
    assert als._bucket_chunk_rows(48, 16, 8, 8) < 48
    chunks = []
    real_walk = als._walk_bucket_chunks

    def counting_walk(arrays, cap, k, row_multiple, fn, carry):
        chunks.append(als._bucket_chunk_rows(arrays[0].shape[0], cap, k,
                                             row_multiple)
                      < arrays[0].shape[0])
        return real_walk(arrays, cap, k, row_multiple, fn, carry)

    monkeypatch.setattr(als, "_walk_bucket_chunks", counting_walk)
    port = _port_train(ui, ii, r, n_u, n_i, cfg, solver="gj")
    assert any(chunks)
    _assert_parity(port, ref)


def test_schur_rank_matches_reference():
    """Rank ≥ 96 takes the Schur recursion (odd splits at 100 → 50 → 25)."""
    ui, ii, r, n_u, n_i = _data(seed=11, n_u=30, n_i=25, nnz=500)
    cfg = ref_als.ALSConfig(rank=100, iterations=3, reg=0.5, seed=4,
                            solver="chol", pallas="off")
    ref = _ref_train(ui, ii, r, n_u, n_i, cfg)
    port = _port_train(ui, ii, r, n_u, n_i, cfg, solver="gj")
    np.testing.assert_allclose(port.rmse_history, ref.rmse_history, rtol=2e-3)


def test_bf16_compute_matches_reference():
    ui, ii, r, n_u, n_i = _data(seed=13)
    cfg = ref_als.ALSConfig(rank=8, iterations=3, reg=0.05, seed=5,
                            compute_dtype="bfloat16", solver="chol",
                            pallas="off")
    ref = _ref_train(ui, ii, r, n_u, n_i, cfg)
    port = _port_train(ui, ii, r, n_u, n_i, cfg)
    np.testing.assert_allclose(port.rmse_history, ref.rmse_history, rtol=2e-3)


def test_host_bucketizer_matches_reference():
    ui, ii, r, n_u, _ = _data(seed=15)
    for split_cap in (None, 16):
        mine, msplit = als.bucket_ragged_split(ui, ii, r, n_u, 8, split_cap)
        theirs, tsplit = ref_als.bucket_ragged_split(ui, ii, r, n_u, 8,
                                                     split_cap)
        np.testing.assert_array_equal(msplit, tsplit)
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            for name in ("rows", "cols", "vals", "mask"):
                np.testing.assert_array_equal(getattr(a, name),
                                              getattr(b, name))
            assert (a.segmap is None) == (b.segmap is None)
            if a.segmap is not None:
                np.testing.assert_array_equal(a.segmap, b.segmap)
    np.testing.assert_array_equal(als.cap_ladder(300, 8, 1.5),
                                  ref_als.cap_ladder(300, 8, 1.5))


def test_resolve_solver_keeps_gj_off_the_tpu():
    """Unlike the reference, 'auto'/'gj' never downgrade by device: only
    rank > 256 goes to 'chol'."""
    assert als.resolve_solver(als.ALSConfig(rank=64)).solver == "gj"
    assert als.resolve_solver(als.ALSConfig(rank=256)).solver == "gj"
    assert als.resolve_solver(als.ALSConfig(rank=300)).solver == "chol"
    assert als.resolve_solver(
        als.ALSConfig(rank=300, solver="gj")).solver == "chol"
    assert als.resolve_solver(
        als.ALSConfig(rank=64, solver="gj")).solver == "gj"
    assert als.resolve_solver(
        als.ALSConfig(rank=64, solver="lu")).solver == "lu"


def test_generator_init_is_seeded():
    ui, ii, r, n_u, n_i = _data(seed=17)
    cfg = als.ALSConfig(rank=8, iterations=2, reg=0.05, seed=7)
    a = als.als_train(ui, ii, r, n_u, n_i, cfg, device="cpu")
    b = als.als_train(ui, ii, r, n_u, n_i, cfg, device="cpu")
    np.testing.assert_array_equal(a.item_factors, b.item_factors)
    c = als.als_train(ui, ii, r, n_u, n_i,
                      dataclasses.replace(cfg, seed=8), device="cpu")
    assert not np.array_equal(a.item_factors, c.item_factors)
    assert len(a.epoch_times) == 2 and a.rmse_history == []


def test_unknown_solver_raises():
    ui, ii, r, n_u, n_i = _data(seed=19)
    with pytest.raises(ValueError, match="solver"):
        als.als_train(ui, ii, r, n_u, n_i,
                      als.ALSConfig(rank=4, iterations=1, solver="qr"),
                      device="cpu")


def test_bad_init_shape_raises():
    ui, ii, r, n_u, n_i = _data(seed=21)
    with pytest.raises(ValueError, match="init_item_factors"):
        als.als_train(ui, ii, r, n_u, n_i,
                      als.ALSConfig(rank=4, iterations=1), device="cpu",
                      init_item_factors=np.zeros((n_i, 5), np.float32))
