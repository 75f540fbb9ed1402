"""The multi-RHS register kernel's plain version
(`gj_solve_multi_reg_plain`, the arithmetic of csrc/gj_multi_reg.cu) and
`gj_solve_multi`'s routing on the CPU: against numpy and the reference's
`_build_solver_aug_multi` in interpret mode (max-rel < 1e-4), against the
shared-memory kernel's plain version (rel < 1e-6: padding to KP, the
reciprocal and skipping the columns left of the pivot change nothing
beyond rounding), through the Schur recursion at the ranks whose base it
is, and through a rank-128 ALS train held to the reference's RMSE bar
(rtol 2e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as ref_als
from predictionio_tpu.ops import pallas_solve as ref
from predictionio_tpu.parallel.mesh import make_mesh
from predictionio_torch.ops import als, spd_solve

# one intra-op thread: these tests use small tensors, and the suite's
# parallel workers share the machine's cores with timing-sensitive tests
torch.set_num_threads(1)

RANKS = [1, 8, 16, 17, 24, 25, 31, 32]
# one chunk (1, 5), a chunk boundary at 32 and 64 (33, 65), the rank-128
# base calls' widest (97), and several chunks (129; 225 at rank 256)
RHS = [1, 5, 33, 65, 97, 129, 225]
R = 5


def _spd_batch(seed, r, k, m):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(r, k, k)).astype(np.float32)
    a = y @ y.transpose(0, 2, 1) + 0.5 * k * np.eye(k, dtype=np.float32)
    b = rng.normal(size=(r, k, m)).astype(np.float32)
    return a, b


def _rel(x, want):
    return np.abs(x - want).max() / np.abs(want).max()


def _multi_reg(a, b):
    return spd_solve.gj_solve_multi_reg_plain(torch.from_numpy(a),
                                              torch.from_numpy(b)).numpy()


@pytest.fixture(autouse=True)
def _no_launches():
    """Every solve here is on CPU tensors: no kernel may launch."""
    spd_solve.reset_launches()
    yield
    assert not any(spd_solve.launches.values()), spd_solve.launches


@pytest.mark.parametrize("m", RHS)
@pytest.mark.parametrize("k", RANKS)
def test_multi_reg_plain_matches_numpy_and_reference(k, m):
    a, b = _spd_batch(k * 1000 + m, R, k, m)
    x = _multi_reg(a, b)
    assert x.shape == (R, k, m)
    want = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    assert _rel(x, want) < 1e-4
    x_ref = np.asarray(ref.gj_solve_multi(jnp.asarray(a), jnp.asarray(b),
                                          interpret=True))
    assert _rel(x, x_ref) < 1e-4


@pytest.mark.parametrize("m", RHS)
@pytest.mark.parametrize("k", RANKS)
def test_multi_reg_plain_matches_shared_memory_plain(k, m):
    a, b = _spd_batch(k * 1000 + m + 7, R, k, m)
    x_shared = spd_solve.gj_solve_multi_plain(torch.from_numpy(a),
                                              torch.from_numpy(b)).numpy()
    assert _rel(_multi_reg(a, b), x_shared) < 1e-6


@pytest.mark.parametrize("m", [1, 97])
@pytest.mark.parametrize("k", [1, 16, 24, 32])
def test_multi_reg_plain_all_zero_system_is_exactly_zero(k, m):
    a, b = _spd_batch(200 + k + m, 4, k, m)
    a[2] = 0.0
    b[2] = 0.0
    x = _multi_reg(a, b)
    assert np.isfinite(x).all()
    np.testing.assert_array_equal(x[2], np.zeros((k, m), np.float32))
    x_multi = spd_solve.gj_solve_multi(torch.from_numpy(a),
                                       torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(x_multi, x)


@pytest.mark.parametrize("k,m,kernel", [
    (1, 7, "gj_aug_multi_reg"), (16, 7, "gj_aug_multi_reg"),
    (17, 7, "gj_aug_multi_reg"), (32, 7, "gj_aug_multi_reg"),
    (32, 1, "gj_aug_multi_reg"), (33, 7, "gj_aug_multi_cta"),
    (49, 7, "gj_aug_multi_cta"), (64, 7, "gj_aug_multi_cta"),
    (49, 50, "gj_aug_multi_cta"), (128, 2, "gj_aug_multi_cta"),
    (33, 1, "gj_aug_reg"), (97, 1, "gj_aug_cta"), (129, 1, "gj_aug_split"),
    (129, 2, "gj_aug_multi")])
def test_multi_routes_by_rank(k, m, kernel, monkeypatch):
    """`multi_kernel` names the kernel by (K, M); on the CPU
    `gj_solve_multi` runs that kernel's plain version."""
    assert spd_solve.multi_kernel(k, m) == kernel
    plain = {"gj_aug_multi_reg": "gj_solve_multi_reg_plain",
             "gj_aug_multi_cta": "gj_solve_cta_plain",
             "gj_aug_multi": "gj_solve_multi_plain",
             "gj_aug_reg": "gj_solve_reg_plain",
             "gj_aug_cta": "gj_solve_cta_plain",
             "gj_aug_split": "gj_solve_cta_plain"}
    called = []
    for fn in set(plain.values()):
        real = getattr(spd_solve, fn)
        monkeypatch.setattr(
            spd_solve, fn,
            lambda *a, _fn=fn, _real=real, **kw: called.append(_fn)
            or _real(*a, **kw))
    a, b = _spd_batch(300 + k + m, 3, k, m)
    x = spd_solve.gj_solve_multi(torch.from_numpy(a),
                                 torch.from_numpy(b)).numpy()
    assert called == [plain[kernel]]
    assert x.shape == (3, k, m)
    assert _rel(x, np.linalg.solve(a, b)) < 1e-4


def test_multi_reg_plain_refuses_ranks_above_32():
    a, b = _spd_batch(1, 2, 33, 1)
    with pytest.raises(ValueError, match="K ≤ 32"):
        _multi_reg(a, b)


@pytest.mark.parametrize("rank,base_k", [(96, 24), (128, 32), (200, 25),
                                         (256, 32)])
def test_schur_matches_reference_through_the_register_base(
        rank, base_k, monkeypatch):
    """The recursion ends at K ≤ 32 on every one of these ranks, so each
    base call runs the register kernel's plain version."""
    called = []
    real = spd_solve.gj_solve_multi_reg_plain
    monkeypatch.setattr(
        spd_solve, "gj_solve_multi_reg_plain",
        lambda a, b: called.append((a.shape[1], b.shape[2])) or real(a, b))
    a, b = _spd_batch(rank, 3, rank, 1)
    b = b[..., 0]
    x = spd_solve.schur_solve(torch.from_numpy(a),
                              torch.from_numpy(b)).numpy()
    assert called and {k for k, _ in called} == {base_k}
    assert max(m for _, m in called) == rank - base_k + 1
    want = np.linalg.solve(a.astype(np.float64),
                           b.astype(np.float64)[..., None])[..., 0]
    assert _rel(x, want) < 1e-4
    x_ref = np.asarray(ref.schur_solve(jnp.asarray(a), jnp.asarray(b),
                                       interpret=True))
    assert _rel(x, x_ref) < 1e-4


def test_rank128_train_through_auto_meets_reference_bar(monkeypatch):
    """A CPU ALS train at rank 128 under `auto` (Schur over the register
    base's plain version) against the reference's chol train."""
    rng = np.random.default_rng(19)
    n_u, n_i, nnz = 40, 30, 600
    ui = rng.integers(0, n_u, nnz).astype(np.int32)
    ii = rng.integers(0, n_i, nnz).astype(np.int32)
    r = rng.uniform(1, 5, nnz).astype(np.float32)
    calls = []
    real = spd_solve.gj_solve_multi_reg_plain
    monkeypatch.setattr(spd_solve, "gj_solve_multi_reg_plain",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.delenv("PIO_GJ_LAYOUT", raising=False)
    cfg = ref_als.ALSConfig(rank=128, iterations=3, reg=0.05, seed=0,
                            solver="chol", pallas="off")
    mesh = make_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1])
    want = ref_als.als_train(ui, ii, r, n_u, n_i, cfg, mesh=mesh,
                             compute_rmse=True)
    init = np.asarray(jax.random.normal(jax.random.key(0), (n_i, 128),
                                        dtype=jnp.float32) / np.sqrt(128))
    got = als.als_train(ui, ii, r, n_u, n_i,
                        als.ALSConfig(rank=128, iterations=3, reg=0.05,
                                      seed=0, solver="gj"),
                        device="cpu", compute_rmse=True,
                        init_item_factors=init)
    assert calls
    np.testing.assert_allclose(got.rmse_history, want.rmse_history,
                               rtol=2e-3)
