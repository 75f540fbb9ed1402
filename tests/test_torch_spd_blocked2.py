"""The ``blocked2`` layout on the pair kernels (`gj_solve_pair_plain`, the
arithmetic of csrc/gj_reg.cu's `gj_blocked2_reg` and csrc/gj_cta.cu's
`gj_blocked2_cta` and `gj_blocked2_split`: row Gauss-Jordan on [A | b],
two pivots a step through the 2×2 pivot-block inverse), on the CPU:
against numpy in float64 and the reference's `_build_solver_blocked2` in
interpret mode (max-rel < 1e-4), against the plain version of the kernel
these ranks ran on before (rel < 1e-5), on an A that is not symmetric
(blocked2 solves Ax = b), through the routing by K, and through ALS trains
held to the reference's RMSE bar (rtol 2e-3)."""

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

# each body's ends (warp: 2-64, block: 66-128, split: 130-256), K < KP
# padding (10, 50, 66) and L = K - 128 = 2 and 128 shared columns
PAIR_RANKS = [2, 10, 16, 50, 64, 66, 96, 128, 130, 192, 256]
R = 3


def _spd_batch(seed, r, k):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(r, k, k)).astype(np.float32)
    a = y @ y.transpose(0, 2, 1) + 0.5 * k * np.eye(k, dtype=np.float32)
    b = rng.normal(size=(r, k)).astype(np.float32)
    return a, b


def _nonsymmetric_batch(seed, r, k):
    """A = N + 2k·I with N standard normal: far from symmetric, and
    diagonally dominant enough that no pivot block needs pivoting."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(r, k, k)).astype(np.float32)
    a += 2.0 * k * np.eye(k, dtype=np.float32)
    b = rng.normal(size=(r, k)).astype(np.float32)
    return a, b


def _rel(x, want):
    return np.abs(x - want).max() / np.abs(want).max()


def _solve64(a, b):
    return np.linalg.solve(a.astype(np.float64),
                           b.astype(np.float64)[..., None])[..., 0]


def _port(a, b):
    return spd_solve.gj_solve(torch.from_numpy(a), torch.from_numpy(b),
                              layout="blocked2").numpy()


def _ref(a, b):
    return np.asarray(ref.gj_solve(jnp.asarray(a), jnp.asarray(b),
                                   interpret=True, layout="blocked2"))


@pytest.fixture(autouse=True)
def _no_launches():
    """Every solve here is on CPU tensors: no kernel may launch."""
    spd_solve.reset_launches()
    yield
    assert not any(spd_solve.launches.values()), spd_solve.launches


@pytest.mark.parametrize("k", PAIR_RANKS)
def test_pair_plain_matches_numpy_and_reference(k):
    a, b = _spd_batch(13_000 + k, R, k)
    x = _port(a, b)
    assert x.shape == (R, k)
    assert _rel(x, _solve64(a, b)) < 1e-4
    assert _rel(x, _ref(a, b)) < 1e-4


@pytest.mark.parametrize("k", PAIR_RANKS)
def test_pair_plain_matches_the_plain_it_replaces(k):
    """Against the plain version of gj_layouts.cu's `gj_blocked2`, which
    ran these ranks before: the multipliers through P⁻¹ in place of the
    normalised pivot rows, and the columns left of the pair left alone,
    change nothing beyond rounding."""
    a, b = _nonsymmetric_batch(14_000 + k, 2, k)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert _rel(spd_solve.gj_solve_pair_plain(ta, tb).numpy(),
                spd_solve.gj_solve_blocked2_plain(ta, tb).numpy()) < 1e-5


@pytest.mark.parametrize("k", [10, 96, 192])
def test_blocked2_solves_a_nonsymmetric_a(k):
    """Rows are eliminated, so blocked2 solves Ax = b (not Aᵀx = b), as
    the reference's blocked2 kernel does."""
    a, b = _nonsymmetric_batch(15_000 + k, 2, k)
    x = _port(a, b)
    assert _rel(_solve64(a.transpose(0, 2, 1), b), _solve64(a, b)) > 1e-3
    assert _rel(x, _solve64(a, b)) < 1e-4
    assert _rel(x, _ref(a, b)) < 1e-4


@pytest.mark.parametrize("k", [2, 64, 128, 256])
def test_all_zero_system_is_exactly_zero(k):
    a, b = _spd_batch(16_000 + k, 3, k)
    a[1] = 0.0
    b[1] = 0.0
    x = _port(a, b)
    assert np.isfinite(x).all()
    np.testing.assert_array_equal(x[1], np.zeros(k, np.float32))
    np.testing.assert_array_equal(
        np.delete(x, 1, axis=0),
        _port(np.delete(a, 1, axis=0), np.delete(b, 1, axis=0)))


@pytest.mark.parametrize("k", [15, 129])
def test_odd_rank_is_refused_as_the_reference_refuses_it(k):
    a, b = _spd_batch(17_000 + k, 2, k)
    with pytest.raises(ValueError, match=f"needs even rank, got {k}"):
        _port(a, b)
    with pytest.raises(ValueError, match=f"needs even rank, got {k}"):
        spd_solve.gj_solve_pair_plain(torch.from_numpy(a),
                                      torch.from_numpy(b))
    with pytest.raises(ValueError, match=f"needs even rank, got {k}"):
        _ref(a, b)


@pytest.mark.parametrize("k,kernel", [
    (2, "gj_blocked2_reg"), (64, "gj_blocked2_reg"),
    (66, "gj_blocked2_cta"), (128, "gj_blocked2_cta"),
    (130, "gj_blocked2_split"), (256, "gj_blocked2_split"),
    (258, "gj_blocked2")])
def test_blocked2_routes_by_rank(k, kernel, monkeypatch):
    """The pair kernels take even K ≤ 256; the old kernel keeps K > 256,
    which `gj_applicable` refuses, so no train reaches it. On the CPU
    `gj_solve` runs the named kernel's plain version, once."""
    assert spd_solve.blocked2_kernel(k) == kernel
    called = []
    for fn in ("gj_solve_pair_plain", "gj_solve_blocked2_plain"):
        real = getattr(spd_solve, fn)
        monkeypatch.setattr(
            spd_solve, fn,
            lambda *a, _fn=fn, _real=real, **kw: called.append(_fn)
            or _real(*a, **kw))
    a, b = _spd_batch(18_000 + k, 2, k)
    x = _port(a, b)
    assert called == ["gj_solve_blocked2_plain" if kernel == "gj_blocked2"
                      else "gj_solve_pair_plain"]
    assert _rel(x, _solve64(a, b)) < 1e-4


def test_pair_plain_refuses_ranks_above_256():
    a = torch.eye(258).expand(2, 258, 258)
    with pytest.raises(ValueError, match="K ≤ 256"):
        spd_solve.gj_solve_pair_plain(a, torch.ones(2, 258))


@pytest.mark.parametrize("name,k,match", [
    ("gj_blocked2_reg", 63, "needs even rank"),
    ("gj_blocked2_reg", 66, "K ≤ 64"),
    ("gj_blocked2_cta", 99, "needs even rank"),
    ("gj_blocked2_cta", 130, "K ≤ 128"),
    ("gj_blocked2_split", 193, "needs even rank"),
    ("gj_blocked2_split", 128, "129 ≤ K ≤ 256"),
    ("gj_blocked2_split", 258, "129 ≤ K ≤ 256")])
def test_pair_wrappers_refuse_ranks_they_do_not_take(name, k, match):
    """The wrappers check the rank before the device: odd K, and K out of
    the kernel's range, never reach a kernel."""
    a = torch.eye(k).expand(2, k, k)
    with pytest.raises(ValueError, match=match):
        spd_solve._launch(name, a, torch.ones(2, k, 1))


@pytest.mark.parametrize("rank", [64, 128, 192])
def test_train_under_blocked2_meets_reference_bar(rank, monkeypatch):
    """A CPU ALS train under a forced ``blocked2`` at the top of each pair
    body's ranks and at rank 192 (split, L = 64), each through the pair
    kernels' plain version, against the reference's chol train."""
    rng = np.random.default_rng(31)
    n_u, n_i, nnz = 40, 30, 600
    ui = rng.integers(0, n_u, nnz).astype(np.int32)
    ii = rng.integers(0, n_i, nnz).astype(np.int32)
    r = rng.uniform(1, 5, nnz).astype(np.float32)
    calls = []
    real = spd_solve.gj_solve_pair_plain
    monkeypatch.setattr(spd_solve, "gj_solve_pair_plain",
                        lambda *a, **kw: calls.append(a[0].shape[1])
                        or real(*a, **kw))
    monkeypatch.setenv("PIO_GJ_LAYOUT", "blocked2")
    cfg = ref_als.ALSConfig(rank=rank, iterations=3, reg=0.05, seed=0,
                            solver="chol", pallas="off")
    mesh = make_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1])
    want = ref_als.als_train(ui, ii, r, n_u, n_i, cfg, mesh=mesh,
                             compute_rmse=True)
    init = np.asarray(jax.random.normal(jax.random.key(0), (n_i, rank),
                                        dtype=jnp.float32) / np.sqrt(rank))
    got = als.als_train(ui, ii, r, n_u, n_i,
                        als.ALSConfig(rank=rank, iterations=3, reg=0.05,
                                      seed=0, solver="gj"),
                        device="cpu", compute_rmse=True,
                        init_item_factors=init)
    assert calls and set(calls) == {rank}
    np.testing.assert_allclose(got.rmse_history, want.rmse_history,
                               rtol=2e-3)
