"""The ``packed`` layout on the register kernels (`gj_solve_packed_reg_plain`,
the arithmetic of csrc/gj_reg.cu's `gj_packed_reg`) and both layouts at
64 < K ≤ 128 on the block kernels (`gj_solve_cta_plain`, the arithmetic of
csrc/gj_cta.cu), on the CPU: against numpy and the reference's
`_build_solver_packed` / `_build_solver_aug` in interpret mode (max-rel <
1e-4), against the plain versions of the kernels they took the ranks from
(rel < 1e-6), on an A that is not symmetric (packed solves Aᵀx = b, aug
Ax = b, as in the reference), through the routing by K, and through ALS
trains held to the reference's RMSE bar (rtol 2e-3)."""

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

PACKED_RANKS = [1, 8, 10, 16, 31, 33, 64, 65, 80, 100, 127, 128]
CTA_RANKS = [65, 80, 96, 100, 128]
R = 5


def _spd_batch(seed, r, k):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(r, k, k)).astype(np.float32)
    a = y @ y.transpose(0, 2, 1) + 0.5 * k * np.eye(k, dtype=np.float32)
    b = rng.normal(size=(r, k)).astype(np.float32)
    return a, b


def _nonsymmetric_batch(seed, r, k):
    """A = N + 2k·I with N standard normal: far from symmetric, and
    diagonally dominant enough that no step needs pivoting."""
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


def _port(a, b, layout):
    return spd_solve.gj_solve(torch.from_numpy(a), torch.from_numpy(b),
                              layout=layout).numpy()


def _ref(a, b, layout):
    return np.asarray(ref.gj_solve(jnp.asarray(a), jnp.asarray(b),
                                   interpret=True, layout=layout))


@pytest.fixture(autouse=True)
def _no_launches():
    """Every solve here is on CPU tensors: no kernel may launch."""
    spd_solve.reset_launches()
    yield
    assert not any(spd_solve.launches.values()), spd_solve.launches


@pytest.mark.parametrize("k", PACKED_RANKS)
def test_packed_plain_matches_numpy_and_reference(k):
    """`gj_solve(layout="packed")` on the CPU runs the plain version of
    the kernel `packed_kernel(k)` names: `gj_packed_reg`'s up to K = 64,
    `gj_packed_cta`'s above."""
    a, b = _spd_batch(k, R, k)
    x = _port(a, b, "packed")
    assert x.shape == (R, k)
    assert _rel(x, _solve64(a.transpose(0, 2, 1), b)) < 1e-4
    assert _rel(x, _ref(a, b, "packed")) < 1e-4


@pytest.mark.parametrize("k", CTA_RANKS)
def test_aug_cta_plain_matches_numpy_and_reference(k):
    a, b = _spd_batch(1000 + k, R, k)
    x = spd_solve.gj_solve_cta_plain(torch.from_numpy(a),
                                     torch.from_numpy(b)).numpy()
    assert _rel(x, _solve64(a, b)) < 1e-4
    assert _rel(x, _ref(a, b, "aug")) < 1e-4
    np.testing.assert_array_equal(_port(a, b, "aug"), x)


@pytest.mark.parametrize("k", [10, 64, 80, 128])
def test_layouts_on_a_nonsymmetric_a(k):
    """Packed eliminates the columns of A, so it solves Aᵀx = b, as the
    reference's packed kernel does; aug solves Ax = b."""
    a, b = _nonsymmetric_batch(2000 + k, R, k)
    x_t, x = _solve64(a.transpose(0, 2, 1), b), _solve64(a, b)
    assert _rel(x_t, x) > 1e-3  # the two systems are told apart
    packed = _port(a, b, "packed")
    assert _rel(packed, x_t) < 1e-4
    assert _rel(packed, _ref(a, b, "packed")) < 1e-4
    aug = _port(a, b, "aug")
    assert _rel(aug, x) < 1e-4
    assert _rel(aug, _ref(a, b, "aug")) < 1e-4


@pytest.mark.parametrize("k", [8, 33, 64, 65, 128])
def test_packed_is_the_aug_elimination_of_the_transpose(k):
    """The packed kernels run the aug kernels' body on [Aᵀ | b]: their
    plain versions agree bit for bit."""
    a, b = _nonsymmetric_batch(3000 + k, R, k)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if k <= 64:
        packed = spd_solve.gj_solve_packed_reg_plain(ta, tb)
        aug = spd_solve.gj_solve_reg_plain(ta.transpose(1, 2), tb)
    else:
        packed = spd_solve.gj_solve_cta_plain(ta, tb, transpose=True)
        aug = spd_solve.gj_solve_cta_plain(ta.transpose(1, 2), tb)
    assert torch.equal(packed, aug)


@pytest.mark.parametrize("k", [1, 10, 33, 64, 65, 96, 97, 128])
def test_new_plains_match_the_plains_they_replace(k):
    """Against the plain versions of `gj_packed` and `gj_aug`, the kernels
    these ranks ran on before: the reciprocal, the unscaled pivot row and
    the skipped columns left of the pivot change nothing beyond rounding.
    """
    a, b = _nonsymmetric_batch(4000 + k, R, k)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    old_packed = spd_solve.gj_solve_packed_plain(ta, tb).numpy()
    packed = _port(a, b, "packed")
    assert _rel(packed, old_packed) < 1e-6
    if k > 64:
        old_aug = spd_solve.gj_solve_plain(ta, tb).numpy()
        assert _rel(_port(a, b, "aug"), old_aug) < 1e-6


@pytest.mark.parametrize("layout,k", [("packed", 8), ("packed", 64),
                                      ("packed", 80), ("packed", 128),
                                      ("aug", 65), ("aug", 128)])
def test_all_zero_system_is_exactly_zero(layout, k):
    a, b = _spd_batch(5000 + k, 4, k)
    a[2] = 0.0
    b[2] = 0.0
    x = _port(a, b, layout)
    assert np.isfinite(x).all()
    np.testing.assert_array_equal(x[2], np.zeros(k, np.float32))
    assert _rel(np.delete(x, 2, axis=0),
                _port(np.delete(a, 2, axis=0), np.delete(b, 2, axis=0),
                      layout)) == 0.0


_PLAIN = {"gj_aug_reg": "gj_solve_reg_plain",
          "gj_aug_cta": "gj_solve_cta_plain",
          "gj_aug_split": "gj_solve_cta_plain",
          "gj_aug": "gj_solve_plain",
          "gj_packed_reg": "gj_solve_packed_reg_plain",
          "gj_packed_cta": "gj_solve_cta_plain",
          "gj_packed_split": "gj_solve_cta_plain",
          "gj_packed": "gj_solve_packed_plain"}


@pytest.mark.parametrize("k,suffix", [(1, "_reg"), (64, "_reg"),
                                      (65, "_cta"), (128, "_cta"),
                                      (129, "_split"), (255, "_split")])
@pytest.mark.parametrize("layout", ["aug", "packed"])
def test_layouts_route_by_rank(layout, k, suffix, monkeypatch):
    """`aug_kernel` and `packed_kernel` split at K = 64, 128 and 256; on
    the CPU `gj_solve` runs the named kernel's plain version, once."""
    kernel = f"gj_{layout}{suffix}"
    route = spd_solve.aug_kernel if layout == "aug" else \
        spd_solve.packed_kernel
    assert route(k) == kernel
    called = []
    for fn in set(_PLAIN.values()):
        real = getattr(spd_solve, fn)
        monkeypatch.setattr(
            spd_solve, fn,
            lambda *a, _fn=fn, _real=real, **kw: called.append(_fn)
            or _real(*a, **kw))
    a, b = _spd_batch(6000 + k, 2, k)
    x = _port(a, b, layout)
    assert called == [_PLAIN[kernel]]
    want = a.transpose(0, 2, 1) if layout == "packed" else a
    assert _rel(x, _solve64(want, b)) < 1e-4


def test_cta_plain_refuses_ranks_above_128():
    """The block kernels' plain version serves K ≤ 128 (rows in
    registers) and 128 < K ≤ 256 (rows split), and refuses above."""
    a, b = _spd_batch(1, 2, 257)
    with pytest.raises(ValueError, match="K ≤ 256"):
        spd_solve.gj_solve_cta_plain(torch.from_numpy(a),
                                     torch.from_numpy(b))


@pytest.mark.parametrize("rank,layout", [(80, "aug"), (128, "packed")])
def test_train_through_the_block_kernel_meets_reference_bar(
        rank, layout, monkeypatch):
    """A CPU ALS train at rank 80 under ``aug`` (what `auto` picks there)
    and at rank 128 under a forced ``packed``, each through the block
    kernel's plain version, against the reference's chol train."""
    rng = np.random.default_rng(23)
    n_u, n_i, nnz = 40, 30, 600
    ui = rng.integers(0, n_u, nnz).astype(np.int32)
    ii = rng.integers(0, n_i, nnz).astype(np.int32)
    r = rng.uniform(1, 5, nnz).astype(np.float32)
    calls = []
    real = spd_solve.gj_solve_cta_plain
    monkeypatch.setattr(spd_solve, "gj_solve_cta_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setenv("PIO_GJ_LAYOUT", layout)
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
    assert calls
    np.testing.assert_allclose(got.rmse_history, want.rmse_history,
                               rtol=2e-3)
