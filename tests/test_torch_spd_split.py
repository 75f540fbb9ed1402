"""Both layouts at 128 < K ≤ 256 on the split block kernels
(`gj_solve_cta_plain`, the arithmetic of csrc/gj_cta.cu's `gj_aug_split`
and `gj_packed_split`, each row split between shared memory and
registers), on the CPU: against numpy in float64 and the reference's
`_build_solver_aug` / `_build_solver_packed` in interpret mode (max-rel <
1e-4), against the plain versions of the kernels these ranks ran on
before (rel < 1e-5), on an A that is not symmetric (packed solves
Aᵀx = b), through the routing by K, and through ALS trains held to the
reference's RMSE bar (rtol 2e-3)."""

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

# both ends of the split (L = K - 128 shared columns: 1, 2, 32, 64, 127,
# 128), a quad boundary and an odd L among them
SPLIT_RANKS = [129, 130, 160, 192, 255, 256]
R = 3


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


@pytest.mark.parametrize("layout", ["aug", "packed"])
@pytest.mark.parametrize("k", SPLIT_RANKS)
def test_split_plain_matches_numpy_and_reference(k, layout):
    a, b = _spd_batch(7000 + k, R, k)
    x = _port(a, b, layout)
    assert x.shape == (R, k)
    want = a.transpose(0, 2, 1) if layout == "packed" else a
    assert _rel(x, _solve64(want, b)) < 1e-4
    assert _rel(x, _ref(a, b, layout)) < 1e-4


@pytest.mark.parametrize("k", [129, 192, 256])
def test_layouts_on_a_nonsymmetric_a(k):
    """Packed eliminates the columns of A, so it solves Aᵀx = b, as the
    reference's packed kernel does; aug solves Ax = b."""
    a, b = _nonsymmetric_batch(8000 + k, 2, k)
    x_t, x = _solve64(a.transpose(0, 2, 1), b), _solve64(a, b)
    assert _rel(x_t, x) > 1e-3  # the two systems are told apart
    assert _rel(_port(a, b, "packed"), x_t) < 1e-4
    assert _rel(_port(a, b, "aug"), x) < 1e-4


@pytest.mark.parametrize("k", SPLIT_RANKS)
def test_packed_is_the_aug_elimination_of_the_transpose(k):
    """`gj_packed_split` runs `gj_aug_split`'s body on [Aᵀ | b]: the plain
    version agrees with itself on the transposed A bit for bit."""
    a, b = _nonsymmetric_batch(9000 + k, 2, k)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    packed = spd_solve.gj_solve_cta_plain(ta, tb, transpose=True)
    aug = spd_solve.gj_solve_cta_plain(ta.transpose(1, 2), tb)
    assert torch.equal(packed, aug)


@pytest.mark.parametrize("k", SPLIT_RANKS)
def test_split_plain_matches_the_plains_it_replaces(k):
    """Against the plain versions of `gj_aug` and `gj_packed`, which ran
    these ranks before: the reciprocal, the unscaled pivot row and the
    skipped columns left of the pivot change nothing beyond rounding."""
    a, b = _nonsymmetric_batch(10_000 + k, 2, k)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert _rel(_port(a, b, "aug"),
                spd_solve.gj_solve_plain(ta, tb).numpy()) < 1e-5
    assert _rel(_port(a, b, "packed"),
                spd_solve.gj_solve_packed_plain(ta, tb).numpy()) < 1e-5


@pytest.mark.parametrize("layout", ["aug", "packed"])
@pytest.mark.parametrize("k", [129, 255])
def test_all_zero_system_is_exactly_zero(k, layout):
    a, b = _spd_batch(11_000 + k, 3, k)
    a[1] = 0.0
    b[1] = 0.0
    x = _port(a, b, layout)
    assert np.isfinite(x).all()
    np.testing.assert_array_equal(x[1], np.zeros(k, np.float32))
    np.testing.assert_array_equal(
        np.delete(x, 1, axis=0),
        _port(np.delete(a, 1, axis=0), np.delete(b, 1, axis=0), layout))


_PLAIN = {"gj_aug_cta": "gj_solve_cta_plain",
          "gj_aug_split": "gj_solve_cta_plain",
          "gj_aug": "gj_solve_plain",
          "gj_packed_cta": "gj_solve_cta_plain",
          "gj_packed_split": "gj_solve_cta_plain",
          "gj_packed": "gj_solve_packed_plain"}


@pytest.mark.parametrize("k,suffix", [(128, "_cta"), (129, "_split"),
                                      (256, "_split"), (257, "")])
@pytest.mark.parametrize("layout", ["aug", "packed"])
def test_layouts_route_by_rank_above_128(layout, k, suffix, monkeypatch):
    """The split kernels take 129 ≤ K ≤ 256; the old kernels keep K > 256,
    which `gj_applicable` refuses, so no train reaches them. On the CPU
    `gj_solve` runs the named kernel's plain version, once."""
    kernel = f"gj_{layout}{suffix}"
    route = spd_solve.aug_kernel if layout == "aug" else \
        spd_solve.packed_kernel
    assert route(k) == kernel
    assert spd_solve.gj_applicable(k) == (k <= 256)
    called = []
    for fn in set(_PLAIN.values()):
        real = getattr(spd_solve, fn)
        monkeypatch.setattr(
            spd_solve, fn,
            lambda *a, _fn=fn, _real=real, **kw: called.append(_fn)
            or _real(*a, **kw))
    a, b = _spd_batch(12_000 + k, 2, k)
    x = _port(a, b, layout)
    assert called == [_PLAIN[kernel]]
    want = a.transpose(0, 2, 1) if layout == "packed" else a
    assert _rel(x, _solve64(want, b)) < 1e-4


@pytest.mark.parametrize("k", [128, 257])
@pytest.mark.parametrize("name", ["gj_aug_split", "gj_packed_split"])
def test_split_wrappers_refuse_ranks_they_do_not_take(name, k):
    """The wrappers check the rank before the device: the split kernels
    take 129 ≤ K ≤ 256 only."""
    a = torch.eye(k).expand(2, k, k)
    with pytest.raises(ValueError, match="129 ≤ K ≤ 256"):
        spd_solve._launch(name, a, torch.ones(2, k, 1))


@pytest.mark.parametrize("layout", ["aug", "packed"])
def test_train_through_the_split_kernel_meets_reference_bar(
        layout, monkeypatch):
    """A CPU ALS train at rank 144 under a forced ``aug`` and a forced
    ``packed``, each through the split kernels' plain version, against
    the reference's chol train."""
    rank = 144
    rng = np.random.default_rng(29)
    n_u, n_i, nnz = 40, 30, 600
    ui = rng.integers(0, n_u, nnz).astype(np.int32)
    ii = rng.integers(0, n_i, nnz).astype(np.int32)
    r = rng.uniform(1, 5, nnz).astype(np.float32)
    calls = []
    real = spd_solve.gj_solve_cta_plain
    monkeypatch.setattr(spd_solve, "gj_solve_cta_plain",
                        lambda *a, **kw: calls.append(a[0].shape[1])
                        or real(*a, **kw))
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
    assert calls and set(calls) == {rank}
    np.testing.assert_allclose(got.rmse_history, want.rmse_history,
                               rtol=2e-3)

