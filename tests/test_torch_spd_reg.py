"""The register kernel's plain version (`gj_solve_reg_plain`, the
arithmetic of csrc/gj_reg.cu) and the ``aug`` layout's routing on the
CPU: against numpy and the reference's `_build_solver_aug` in interpret
mode (max-rel < 1e-4), against the shared-memory kernel's plain version
(rel < 1e-6: padding to KP, the reciprocal and skipping the columns left
of the pivot change nothing beyond rounding), and through a rank-64 ALS
train held to the reference's RMSE bar (rtol 2e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as ref_als
from predictionio_tpu.ops import pallas_solve as ref
from predictionio_tpu.parallel.mesh import make_mesh
from predictionio_torch.ops import _build, als, spd_solve

# one intra-op thread: these tests use small tensors, and the suite's
# parallel workers share the machine's cores with timing-sensitive tests
torch.set_num_threads(1)

RANKS = [1, 2, 8, 10, 16, 31, 32, 33, 63, 64]
# not a multiple of the kernel's systems per block (8 at K ≤ 16, else 4)
R = 13


def _spd_batch(seed, r, k):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(r, k, k)).astype(np.float32)
    a = y @ y.transpose(0, 2, 1) + 0.5 * k * np.eye(k, dtype=np.float32)
    b = rng.normal(size=(r, k)).astype(np.float32)
    return a, b


def _rel(x, want):
    return np.abs(x - want).max() / np.abs(want).max()


def _reg(a, b):
    return spd_solve.gj_solve_reg_plain(torch.from_numpy(a),
                                        torch.from_numpy(b)).numpy()


@pytest.fixture(autouse=True)
def _no_launches():
    """Every solve here is on CPU tensors: no kernel may launch."""
    spd_solve.reset_launches()
    yield
    assert not any(spd_solve.launches.values()), spd_solve.launches


@pytest.mark.parametrize("k", RANKS)
def test_reg_plain_matches_numpy_and_reference(k):
    a, b = _spd_batch(k, R, k)
    x = _reg(a, b)
    assert x.shape == (R, k)
    want = np.linalg.solve(a.astype(np.float64),
                           b.astype(np.float64)[..., None])[..., 0]
    assert _rel(x, want) < 1e-4
    x_ref = np.asarray(ref.gj_solve(jnp.asarray(a), jnp.asarray(b),
                                    interpret=True, layout="aug"))
    assert _rel(x, x_ref) < 1e-4


@pytest.mark.parametrize("k", RANKS)
def test_reg_plain_matches_shared_memory_plain(k):
    a, b = _spd_batch(100 + k, R, k)
    x_shared = spd_solve.gj_solve_plain(torch.from_numpy(a),
                                        torch.from_numpy(b)).numpy()
    assert _rel(_reg(a, b), x_shared) < 1e-6


@pytest.mark.parametrize("k", [1, 10, 16, 33, 64])
def test_reg_plain_all_zero_system_is_exactly_zero(k):
    a, b = _spd_batch(200 + k, 5, k)
    a[2] = 0.0
    b[2] = 0.0
    x = _reg(a, b)
    assert np.isfinite(x).all()
    np.testing.assert_array_equal(x[2], np.zeros(k, np.float32))
    x_gj = spd_solve.gj_solve(torch.from_numpy(a), torch.from_numpy(b),
                              layout="aug").numpy()
    np.testing.assert_array_equal(x_gj, x)


@pytest.mark.parametrize("k,kernel", [
    (1, "gj_aug_reg"), (8, "gj_aug_reg"), (16, "gj_aug_reg"),
    (17, "gj_aug_reg"), (33, "gj_aug_reg"), (64, "gj_aug_reg"),
    (65, "gj_aug_cta"), (80, "gj_aug_cta"), (255, "gj_aug_split")])
def test_aug_routes_by_rank(k, kernel, monkeypatch):
    """`aug_kernel` names the kernel; on the CPU `gj_solve` runs that
    kernel's plain version."""
    assert spd_solve.aug_kernel(k) == kernel
    plain = {"gj_aug_reg": "gj_solve_reg_plain",
             "gj_aug_cta": "gj_solve_cta_plain",
             "gj_aug_split": "gj_solve_cta_plain",
             "gj_aug": "gj_solve_plain"}
    called = []
    for fn in set(plain.values()):
        real = getattr(spd_solve, fn)
        monkeypatch.setattr(
            spd_solve, fn,
            lambda *a, _fn=fn, _real=real, **kw: called.append(_fn)
            or _real(*a, **kw))
    a, b = _spd_batch(300 + k, 2, k)
    x = spd_solve.gj_solve(torch.from_numpy(a), torch.from_numpy(b),
                           layout="aug").numpy()
    assert called == [plain[kernel]]
    assert _rel(x, np.linalg.solve(a, b[..., None])[..., 0]) < 1e-4


@pytest.mark.parametrize("k,kp", [(1, 16), (16, 16), (17, 32), (32, 32),
                                  (33, 64), (64, 64)])
def test_padded_rank(k, kp):
    assert spd_solve.reg_padded_rank(k) == kp


@pytest.mark.parametrize("k", [0, 65])
def test_reg_refuses_ranks_out_of_range(k):
    with pytest.raises(ValueError, match="K ≤ 64"):
        spd_solve.reg_padded_rank(k)


def test_rank64_train_through_aug_meets_reference_bar(monkeypatch):
    """A CPU ALS train at rank 64 through the ``aug`` layout (the register
    kernel's plain version) against the reference's chol train."""
    rng = np.random.default_rng(17)
    n_u, n_i, nnz = 40, 30, 600
    ui = rng.integers(0, n_u, nnz).astype(np.int32)
    ii = rng.integers(0, n_i, nnz).astype(np.int32)
    r = rng.uniform(1, 5, nnz).astype(np.float32)
    calls = []
    real = spd_solve.gj_solve_reg_plain
    monkeypatch.setattr(spd_solve, "gj_solve_reg_plain",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv("PIO_GJ_LAYOUT", "aug")
    cfg = ref_als.ALSConfig(rank=64, iterations=3, reg=0.05, seed=0,
                            solver="chol", pallas="off")
    mesh = make_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1])
    want = ref_als.als_train(ui, ii, r, n_u, n_i, cfg, mesh=mesh,
                             compute_rmse=True)
    init = np.asarray(jax.random.normal(jax.random.key(0), (n_i, 64),
                                        dtype=jnp.float32) / np.sqrt(64))
    got = als.als_train(ui, ii, r, n_u, n_i,
                        als.ALSConfig(rank=64, iterations=3, reg=0.05,
                                      seed=0, solver="gj"),
                        device="cpu", compute_rmse=True,
                        init_item_factors=init)
    assert calls
    np.testing.assert_allclose(got.rmse_history, want.rmse_history,
                               rtol=2e-3)


_PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z13gj_reg_kernelILi64EEv' for 'sm_90a'
ptxas info    : Function properties for _Z13gj_reg_kernelILi64EEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, 33280 bytes smem, 432 bytes cmem[0]
ptxas info    : Compiling entry function '_Z13gj_reg_kernelILi16EEv' for 'sm_90a'
ptxas info    : Function properties for _Z13gj_reg_kernelILi16EEv
    264 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, 8704 bytes smem, 432 bytes cmem[0]
"""


def test_ptxas_report_parses_per_kernel():
    """chip_smoke.py's build phase reads the register kernel's stack frame
    and spills from nvcc's -Xptxas -v report through this parser."""
    assert _build.ptxas_kernels(_PTXAS) == {
        "_Z13gj_reg_kernelILi64EEv": {"stack": 0, "spill_stores": 0,
                                      "spill_loads": 0, "registers": 168},
        "_Z13gj_reg_kernelILi16EEv": {"stack": 264, "spill_stores": 8,
                                      "spill_loads": 12, "registers": 255},
    }
    assert _build.ptxas_kernels("") == {}
