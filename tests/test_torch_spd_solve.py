"""The port's batched SPD solve (predictionio_torch/ops/spd_solve.py) on
the CPU — the kernels' plain versions — against the reference's Pallas
kernels in interpret mode and against numpy, at the reference's bars
(max-rel < 1e-4; exact zeros for all-zero padding systems)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import pallas_solve as ref
from predictionio_torch.ops import spd_solve

# one intra-op thread: these tests use small tensors, and the suite's
# parallel workers share the machine's cores with timing-sensitive tests
torch.set_num_threads(1)


def _spd_batch(rng, r, k, reg=None):
    y = rng.normal(size=(r, k, k)).astype(np.float32)
    a = y @ y.transpose(0, 2, 1)
    a += (reg if reg is not None else 0.5 * k) * np.eye(k, dtype=np.float32)
    b = rng.normal(size=(r, k)).astype(np.float32)
    return a, b


def _rel(x, want):
    return np.abs(x - want).max() / np.abs(want).max()


def _port(fn, *arrays, **kw):
    return fn(*(torch.from_numpy(a) for a in arrays), **kw).numpy()


@pytest.fixture(autouse=True)
def _no_launches():
    """Every solve here is on CPU tensors: no kernel may launch."""
    spd_solve.reset_launches()
    yield
    assert not any(spd_solve.launches.values()), spd_solve.launches


@pytest.mark.parametrize("r,k", [(5, 10), (130, 64), (300, 8), (9, 128)])
def test_gj_solve_matches_numpy_and_reference(r, k):
    rng = np.random.default_rng(0)
    a, b = _spd_batch(rng, r, k)
    x = _port(spd_solve.gj_solve, a, b)
    want = np.linalg.solve(a, b[..., None])[..., 0]
    assert _rel(x, want) < 1e-4
    x_ref = np.asarray(ref.gj_solve(jnp.asarray(a), jnp.asarray(b),
                                    interpret=True))
    assert _rel(x, x_ref) < 1e-4


@pytest.mark.parametrize("layout", ["aug", "schur", "packed", "blocked2"])
@pytest.mark.parametrize("r,k", [(33, 64), (9, 128), (7, 100)])
def test_forced_layouts_match_reference(layout, r, k):
    rng = np.random.default_rng(4)
    a, b = _spd_batch(rng, r, k)
    x = _port(spd_solve.gj_solve, a, b, layout=layout)
    x_ref = np.asarray(ref.gj_solve(jnp.asarray(a), jnp.asarray(b),
                                    interpret=True, layout=layout))
    assert _rel(x, x_ref) < 1e-4
    assert _rel(x, np.linalg.solve(a, b[..., None])[..., 0]) < 1e-4


@pytest.mark.parametrize("r,k,m", [(9, 16, 5), (33, 32, 33), (7, 64, 1),
                                   (5, 8, 120), (4, 32, 97)])
def test_gj_solve_multi_matches_numpy_and_reference(r, k, m):
    rng = np.random.default_rng(6)
    a, _ = _spd_batch(rng, r, k)
    b = rng.normal(size=(r, k, m)).astype(np.float32)
    x = _port(spd_solve.gj_solve_multi, a, b)
    assert x.shape == (r, k, m)
    assert _rel(x, np.linalg.solve(a, b)) < 1e-4
    x_ref = np.asarray(ref.gj_solve_multi(jnp.asarray(a), jnp.asarray(b),
                                          interpret=True))
    assert _rel(x, x_ref) < 1e-4


@pytest.mark.parametrize("r,k", [(17, 64), (5, 128), (9, 96), (3, 200),
                                 (21, 48), (3, 255)])
def test_schur_matches_numpy(r, k):
    """Odd split sizes (and odd K: 255) go straight to the base solve."""
    rng = np.random.default_rng(7)
    a, b = _spd_batch(rng, r, k)
    x = _port(spd_solve.schur_solve, a, b)
    assert _rel(x, np.linalg.solve(a, b[..., None])[..., 0]) < 1e-4


def test_schur_matches_reference_interpret():
    rng = np.random.default_rng(11)
    a, b = _spd_batch(rng, 5, 128)
    x = _port(spd_solve.schur_solve, a, b)
    x_ref = np.asarray(ref.schur_solve(jnp.asarray(a), jnp.asarray(b),
                                       interpret=True))
    assert _rel(x, x_ref) < 1e-4


def test_schur_zero_padding_systems():
    rng = np.random.default_rng(8)
    a, b = _spd_batch(rng, 6, 64)
    a[2] = 0.0
    b[2] = 0.0
    x = _port(spd_solve.schur_solve, a, b)
    assert np.isfinite(x).all()
    np.testing.assert_array_equal(x[2], np.zeros(64, np.float32))


@pytest.mark.parametrize("k", [16, 128])
def test_all_zero_system_solves_to_zero(k):
    rng = np.random.default_rng(1)
    a, b = _spd_batch(rng, 4, k)
    a[2] = 0.0
    b[2] = 0.0
    x = _port(spd_solve.gj_solve, a, b)
    assert np.isfinite(x).all()
    np.testing.assert_array_equal(x[2], np.zeros(k, np.float32))


def test_plain_versions_repeat_the_reference_elimination():
    """The plain versions run the kernel's arithmetic: against the
    reference's interpret-mode kernels at the same bar."""
    rng = np.random.default_rng(12)
    a, b = _spd_batch(rng, 9, 24)
    bm = rng.normal(size=(9, 24, 7)).astype(np.float32)
    x = _port(spd_solve.gj_solve_plain, a, b)
    xm = _port(spd_solve.gj_solve_multi_plain, a, bm)
    x_ref = np.asarray(ref.gj_solve(jnp.asarray(a), jnp.asarray(b),
                                    interpret=True, layout="aug"))
    xm_ref = np.asarray(ref.gj_solve_multi(jnp.asarray(a), jnp.asarray(bm),
                                           interpret=True))
    assert _rel(x, x_ref) < 1e-4
    assert _rel(xm, xm_ref) < 1e-4


def test_auto_routes_large_ranks_to_schur(monkeypatch):
    called = []
    real = spd_solve.schur_solve
    monkeypatch.setattr(spd_solve, "schur_solve",
                        lambda *a, **k: called.append(1) or real(*a, **k))
    rng = np.random.default_rng(9)
    a, b = _spd_batch(rng, 3, 96)
    _port(spd_solve.gj_solve, a, b)
    assert called
    called.clear()
    a, b = _spd_batch(rng, 3, 64)
    _port(spd_solve.gj_solve, a, b)
    assert not called  # rank 64 stays on the aug elimination


def test_env_layout_applies_when_not_given(monkeypatch):
    called = []
    real = spd_solve.schur_solve
    monkeypatch.setattr(spd_solve, "schur_solve",
                        lambda *a, **k: called.append(1) or real(*a, **k))
    monkeypatch.setenv("PIO_GJ_LAYOUT", "schur")
    rng = np.random.default_rng(10)
    a, b = _spd_batch(rng, 3, 16)
    _port(spd_solve.gj_solve, a, b)
    assert called


def test_packed_groups_pack_small_ranks():
    """The reference packs ⌊128/K⌋ systems of a small rank into one block
    (4 at K = 16, so 21 systems leave its last block short); the port runs
    each system on its own (half-)warp. The systems come back in their own
    order, and each solved alone equals it solved in the batch."""
    assert [ref._groups(k) for k in (10, 16, 32, 33, 64, 65, 128, 255)] == \
        [4, 4, 4, 3, 2, 1, 1, 1]
    rng = np.random.default_rng(5)
    a, b = _spd_batch(rng, 21, 16)
    x = _port(spd_solve.gj_solve, a, b, layout="packed")
    assert _rel(x, np.linalg.solve(a, b[..., None])[..., 0]) < 1e-4
    x_ref = np.asarray(ref.gj_solve(jnp.asarray(a), jnp.asarray(b),
                                    interpret=True, layout="packed"))
    assert _rel(x, x_ref) < 1e-4
    for row in (0, 19, 20):
        alone = _port(spd_solve.gj_solve, a[row:row + 1], b[row:row + 1],
                      layout="packed")
        np.testing.assert_array_equal(alone[0], x[row])


@pytest.mark.parametrize("layout", ["packed", "blocked2"])
@pytest.mark.parametrize("k", [16, 64])
def test_forced_layouts_keep_zero_systems_exact(layout, k):
    rng = np.random.default_rng(13)
    a, b = _spd_batch(rng, 5, k)
    a[3] = 0.0
    b[3] = 0.0
    x = _port(spd_solve.gj_solve, a, b, layout=layout)
    assert np.isfinite(x).all()
    np.testing.assert_array_equal(x[3], np.zeros(k, np.float32))
    assert _rel(np.delete(x, 3, 0), np.linalg.solve(
        np.delete(a, 3, 0), np.delete(b, 3, 0)[..., None])[..., 0]) < 1e-4


def test_blocked2_refuses_odd_rank(monkeypatch):
    rng = np.random.default_rng(2)
    a, b = _spd_batch(rng, 3, 15)
    with pytest.raises(ValueError, match="needs even rank, got 15"):
        _port(spd_solve.gj_solve, a, b, layout="blocked2")
    with pytest.raises(ValueError, match="needs even rank"):
        _port(spd_solve.gj_solve_blocked2_plain, a, b)
    monkeypatch.setenv("PIO_GJ_LAYOUT", "blocked2")
    with pytest.raises(ValueError, match="needs even rank"):
        _port(spd_solve.gj_solve, a, b)
    # the reference refuses the same rank with the same message
    with pytest.raises(ValueError, match="needs even rank, got 15"):
        ref.gj_solve(jnp.asarray(a), jnp.asarray(b), interpret=True,
                     layout="blocked2")


@pytest.mark.parametrize("layout", ["packed", "blocked2"])
def test_env_selects_forced_layouts(layout, monkeypatch):
    called = []
    # packed and blocked2 at K ≤ 64 run gj_packed_reg's and
    # gj_blocked2_reg's plain versions
    plain = {"packed": "gj_solve_packed_reg_plain",
             "blocked2": "gj_solve_pair_plain"}[layout]
    real = getattr(spd_solve, plain)
    monkeypatch.setattr(spd_solve, plain,
                        lambda *a, **k: called.append(1) or real(*a, **k))
    monkeypatch.setenv("PIO_GJ_LAYOUT", layout)
    rng = np.random.default_rng(10)
    a, b = _spd_batch(rng, 3, 16)
    x = _port(spd_solve.gj_solve, a, b)
    assert called
    assert _rel(x, np.linalg.solve(a, b[..., None])[..., 0]) < 1e-4


def test_layout_plain_versions_repeat_the_reference_elimination():
    """On an A that is not symmetric the layouts part ways, and each plain
    version follows its own TPU kernel: packed reads A's columns (so it
    solves Aᵀx = b), blocked2 eliminates rows (it solves Ax = b)."""
    rng = np.random.default_rng(14)
    a, b = _spd_batch(rng, 6, 12)
    a += 0.5 * rng.normal(size=a.shape).astype(np.float32)
    x_ref = {lay: np.asarray(ref.gj_solve(jnp.asarray(a), jnp.asarray(b),
                                          interpret=True, layout=lay))
             for lay in ("packed", "blocked2")}
    xp = _port(spd_solve.gj_solve_packed_plain, a, b)
    xb = _port(spd_solve.gj_solve_blocked2_plain, a, b)
    # the pair kernels' plain version, which the blocked2 layout runs
    x2 = _port(spd_solve.gj_solve_pair_plain, a, b)
    assert _rel(xp, x_ref["packed"]) < 1e-4
    assert _rel(xb, x_ref["blocked2"]) < 1e-4
    assert _rel(x2, x_ref["blocked2"]) < 1e-4
    at = a.transpose(0, 2, 1)
    assert _rel(xp, np.linalg.solve(at, b[..., None])[..., 0]) < 1e-4
    assert _rel(xb, np.linalg.solve(a, b[..., None])[..., 0]) < 1e-4
    assert _rel(x2, np.linalg.solve(a, b[..., None])[..., 0]) < 1e-4
    assert _rel(xp, xb) > 1e-2  # not the same elimination


def test_unknown_layout_raises():
    rng = np.random.default_rng(2)
    a, b = _spd_batch(rng, 3, 16)
    with pytest.raises(ValueError, match="unknown"):
        _port(spd_solve.gj_solve, a, b, layout="bogus")


def test_applicable_ranks_match_reference():
    for rank in (10, 64, 128, 256, 257, 512):
        assert spd_solve.gj_applicable(rank) == ref.gj_applicable(rank)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The launch path takes CUDA tensors only; CPU tensors never reach
    it through the public functions."""
    a = torch.eye(4).expand(2, 4, 4).contiguous()
    b = torch.ones(2, 4, 1)
    with pytest.raises(ValueError, match="CUDA"):
        spd_solve._launch("gj_aug_multi", a, b)
