"""The Schur base above K = 32 on the CPU: the multi-RHS block kernel's
plain version (`gj_solve_cta_plain` with b [R, K, M], the arithmetic of
csrc/gj_cta.cu's `gj_aug_multi_cta`) against numpy in float64 and the
reference's `_build_solver_aug_multi` in interpret mode (max-rel < 1e-4),
all-zero systems solved to exactly 0, the port's `schur_solve` and
`gj_solve` under `auto` against the reference's at ranks whose base calls
lie above K = 32 (max-rel < 1e-4, the bar of tests/test_pallas_solve.py),
and `multi_kernel`'s routing at every rank `auto` sends to Schur."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import pallas_solve as ref
from predictionio_torch.ops import spd_solve

# one intra-op thread: these tests use small tensors, and the suite's
# parallel workers share the machine's cores with timing-sensitive tests
torch.set_num_threads(1)

R = 3
# the route's shapes: rank 200 → 100 → 50 → [25, ...] stays at K ≤ 32, but
# rank 132 → 66 → [33, 34], rank 196 → [49, 50], rank 150 → [75, 76],
# rank 250 → [125, 126], and a wider M than any route (33, 100: rank 132's)
SHAPES = [(33, 100), (49, 50), (75, 76), (125, 126)]
# ranks whose Schur base lies above K = 32: 98 → [49, 50] + [49, 1],
# 99 → [99, 1], 150 → [75, 76] + [75, 1], 250 → [125, 126] + [125, 1]
SCHUR_RANKS = [98, 99, 150, 250]


def _spd_batch(seed, r, k, m):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(r, k, k)).astype(np.float32)
    a = y @ y.transpose(0, 2, 1) + 0.5 * k * np.eye(k, dtype=np.float32)
    b = rng.normal(size=(r, k, m)).astype(np.float32)
    return a, b


def _rel(x, want):
    return np.abs(x - want).max() / np.abs(want).max()


def _multi_cta(a, b):
    return spd_solve.gj_solve_cta_plain(torch.from_numpy(a),
                                        torch.from_numpy(b)).numpy()


def _schur_calls(k, m=1, base=32):
    """The (K, M) of every base call `_schur_rec` makes for a [R, k, k]
    system with m right-hand sides, in order."""
    if k <= base or k % 2:
        return [(k, m)]
    h = k // 2
    return _schur_calls(h, h + m, base) + _schur_calls(h, m, base)


@pytest.fixture(autouse=True)
def _no_launches():
    """Every solve here is on CPU tensors: no kernel may launch."""
    spd_solve.reset_launches()
    yield
    assert not any(spd_solve.launches.values()), spd_solve.launches


@pytest.mark.parametrize("k,m", SHAPES)
def test_multi_cta_plain_matches_numpy_and_reference(k, m):
    a, b = _spd_batch(k * 1000 + m, R, k, m)
    x = _multi_cta(a, b)
    assert x.shape == (R, k, m)
    want = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    assert _rel(x, want) < 1e-4
    x_ref = np.asarray(ref.gj_solve_multi(jnp.asarray(a), jnp.asarray(b),
                                          interpret=True))
    assert _rel(x, x_ref) < 1e-4


@pytest.mark.parametrize("k,m", SHAPES)
def test_multi_cta_plain_columns_are_independent(k, m):
    """Each column of X is the one-RHS block plain version's x on that
    column of B, bitwise: what lets the kernel split B into chunks that
    each repeat A's elimination."""
    a, b = _spd_batch(k + m, 2, k, m)
    x = _multi_cta(a, b)
    for j in (0, m // 2, m - 1):
        one = spd_solve.gj_solve_cta_plain(torch.from_numpy(a),
                                           torch.from_numpy(b[:, :, j]))
        np.testing.assert_array_equal(x[:, :, j], one.numpy())


@pytest.mark.parametrize("k,m", [(33, 100), (125, 126)])
def test_multi_cta_plain_all_zero_system_is_exactly_zero(k, m):
    a, b = _spd_batch(200 + k + m, 4, k, m)
    a[2] = 0.0
    b[2] = 0.0
    x = _multi_cta(a, b)
    assert np.isfinite(x).all()
    np.testing.assert_array_equal(x[2], np.zeros((k, m), np.float32))
    x_multi = spd_solve.gj_solve_multi(torch.from_numpy(a),
                                       torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(x_multi, x)


@functools.lru_cache(maxsize=None)
def _schur_case(rank):
    """(a, b, the reference's schur_solve in interpret mode) at `rank`."""
    a, b = _spd_batch(rank, R, rank, 1)
    a[1] = 0.0  # an all-zero padding system
    b[1] = 0.0
    b = b[..., 0]
    x_ref = np.asarray(ref.schur_solve(jnp.asarray(a), jnp.asarray(b),
                                       interpret=True))
    return a, b, x_ref


def _check_schur(rank, x):
    a, b, x_ref = _schur_case(rank)
    live = [0, 2]
    want = np.linalg.solve(a[live].astype(np.float64),
                           b[live].astype(np.float64)[..., None])[..., 0]
    assert _rel(x[live], want) < 1e-4
    assert _rel(x, x_ref) < 1e-4
    np.testing.assert_array_equal(x[1], np.zeros(rank, np.float32))


@pytest.mark.parametrize("rank", SCHUR_RANKS)
def test_schur_matches_reference_above_32(rank):
    a, b, _ = _schur_case(rank)
    x = spd_solve.schur_solve(torch.from_numpy(a), torch.from_numpy(b))
    _check_schur(rank, x.numpy())


@pytest.mark.parametrize("rank", SCHUR_RANKS)
def test_gj_solve_auto_matches_reference_above_32(rank, monkeypatch):
    """`auto` at these ranks is Schur, whose base calls run the plain
    versions of the kernels `multi_kernel` names: the multi-RHS block
    kernel's for M > 1 and the aug kernels' for M = 1."""
    monkeypatch.delenv("PIO_GJ_LAYOUT", raising=False)
    called = []
    real = spd_solve.gj_solve_multi
    monkeypatch.setattr(
        spd_solve, "gj_solve_multi",
        lambda a, b: called.append(spd_solve.multi_kernel(
            a.shape[1], b.shape[2])) or real(a, b))
    a, b, _ = _schur_case(rank)
    x = spd_solve.gj_solve(torch.from_numpy(a), torch.from_numpy(b))
    _check_schur(rank, x.numpy())
    want = [spd_solve.multi_kernel(k, m) for k, m in _schur_calls(rank)]
    assert called == want
    assert "gj_aug_multi" not in called
    assert ("gj_aug_multi_cta" in called) == (rank % 2 == 0)


def test_no_rank_from_96_to_256_names_the_old_base():
    """Under `auto` every rank from 96 to 256 goes to Schur; none of its
    base calls names gj_aug_multi. 136 of the 161 ranks have base calls
    above K = 32: one at the full odd rank, and at ranks 2·odd and 4·odd
    calls with M > 1 on the multi-RHS block kernel."""
    above, multi = set(), set()
    for rank in range(96, 257):
        calls = _schur_calls(rank)
        names = [spd_solve.multi_kernel(k, m) for k, m in calls]
        assert "gj_aug_multi" not in names, (rank, calls)
        for (k, m), name in zip(calls, names):
            if k > 32:
                above.add(rank)
                assert name == (spd_solve.aug_kernel(k) if m == 1
                                else "gj_aug_multi_cta"), (rank, k, m)
                if m > 1:
                    multi.add((k, m))
            else:
                assert name == "gj_aug_multi_reg"
    assert len(above) == 136
    assert sorted(set(range(96, 257)) - above) == (
        list(range(96, 129, 4)) + list(range(136, 257, 8)))
    assert {k for k, _ in multi} == set(range(33, 128, 2))
    assert max(m for _, m in multi) == 190
