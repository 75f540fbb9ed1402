"""The port's CUDA kernels and device paths on the card. Every test here
needs a CUDA device (marker `cuda`) and skips without one.

This file imports neither JAX nor the reference package, so it also runs
where JAX is not installed (tests/conftest.py imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from predictionio_torch.ops import (
    als,
    basket,
    classify,
    ranking,
    session,
    spd_solve,
    text,
)
from predictionio_torch.templates.sessionrec import engine as sessionrec

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spd_solve.reset_launches()
    yield torch.device("cuda")
    spd_solve.reset_launches()


def _spd(gen, r, k, m, device):
    y = torch.randn(r, k, k, generator=gen, device=device)
    a = y @ y.transpose(1, 2) + 0.5 * k * torch.eye(k, device=device)
    b = torch.randn(r, k, m, generator=gen, device=device)
    a[1] = 0.0
    b[1] = 0.0
    return a, b


def _rel(x, want):
    return ((x - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("r,k,m", [(300, 64, 1), (37, 10, 1), (64, 32, 97),
                                   (9, 128, 1), (8, 255, 1), (5, 250, 3)])
def test_kernel_matches_plain(dev, r, k, m):
    gen = torch.Generator(device=dev).manual_seed(r * k + m)
    a, b = _spd(gen, r, k, m, dev)
    x = spd_solve.gj_solve_multi(a, b)
    want = spd_solve.gj_solve_multi_plain(a, b)
    assert _rel(x, want) < 1e-4
    assert bool((x[1] == 0).all())
    # K ≤ 32 (37, 10, 1), (64, 32, 97) run the multi-RHS register kernel,
    # K > 32 with M = 1 the aug kernel of K, and (5, 250, 3) the
    # shared/device-memory one
    assert spd_solve.launches[spd_solve.multi_kernel(k, m)] == 1
    assert sum(spd_solve.launches.values()) == 1
    spd_solve.reset_launches()
    x1 = spd_solve.gj_solve(a, b[..., 0], layout="aug")
    assert _rel(x1, spd_solve.gj_solve_plain(a, b[..., 0])) < 1e-4
    assert spd_solve.launches[spd_solve.aug_kernel(k)] == 1


_REG_RANKS = [1, 2, 8, 10, 16, 31, 32, 33, 63, 64]


@pytest.mark.parametrize("k", _REG_RANKS)
def test_reg_kernel_matches_plain(dev, k):
    """The register kernel against its plain version; 301 systems leave
    the last block short at every KP."""
    gen = torch.Generator(device=dev).manual_seed(k)
    a, b = _spd(gen, 301, k, 1, dev)
    x = spd_solve.gj_solve(a, b[..., 0], layout="aug")
    assert _rel(x, spd_solve.gj_solve_reg_plain(a, b[..., 0])) < 1e-4
    assert _rel(x, spd_solve.gj_solve_plain(a, b[..., 0])) < 1e-4
    assert bool((x[1] == 0).all())
    assert spd_solve.launches["gj_aug_reg"] == 1
    assert sum(spd_solve.launches.values()) == 1


@pytest.mark.parametrize("r", [0, 1, 2])
@pytest.mark.parametrize("k", [10, 32, 64])
def test_reg_kernel_takes_few_systems(dev, r, k):
    gen = torch.Generator(device=dev).manual_seed(r + k)
    a, b = _spd(gen, 2, k, 1, dev)
    a, b = a[2 - r:].contiguous(), b[2 - r:, :, 0].contiguous()
    x = spd_solve.gj_solve(a, b, layout="aug")
    assert x.shape == (r, k)
    if r:
        torch.testing.assert_close(x, spd_solve.gj_solve_reg_plain(a, b),
                                   rtol=1e-4, atol=1e-6)
    if r == 1:  # the all-zero system alone
        assert bool((x == 0).all())


@pytest.mark.parametrize("k", [16, 48, 64])
def test_reg_kernel_takes_strided_inputs(dev, k):
    """Views that are not contiguous take the strided load: a transposed
    A, a sub-block of a larger one, b as a column of a wider array."""
    gen = torch.Generator(device=dev).manual_seed(k)
    a, b = _spd(gen, 45, k + 8, 3, dev)
    for sub_a in (a[:, :k, :k], a[:, :k, :k].transpose(1, 2),
                  a[:, 8:, 8:]):
        sub_b = b[:, 8:, 1]
        assert not sub_a.is_contiguous() and not sub_b.is_contiguous()
        x = spd_solve.gj_solve(sub_a, sub_b, layout="aug")
        assert _rel(x, spd_solve.gj_solve_reg_plain(sub_a, sub_b)) < 1e-4
        assert bool((x[1] == 0).all())
    assert spd_solve.launches["gj_aug_reg"] == 3


@pytest.mark.parametrize("k,kernel", [(64, "gj_aug_reg"),
                                      (65, "gj_aug_cta"),
                                      (80, "gj_aug_cta")])
def test_aug_launches_the_routed_kernel(dev, k, kernel):
    gen = torch.Generator(device=dev).manual_seed(k)
    a, b = _spd(gen, 50, k, 1, dev)
    x = spd_solve.gj_solve(a, b[..., 0], layout="aug")
    assert _rel(x, spd_solve.gj_solve_plain(a, b[..., 0])) < 1e-4
    assert spd_solve.launches[kernel] == 1
    assert sum(spd_solve.launches.values()) == 1


_LAYOUT_PLAIN = {"packed": spd_solve.gj_solve_packed_plain,
                 "blocked2": spd_solve.gj_solve_pair_plain}


@pytest.mark.parametrize("layout,r,k", [
    ("packed", 300, 64), ("packed", 37, 10), ("packed", 21, 16),
    ("packed", 9, 128), ("packed", 8, 255), ("blocked2", 300, 64),
    ("blocked2", 37, 10), ("blocked2", 9, 128), ("blocked2", 6, 256)])
def test_layout_kernels_match_plain(dev, layout, r, k):
    """packed (K ≤ 64 and K ≤ 128 on the register kernels, K = 255 on
    the split block kernel) against the plain version of the layout's
    elimination, and blocked2 (K ≤ 64 on the warp kernel, 128 on the
    block kernel, 256 on the split one) against the pair kernels' plain
    version."""
    gen = torch.Generator(device=dev).manual_seed(r * k)
    a, b = _spd(gen, r, k, 1, dev)
    x = spd_solve.gj_solve(a, b[..., 0], layout=layout)
    want = _LAYOUT_PLAIN[layout](a, b[..., 0])
    assert _rel(x, want) < 1e-4
    assert bool((x[1] == 0).all())
    kernel = (spd_solve.packed_kernel(k) if layout == "packed"
              else spd_solve.blocked2_kernel(k))
    assert spd_solve.launches[kernel] == 1
    assert sum(spd_solve.launches.values()) == 1


@pytest.mark.parametrize("layout", ["packed", "blocked2"])
def test_layout_kernels_take_strided_inputs(dev, layout):
    gen = torch.Generator(device=dev).manual_seed(2)
    a, b = _spd(gen, 40, 64, 3, dev)
    sub_a, sub_b = a[:, :32, :32], b[:, :32, 1]
    assert not sub_a.is_contiguous() and not sub_b.is_contiguous()
    x = spd_solve.gj_solve(sub_a, sub_b, layout=layout)
    assert _rel(x, _LAYOUT_PLAIN[layout](sub_a, sub_b)) < 1e-4


# the kernels that took the packed layout at K ≤ 128 and the aug layout at
# 64 < K ≤ 128, each with its layout and its plain version
_NEW_PLAIN = {
    "gj_packed_reg": ("packed", spd_solve.gj_solve_packed_reg_plain),
    "gj_aug_cta": ("aug", spd_solve.gj_solve_cta_plain),
    "gj_packed_cta": ("packed", lambda a, b: spd_solve.gj_solve_cta_plain(
        a, b, transpose=True)),
}
# the K boundaries: each padded size's ends and the KP = 96 / 128 switch
_NEW_CASES = ([("gj_packed_reg", k) for k in (1, 16, 17, 32, 33, 64)]
              + [(name, k) for name in ("gj_aug_cta", "gj_packed_cta")
                 for k in (65, 95, 96, 97, 127, 128)])


def _solve64(a, b, layout):
    """A float64 solve of the layout's system (packed: Aᵀx = b); an
    all-zero system becomes I x = 0."""
    a64 = a.double()
    zero = (a64 == 0).flatten(1).all(1)
    a64[zero] = torch.eye(a.shape[1], dtype=torch.float64, device=a.device)
    if layout == "packed":
        a64 = a64.transpose(1, 2)
    return torch.linalg.solve(a64, b.double()[..., None])[..., 0]


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("name,k", _NEW_CASES)
def test_new_kernels_match_plain_at_the_k_boundaries(dev, name, k, r):
    """One routed call, one launch of the kernel the layout names at K;
    R = 3 holds _spd's all-zero system."""
    layout, plain = _NEW_PLAIN[name]
    gen = torch.Generator(device=dev).manual_seed(k * 10 + r)
    a, b = _spd(gen, 3, k, 1, dev)
    a, b = a[:r], b[:r, :, 0]
    x = spd_solve.gj_solve(a, b, layout=layout)
    assert spd_solve.launches[name] == 1
    assert sum(spd_solve.launches.values()) == 1
    assert x.shape == (r, k)
    assert _rel(x, plain(a, b)) < 1e-4
    assert _rel(x.double(), _solve64(a, b, layout)) < 1e-4
    if r == 3:
        assert bool((x[1] == 0).all())


@pytest.mark.parametrize("name,k", [("gj_packed_reg", 48),
                                    ("gj_packed_reg", 64),
                                    ("gj_aug_cta", 80), ("gj_aug_cta", 128),
                                    ("gj_packed_cta", 100)])
def test_new_kernels_take_strided_inputs(dev, name, k):
    """A sub-block of a larger A, its transpose and b as a column of a
    wider array: views that are not contiguous, read uncopied."""
    layout, plain = _NEW_PLAIN[name]
    gen = torch.Generator(device=dev).manual_seed(k)
    a, b = _spd(gen, 45, k + 8, 3, dev)
    for sub_a in (a[:, :k, :k], a[:, :k, :k].transpose(1, 2),
                  a[:, 8:, 8:]):
        sub_b = b[:, 8:, 1]
        assert not sub_a.is_contiguous() and not sub_b.is_contiguous()
        x = spd_solve.gj_solve(sub_a, sub_b, layout=layout)
        assert _rel(x, plain(sub_a, sub_b)) < 1e-4
        assert bool((x[1] == 0).all())
    assert spd_solve.launches[name] == 3
    assert sum(spd_solve.launches.values()) == 3


@pytest.mark.parametrize("name,k", [("gj_packed_reg", 10),
                                    ("gj_packed_reg", 64),
                                    ("gj_aug_cta", 80), ("gj_aug_cta", 128),
                                    ("gj_packed_cta", 97)])
def test_new_kernels_system_alone_equals_in_batch(dev, name, k):
    """A system's x is bitwise the same solved alone and inside a
    batch."""
    layout, _ = _NEW_PLAIN[name]
    gen = torch.Generator(device=dev).manual_seed(k + 1)
    a, b = _spd(gen, 301, k, 1, dev)
    b = b[..., 0]
    x = spd_solve.gj_solve(a, b, layout=layout)
    for row in (0, 1, 150, 300):
        alone = spd_solve.gj_solve(a[row:row + 1].clone(),
                                   b[row:row + 1].clone(), layout=layout)
        assert torch.equal(alone[0], x[row])


@pytest.mark.parametrize("name,k", [("gj_packed_reg", 16),
                                    ("gj_packed_reg", 64),
                                    ("gj_aug_cta", 65), ("gj_aug_cta", 128),
                                    ("gj_packed_cta", 96),
                                    ("gj_packed_cta", 128)])
def test_new_kernels_all_zero_systems_are_exactly_zero(dev, name, k):
    layout, _ = _NEW_PLAIN[name]
    a = torch.zeros(7, k, k, device=dev)
    b = torch.zeros(7, k, device=dev)
    x = spd_solve.gj_solve(a, b, layout=layout)
    assert bool((x == 0).all())
    assert spd_solve.launches[name] == 1


@pytest.mark.parametrize("name,k", [("gj_aug_cta", 96), ("gj_aug_cta", 128),
                                    ("gj_packed_cta", 97)])
def test_block_kernels_repeat_bitwise_at_full_size(dev, name, k):
    """The pivot row is double-buffered under one barrier a step. With
    several blocks an SM racing through 13 850 systems, a buffer
    overwritten before every thread had read it would show as a
    difference from run to run, or from the plain version."""
    layout, plain = _NEW_PLAIN[name]
    gen = torch.Generator(device=dev).manual_seed(k + 2)
    a, b = _spd(gen, 13_850, k, 1, dev)
    b = b[..., 0]
    x = spd_solve.gj_solve(a, b, layout=layout)
    for _ in range(3):
        assert torch.equal(spd_solve.gj_solve(a, b, layout=layout), x)
    assert _rel(x, plain(a, b)) < 1e-4
    assert spd_solve.launches[name] == 4


def test_new_wrappers_refuse_what_the_kernel_does_not_take(dev):
    a = torch.eye(4, device=dev).expand(2, 4, 4)
    for name in _NEW_PLAIN:
        with pytest.raises(ValueError, match="one right-hand side"):
            spd_solve._launch(name, a, torch.ones(2, 4, 2, device=dev))
        with pytest.raises(ValueError, match="CUDA"):
            spd_solve._launch(name, a, torch.ones(2, 4, 1))
    with pytest.raises(ValueError, match="K ≤ 64"):
        big = torch.eye(65, device=dev).expand(2, 65, 65)
        spd_solve._launch("gj_packed_reg", big,
                          torch.ones(2, 65, 1, device=dev))
    for name in ("gj_aug_cta", "gj_packed_cta"):
        with pytest.raises(ValueError, match="K ≤ 128"):
            big = torch.eye(129, device=dev).expand(2, 129, 129)
            spd_solve._launch(name, big, torch.ones(2, 129, 1, device=dev))
    assert not any(spd_solve.launches.values())


# the split block kernels (128 < K ≤ 256), each with its layout and the
# block kernels' one plain version
_SPLIT_PLAIN = {
    "gj_aug_split": ("aug", spd_solve.gj_solve_cta_plain),
    "gj_packed_split": ("packed", lambda a, b: spd_solve.gj_solve_cta_plain(
        a, b, transpose=True)),
}
# L = K - 128 shared columns: 1, 2, 31, 32, 33 (quad and warp boundaries),
# 64, 96, 127 (odd: the hand-off's buffer parity), 128
_SPLIT_RANKS = (129, 130, 159, 160, 161, 192, 224, 255, 256)


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("k", _SPLIT_RANKS)
@pytest.mark.parametrize("name", list(_SPLIT_PLAIN))
def test_split_kernels_match_plain(dev, name, k, r):
    """One routed call, one launch of the split kernel; R = 3 holds _spd's
    all-zero system."""
    layout, plain = _SPLIT_PLAIN[name]
    gen = torch.Generator(device=dev).manual_seed(k * 10 + r)
    a, b = _spd(gen, 3, k, 1, dev)
    a, b = a[:r], b[:r, :, 0]
    x = spd_solve.gj_solve(a, b, layout=layout)
    assert spd_solve.launches[name] == 1
    assert sum(spd_solve.launches.values()) == 1
    assert x.shape == (r, k)
    assert torch.isfinite(x).all()
    assert _rel(x, plain(a, b)) < 1e-4
    assert _rel(x.double(), _solve64(a, b, layout)) < 1e-4
    if r == 3:
        assert bool((x[1] == 0).all())


@pytest.mark.parametrize("k", [130, 192, 256])
@pytest.mark.parametrize("name", list(_SPLIT_PLAIN))
def test_split_kernels_take_strided_inputs(dev, name, k):
    """A sub-block of a larger A, its transpose and b as a column of a
    wider array: views that are not contiguous, read uncopied."""
    layout, plain = _SPLIT_PLAIN[name]
    gen = torch.Generator(device=dev).manual_seed(k)
    a, b = _spd(gen, 9, k + 8, 3, dev)
    for sub_a in (a[:, :k, :k], a[:, :k, :k].transpose(1, 2),
                  a[:, 8:, 8:]):
        sub_b = b[:, 8:, 1]
        assert not sub_a.is_contiguous() and not sub_b.is_contiguous()
        x = spd_solve.gj_solve(sub_a, sub_b, layout=layout)
        assert _rel(x, plain(sub_a, sub_b)) < 1e-4
        assert bool((x[1] == 0).all())
    assert spd_solve.launches[name] == 3
    assert sum(spd_solve.launches.values()) == 3


@pytest.mark.parametrize("k", [160, 255])
@pytest.mark.parametrize("name", list(_SPLIT_PLAIN))
def test_split_kernels_system_alone_equals_in_batch(dev, name, k):
    """A system's x is bitwise the same solved alone and inside a
    batch."""
    layout, _ = _SPLIT_PLAIN[name]
    gen = torch.Generator(device=dev).manual_seed(k + 1)
    a, b = _spd(gen, 301, k, 1, dev)
    b = b[..., 0]
    x = spd_solve.gj_solve(a, b, layout=layout)
    for row in (0, 1, 150, 300):
        alone = spd_solve.gj_solve(a[row:row + 1].clone(),
                                   b[row:row + 1].clone(), layout=layout)
        assert torch.equal(alone[0], x[row])


@pytest.mark.parametrize("k", [129, 192, 256])
@pytest.mark.parametrize("name", list(_SPLIT_PLAIN))
def test_split_kernels_all_zero_systems_are_exactly_zero(dev, name, k):
    layout, _ = _SPLIT_PLAIN[name]
    a = torch.zeros(7, k, k, device=dev)
    b = torch.zeros(7, k, device=dev)
    x = spd_solve.gj_solve(a, b, layout=layout)
    assert bool((x == 0).all())
    assert spd_solve.launches[name] == 1


@pytest.mark.parametrize("r,k", [(13_850, 192), (1_024, 255)])
@pytest.mark.parametrize("name", list(_SPLIT_PLAIN))
def test_split_kernels_repeat_bitwise_at_full_size(dev, name, r, k):
    """One barrier a step, the pivot row read in place from shared
    memory, and the buffers' parity carried across the hand-off from the
    shared steps to the register steps (K = 255: L = 127 is odd). A buffer
    or a row overwritten before every thread had read it would show as a
    difference from run to run, or from the plain version."""
    layout, plain = _SPLIT_PLAIN[name]
    gen = torch.Generator(device=dev).manual_seed(k + 3)
    a, b = _spd(gen, r, k, 1, dev)
    b = b[..., 0]
    x = spd_solve.gj_solve(a, b, layout=layout)
    for _ in range(3):
        assert torch.equal(spd_solve.gj_solve(a, b, layout=layout), x)
    assert _rel(x, plain(a, b)) < 1e-4
    assert spd_solve.launches[name] == 4


def test_split_wrappers_refuse_what_the_kernel_does_not_take(dev):
    for name in _SPLIT_PLAIN:
        for k in (128, 257):
            big = torch.eye(k, device=dev).expand(2, k, k)
            with pytest.raises(ValueError, match="129 ≤ K ≤ 256"):
                spd_solve._launch(name, big, torch.ones(2, k, 1, device=dev))
        a = torch.eye(192, device=dev).expand(2, 192, 192)
        with pytest.raises(ValueError, match="one right-hand side"):
            spd_solve._launch(name, a, torch.ones(2, 192, 2, device=dev))
        with pytest.raises(ValueError, match="CUDA"):
            spd_solve._launch(name, a, torch.ones(2, 192, 1))
    assert not any(spd_solve.launches.values())


# the blocked2 layout's pair kernels (even K ≤ 256), and the ranks each
# is held at: each body's ends, the padded sizes' boundaries, the
# phase-2 ranks (8, 10, 16, 64; 80, 96, 128; 192, 256), L = K - 128 = 2
# and 128 shared columns
_PAIR_RANKS = {"gj_blocked2_reg": (2, 8, 10, 16, 18, 32, 34, 48, 64),
               "gj_blocked2_cta": (66, 80, 94, 96, 98, 126, 128),
               "gj_blocked2_split": (130, 132, 160, 192, 254, 256)}
_PAIR_CASES = [(name, k) for name, ks in _PAIR_RANKS.items() for k in ks]


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("name,k", _PAIR_CASES)
def test_pair_kernels_match_plain(dev, name, k, r):
    """One routed call, one launch of the pair kernel at K, against the
    pair kernels' plain version, the plain version of the kernel they
    replaced and a float64 solve; R = 3 holds _spd's all-zero system."""
    gen = torch.Generator(device=dev).manual_seed(k * 10 + r)
    a, b = _spd(gen, 3, k, 1, dev)
    a, b = a[:r], b[:r, :, 0]
    x = spd_solve.gj_solve(a, b, layout="blocked2")
    assert spd_solve.launches[name] == 1
    assert sum(spd_solve.launches.values()) == 1
    assert x.shape == (r, k)
    assert torch.isfinite(x).all()
    assert _rel(x, spd_solve.gj_solve_pair_plain(a, b)) < 1e-4
    assert _rel(x, spd_solve.gj_solve_blocked2_plain(a, b)) < 1e-4
    assert _rel(x.double(), _solve64(a, b, "blocked2")) < 1e-4
    if r == 3:
        assert bool((x[1] == 0).all())


@pytest.mark.parametrize("name,k", [("gj_blocked2_reg", 16),
                                    ("gj_blocked2_reg", 64),
                                    ("gj_blocked2_cta", 80),
                                    ("gj_blocked2_cta", 128),
                                    ("gj_blocked2_split", 130),
                                    ("gj_blocked2_split", 256)])
def test_pair_kernels_take_strided_inputs(dev, name, k):
    """Schur-style sub-blocks of a larger A, a transposed one, and b as a
    column of a wider array: views that are not contiguous, read
    uncopied."""
    gen = torch.Generator(device=dev).manual_seed(k)
    a, b = _spd(gen, 9, k + 8, 3, dev)
    for sub_a in (a[:, :k, :k], a[:, :k, :k].transpose(1, 2),
                  a[:, 8:, 8:]):
        sub_b = b[:, 8:, 1]
        assert not sub_a.is_contiguous() and not sub_b.is_contiguous()
        x = spd_solve.gj_solve(sub_a, sub_b, layout="blocked2")
        assert _rel(x, spd_solve.gj_solve_pair_plain(sub_a, sub_b)) < 1e-4
        assert bool((x[1] == 0).all())
    assert spd_solve.launches[name] == 3
    assert sum(spd_solve.launches.values()) == 3


@pytest.mark.parametrize("name,k", [("gj_blocked2_reg", 10),
                                    ("gj_blocked2_reg", 64),
                                    ("gj_blocked2_cta", 98),
                                    ("gj_blocked2_split", 192)])
def test_pair_kernels_system_alone_equals_in_batch(dev, name, k):
    """A system's x is bitwise the same solved alone and inside a
    batch."""
    gen = torch.Generator(device=dev).manual_seed(k + 1)
    a, b = _spd(gen, 301, k, 1, dev)
    b = b[..., 0]
    x = spd_solve.gj_solve(a, b, layout="blocked2")
    for row in (0, 1, 150, 300):
        alone = spd_solve.gj_solve(a[row:row + 1].clone(),
                                   b[row:row + 1].clone(), layout="blocked2")
        assert torch.equal(alone[0], x[row])
    assert spd_solve.launches[name] == 5


@pytest.mark.parametrize("name,k", [("gj_blocked2_reg", 2),
                                    ("gj_blocked2_reg", 64),
                                    ("gj_blocked2_cta", 66),
                                    ("gj_blocked2_cta", 128),
                                    ("gj_blocked2_split", 130),
                                    ("gj_blocked2_split", 256)])
def test_pair_kernels_all_zero_systems_are_exactly_zero(dev, name, k):
    a = torch.zeros(7, k, k, device=dev)
    b = torch.zeros(7, k, device=dev)
    x = spd_solve.gj_solve(a, b, layout="blocked2")
    assert bool((x == 0).all())
    assert spd_solve.launches[name] == 1


@pytest.mark.parametrize("name,r,k", [("gj_blocked2_split", 13_850, 192),
                                      ("gj_blocked2_split", 64, 256),
                                      ("gj_blocked2_cta", 300, 128)])
def test_pair_kernels_repeat_bitwise(dev, name, r, k):
    """One barrier a pair step, both pivot rows double-buffered (the split
    kernel reads their shared parts in place), and the buffers' parity
    carried across the split kernel's hand-off. A buffer or a row
    overwritten before every thread had read it would show as a
    difference from run to run, or from the plain version."""
    gen = torch.Generator(device=dev).manual_seed(k + 3)
    a, b = _spd(gen, r, k, 1, dev)
    b = b[..., 0]
    x = spd_solve.gj_solve(a, b, layout="blocked2")
    for _ in range(3):
        assert torch.equal(spd_solve.gj_solve(a, b, layout="blocked2"), x)
    assert _rel(x, spd_solve.gj_solve_pair_plain(a, b)) < 1e-4
    assert spd_solve.launches[name] == 4


def test_blocked2_above_256_runs_the_kernel_it_replaced(dev):
    """K = 258 routes to gj_layouts.cu's gj_blocked2, its device-memory
    variant (a [K][K + 1] copy past a block's shared memory)."""
    k = 258
    gen = torch.Generator(device=dev).manual_seed(k)
    a, b = _spd(gen, 4, k, 1, dev)
    assert spd_solve.blocked2_kernel(k) == "gj_blocked2"
    assert not spd_solve.shared_fits(k, 1, a.device, "gj_blocked2")
    x = spd_solve.gj_solve(a, b[..., 0], layout="blocked2")
    assert spd_solve.launches["gj_blocked2"] == 1
    assert sum(spd_solve.launches.values()) == 1
    assert _rel(x, spd_solve.gj_solve_blocked2_plain(a, b[..., 0])) < 1e-4
    assert _rel(x.double(), _solve64(a, b[..., 0], "blocked2")) < 1e-4
    assert bool((x[1] == 0).all())


def test_pair_wrappers_refuse_what_the_kernel_does_not_take(dev):
    for name, ks in _PAIR_RANKS.items():
        k = ks[-1]
        a = torch.eye(k, device=dev).expand(2, k, k)
        with pytest.raises(ValueError, match="one right-hand side"):
            spd_solve._launch(name, a, torch.ones(2, k, 2, device=dev))
        with pytest.raises(ValueError, match="CUDA"):
            spd_solve._launch(name, a, torch.ones(2, k, 1))
    assert not any(spd_solve.launches.values())


@pytest.mark.parametrize("rank", [16, 100, 160])
def test_als_under_blocked2_matches_chol_on_card(dev, rank, monkeypatch):
    rng = np.random.default_rng(5)
    ui = rng.integers(0, 300, 6000).astype(np.int32)
    ii = rng.integers(0, 200, 6000).astype(np.int32)
    r = rng.uniform(1, 5, 6000).astype(np.float32)
    base = dict(rank=rank, iterations=4, reg=0.05, seed=0, split_cap=32)
    monkeypatch.setenv("PIO_GJ_LAYOUT", "blocked2")
    gj = als.als_train(ui, ii, r, 300, 200, als.ALSConfig(solver="gj", **base),
                       device=dev, compute_rmse=True)
    name = spd_solve.blocked2_kernel(rank)
    assert spd_solve.launches[name] > 0
    assert sum(spd_solve.launches.values()) == spd_solve.launches[name]
    ch = als.als_train(ui, ii, r, 300, 200,
                       als.ALSConfig(solver="chol", **base), device=dev,
                       compute_rmse=True)
    np.testing.assert_allclose(gj.rmse_history, ch.rmse_history, rtol=2e-3)


# chunk widths 32 and 64: one below, at and above each boundary, and the
# four chunks of the rank-256 base (225)
_MULTI_RHS = [1, 31, 32, 33, 63, 64, 65, 225]


@pytest.mark.parametrize("m", _MULTI_RHS)
@pytest.mark.parametrize("r", [0, 1, 2, 37])
def test_multi_reg_kernel_matches_plain(dev, r, m):
    """The multi-RHS register kernel at K = 32 against both plain versions
    under either chunk width; X does not depend on the chunk width."""
    gen = torch.Generator(device=dev).manual_seed(r * 1000 + m)
    a, b = _spd(gen, max(r, 2), 32, m, dev)
    a, b = a[:r], b[:r]
    assert spd_solve.multi_kernel(32, m) == "gj_aug_multi_reg"
    x = spd_solve.gj_solve_multi(a, b)
    assert x.shape == (r, 32, m)
    assert spd_solve.launches["gj_aug_multi_reg"] == (1 if r else 0)
    assert sum(spd_solve.launches.values()) == (1 if r else 0)
    for chunk in (32, 64):
        xc = spd_solve._launch("gj_aug_multi_reg", a, b, chunk=chunk)
        assert torch.equal(xc, x)
    if r == 0:
        return
    assert _rel(x, spd_solve.gj_solve_multi_reg_plain(a, b)) < 1e-4
    assert _rel(x, spd_solve.gj_solve_multi_plain(a, b)) < 1e-4
    if r >= 2:  # _spd's all-zero system
        assert bool((x[1] == 0).all())


@pytest.mark.parametrize("m", [1, 73, 97])
@pytest.mark.parametrize("k", [1, 2, 8, 16, 17, 24, 25, 31])
def test_multi_reg_kernel_matches_plain_below_32(dev, k, m):
    """Both padded sizes (KP = 16 at K ≤ 16, else 32), the rank-96 and
    rank-200 base ranks (24, 25) among them."""
    gen = torch.Generator(device=dev).manual_seed(k * 100 + m)
    a, b = _spd(gen, 37, k, m, dev)
    x = spd_solve.gj_solve_multi(a, b)
    assert _rel(x, spd_solve.gj_solve_multi_reg_plain(a, b)) < 1e-4
    assert _rel(x, spd_solve.gj_solve_multi_plain(a, b)) < 1e-4
    assert bool((x[1] == 0).all())
    assert spd_solve.launches["gj_aug_multi_reg"] == 1
    assert sum(spd_solve.launches.values()) == 1


def test_multi_reg_kernel_takes_schur_views(dev):
    """The recursion's operands as it passes them: A11 = a[:, :h, :h] and
    the Schur complement, B = torch.cat([A12, B1]); and a transposed A."""
    gen = torch.Generator(device=dev).manual_seed(5)
    a, b = _spd(gen, 40, 64, 1, dev)
    h = 32
    a11, a12 = a[:, :h, :h], a[:, :h, h:]
    rhs = torch.cat([a12, b[:, :h]], dim=2)
    assert not a11.is_contiguous()
    for sub_a, sub_b in ((a11, rhs), (a11.transpose(1, 2), rhs),
                         (a11, rhs[:, :, 5:40]),
                         (a[:, h:, h:] - torch.bmm(a[:, h:, :h], a12),
                          b[:, h:])):
        x = spd_solve.gj_solve_multi(sub_a, sub_b)
        assert _rel(x, spd_solve.gj_solve_multi_reg_plain(sub_a, sub_b)) \
            < 1e-4
        assert bool((x[1] == 0).all())
    assert spd_solve.launches["gj_aug_multi_reg"] == 4
    assert sum(spd_solve.launches.values()) == 4


@pytest.mark.parametrize("m", [1, 97, 225])
def test_multi_reg_kernel_system_alone_equals_in_batch(dev, m):
    """A system's X is bitwise the same solved alone and inside a batch."""
    gen = torch.Generator(device=dev).manual_seed(m)
    a, b = _spd(gen, 301, 32, m, dev)
    x = spd_solve.gj_solve_multi(a, b)
    for row in (0, 150, 300):
        alone = spd_solve.gj_solve_multi(a[row:row + 1].clone(),
                                         b[row:row + 1].clone())
        assert torch.equal(alone[0], x[row])


def test_kernel_takes_strided_blocks(dev):
    """Schur sub-blocks reach the kernel as strided views, uncopied."""
    gen = torch.Generator(device=dev).manual_seed(1)
    a, b = _spd(gen, 50, 64, 40, dev)
    sub_a, sub_b = a[:, :32, :32], b[:, :32, 3:20]
    assert not sub_a.is_contiguous() and not sub_b.is_contiguous()
    x = spd_solve.gj_solve_multi(sub_a, sub_b)
    assert _rel(x, spd_solve.gj_solve_multi_plain(sub_a, sub_b)) < 1e-4


# the multi-RHS block kernel (32 < K ≤ 128): the route's shapes (odd K
# with M = K + 1, 2K + 1, 3K + 1), each padded size's ends, one and two
# chunks of each width (C = 32, 64), and M = 1 and 2, which no route
# sends it
_MULTI_CTA_SHAPES = [(33, 34), (33, 100), (49, 50), (63, 64), (63, 190),
                     (64, 7), (65, 66), (75, 76), (95, 96), (97, 98),
                     (125, 126), (127, 128), (128, 33), (40, 1), (100, 2)]


def _solve64_multi(a, b):
    """A float64 solve of [R, K, K] against [R, K, M]; an all-zero system
    becomes I X = 0."""
    a64 = a.double()
    zero = (a64 == 0).flatten(1).all(1)
    a64[zero] = torch.eye(a.shape[1], dtype=torch.float64, device=a.device)
    return torch.linalg.solve(a64, b.double())


def _multi_cta(a, b):
    """X through `gj_solve_multi` where (K, M) routes to the multi-RHS
    block kernel, else straight through its wrapper."""
    if spd_solve.multi_kernel(a.shape[1], b.shape[2]) == "gj_aug_multi_cta":
        return spd_solve.gj_solve_multi(a, b)
    return spd_solve._launch("gj_aug_multi_cta", a, b)


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("k,m", _MULTI_CTA_SHAPES)
def test_multi_cta_kernel_matches_plain(dev, k, m, r):
    """One launch, against its plain version, the replaced kernel's plain
    version and a float64 solve; R = 3 holds _spd's all-zero system."""
    gen = torch.Generator(device=dev).manual_seed(k * 1000 + m * 10 + r)
    a, b = _spd(gen, 3, k, m, dev)
    a, b = a[:r], b[:r]
    x = _multi_cta(a, b)
    assert spd_solve.launches["gj_aug_multi_cta"] == 1
    assert sum(spd_solve.launches.values()) == 1
    assert x.shape == (r, k, m)
    assert torch.isfinite(x).all()
    assert _rel(x, spd_solve.gj_solve_cta_plain(a, b)) < 1e-4
    assert _rel(x, spd_solve.gj_solve_multi_plain(a, b)) < 1e-4
    assert _rel(x.double(), _solve64_multi(a, b)) < 1e-4
    if r == 3:
        assert bool((x[1] == 0).all())


@pytest.mark.parametrize("k,m", [(33, 34), (63, 190), (125, 126)])
def test_multi_cta_all_zero_systems_are_exactly_zero(dev, k, m):
    a = torch.zeros(7, k, k, device=dev)
    b = torch.zeros(7, k, m, device=dev)
    x = spd_solve.gj_solve_multi(a, b)
    assert bool((x == 0).all())
    assert spd_solve.launches["gj_aug_multi_cta"] == 1


@pytest.mark.parametrize("r,k,m", [(2_744, 125, 126), (2_744, 63, 190),
                                   (13_850, 49, 50), (300, 75, 76)])
def test_multi_cta_bitwise_across_r_and_launches(dev, r, k, m):
    """One barrier a step with the pivot row (and its C entries of B)
    double-buffered, A's elimination repeated in every chunk's block: X
    is bitwise the same from launch to launch, for a leading part of the
    batch solved alone, for single systems, and for B's columns solved in
    other chunks (other widths and slot counts C)."""
    gen = torch.Generator(device=dev).manual_seed(r + k + m)
    a, b = _spd(gen, r, k, m, dev)
    x = spd_solve.gj_solve_multi(a, b)
    for _ in range(3):
        assert torch.equal(spd_solve.gj_solve_multi(a, b), x)
    assert torch.equal(spd_solve.gj_solve_multi(a[:37], b[:37]), x[:37])
    for row in (0, 1, r - 1):
        alone = spd_solve.gj_solve_multi(a[row:row + 1].clone(),
                                         b[row:row + 1].clone())
        assert torch.equal(alone[0], x[row])
    for lo, hi in ((0, 20), (20, m), (m - 1, m)):
        part = spd_solve._launch("gj_aug_multi_cta", a, b[:, :, lo:hi])
        assert torch.equal(part, x[:, :, lo:hi])
    assert _rel(x, spd_solve.gj_solve_cta_plain(a, b)) < 1e-4
    assert spd_solve.launches["gj_aug_multi_cta"] == \
        sum(spd_solve.launches.values())


@pytest.mark.parametrize("h", [33, 49, 63, 75, 125])
def test_multi_cta_kernel_takes_schur_views(dev, h):
    """The recursion's operands as it passes them at rank 2h: A11 =
    a[:, :h, :h] and B = torch.cat([A12, B1]); a transposed A; a column
    slice of B; and A22 = a[:, h:, h:] against B2 twice over."""
    gen = torch.Generator(device=dev).manual_seed(h)
    a, b = _spd(gen, 40, 2 * h, 1, dev)
    a11, a12 = a[:, :h, :h], a[:, :h, h:]
    rhs = torch.cat([a12, b[:, :h]], dim=2)
    assert not a11.is_contiguous()
    for sub_a, sub_b in ((a11, rhs), (a11.transpose(1, 2), rhs),
                         (a11, rhs[:, :, 5:40]),
                         (a[:, h:, h:], torch.cat([b[:, h:], b[:, h:]],
                                                  dim=2))):
        x = spd_solve.gj_solve_multi(sub_a, sub_b)
        assert _rel(x, spd_solve.gj_solve_cta_plain(sub_a, sub_b)) < 1e-4
        assert bool((x[1] == 0).all())
    assert spd_solve.launches["gj_aug_multi_cta"] == 4
    assert sum(spd_solve.launches.values()) == 4


def test_multi_cta_wrapper_refuses_what_the_kernel_does_not_take(dev):
    big = torch.eye(129, device=dev).expand(2, 129, 129)
    with pytest.raises(ValueError, match="K ≤ 128"):
        spd_solve._launch("gj_aug_multi_cta", big,
                          torch.ones(2, 129, 4, device=dev))
    a = torch.eye(40, device=dev).expand(2, 40, 40)
    with pytest.raises(ValueError, match="CUDA"):
        spd_solve._launch("gj_aug_multi_cta", a, torch.ones(2, 40, 4))
    with pytest.raises(ValueError, match="float32"):
        spd_solve._launch("gj_aug_multi_cta", a.double(),
                          torch.ones(2, 40, 4, device=dev,
                                     dtype=torch.float64))
    assert not any(spd_solve.launches.values())


@pytest.mark.parametrize("rank,kernels", [
    (98, {"gj_aug_multi_cta", "gj_aug_reg"}),
    (150, {"gj_aug_multi_cta", "gj_aug_cta"}),
    (255, {"gj_aug_split"})])
def test_als_auto_above_32_matches_chol_on_card(dev, rank, kernels,
                                                monkeypatch):
    """`auto` at ranks whose Schur base lies above K = 32: the routed
    kernels launch, gj_aug_multi never does, and the RMSE trajectory
    meets chol's."""
    monkeypatch.delenv("PIO_GJ_LAYOUT", raising=False)
    rng = np.random.default_rng(6)
    ui = rng.integers(0, 300, 6000).astype(np.int32)
    ii = rng.integers(0, 200, 6000).astype(np.int32)
    r = rng.uniform(1, 5, 6000).astype(np.float32)
    base = dict(rank=rank, iterations=4, reg=0.05, seed=0, split_cap=32)
    gj = als.als_train(ui, ii, r, 300, 200, als.ALSConfig(solver="gj", **base),
                       device=dev, compute_rmse=True)
    assert {k for k, v in spd_solve.launches.items() if v} == kernels
    ch = als.als_train(ui, ii, r, 300, 200,
                       als.ALSConfig(solver="chol", **base), device=dev,
                       compute_rmse=True)
    np.testing.assert_allclose(gj.rmse_history, ch.rmse_history, rtol=2e-3)


@pytest.mark.parametrize("k", [64, 96, 128, 200])
def test_gj_solve_auto_matches_library_solve(dev, k):
    gen = torch.Generator(device=dev).manual_seed(k)
    a, b = _spd(gen, 40, k, 1, dev)
    a[1] = torch.eye(k, device=dev)  # keep the library solve defined
    x = spd_solve.gj_solve(a, b[..., 0])
    assert _rel(x, torch.linalg.solve(a, b)[..., 0]) < 1e-4
    assert sum(spd_solve.launches.values()) > 0
    assert (spd_solve.launches["gj_aug_reg"] > 0) == (k <= 64)


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    a = torch.eye(4, device=dev).expand(2, 4, 4)
    with pytest.raises(ValueError, match="float32"):
        spd_solve._launch("gj_aug_multi", a.double(),
                          torch.ones(2, 4, 1, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError, match="shapes"):
        spd_solve._launch("gj_aug_multi", a, torch.ones(2, 3, 1, device=dev))
    with pytest.raises(ValueError, match="CUDA"):
        spd_solve._launch("gj_aug_multi", a, torch.ones(2, 4, 1))
    with pytest.raises(ValueError, match="one right-hand side"):
        spd_solve._launch("gj_packed", a, torch.ones(2, 4, 2, device=dev))
    with pytest.raises(ValueError, match="K ≤ 64"):
        big = torch.eye(65, device=dev).expand(2, 65, 65)
        spd_solve._launch("gj_aug_reg", big, torch.ones(2, 65, 1, device=dev))
    with pytest.raises(ValueError, match="K ≤ 32"):
        big = torch.eye(33, device=dev).expand(2, 33, 33)
        spd_solve._launch("gj_aug_multi_reg", big,
                          torch.ones(2, 33, 4, device=dev))
    with pytest.raises(ValueError, match="float32"):
        spd_solve._launch("gj_aug_multi_reg", a.double(),
                          torch.ones(2, 4, 1, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        spd_solve._launch("gj_aug_multi_reg", a, torch.ones(2, 4, 1))
    assert not any(spd_solve.launches.values())


@pytest.mark.parametrize("rank", [16, 100])
def test_als_gj_matches_chol_on_card(dev, rank):
    rng = np.random.default_rng(3)
    ui = rng.integers(0, 300, 6000).astype(np.int32)
    ii = rng.integers(0, 200, 6000).astype(np.int32)
    r = rng.uniform(1, 5, 6000).astype(np.float32)
    base = dict(rank=rank, iterations=4, reg=0.05, seed=0, split_cap=32)
    gj = als.als_train(ui, ii, r, 300, 200, als.ALSConfig(solver="gj", **base),
                       device=dev, compute_rmse=True)
    assert sum(spd_solve.launches.values()) > 0
    ch = als.als_train(ui, ii, r, 300, 200,
                       als.ALSConfig(solver="chol", **base), device=dev,
                       compute_rmse=True)
    np.testing.assert_allclose(gj.rmse_history, ch.rmse_history, rtol=2e-3)


def test_device_topk_matches_host_on_card(dev):
    rng = np.random.default_rng(4)
    uf = rng.normal(size=(200, 16)).astype(np.float32)
    itf = rng.normal(size=(500, 16)).astype(np.float32)
    ids = np.arange(200, dtype=np.int32)
    exclude = {int(u): rng.choice(500, 30, replace=False).astype(np.int32)
               for u in ids}
    s_dev, i_dev = ranking.topk_device(uf, itf, ids, 10, exclude, device=dev)
    s_host, i_host = ranking.topk_host(uf, itf, ids, 10, exclude)
    np.testing.assert_allclose(s_dev, s_host, rtol=1e-5, atol=1e-5)
    gaps = np.abs(np.diff(s_host, axis=1)) < 1e-5
    tied = np.zeros_like(s_host, bool)
    tied[:, :-1] |= gaps
    tied[:, 1:] |= gaps
    np.testing.assert_array_equal(i_dev[~tied], i_host[~tied])


def _fold_model_and_hist(rank, n_users=300, n_items=200, n_dirty=40, seed=0):
    """A random model and full histories for `n_dirty` users, every one
    with 40-96 ratings (the fold's capacity tier 128)."""
    from predictionio_torch.data.bimap import BiMap
    from predictionio_torch.models.als_model import ALSModel

    rng = np.random.default_rng(seed)
    model = ALSModel(
        user_factors=rng.normal(size=(n_users, rank)).astype(np.float32),
        item_factors=(rng.normal(size=(n_items, rank)) / np.sqrt(rank))
        .astype(np.float32),
        user_ids=BiMap.string_int([f"u{i}" for i in range(n_users)]),
        item_ids=BiMap.string_int([f"i{i}" for i in range(n_items)]),
        device="cuda")
    hist = {}
    for u in range(n_dirty):
        items = rng.choice(n_items, rng.integers(40, 97), replace=False)
        hist[f"u{u}"] = [(f"i{i}", float(rng.integers(1, 6))) for i in items]
    return model, hist


@pytest.mark.parametrize("rank,kernel", [(64, "gj_aug_reg"),
                                         (128, "gj_aug_multi_reg")])
def test_fold_on_card_launches_the_kernel_of_its_rank(dev, rank, kernel):
    """A fold under `auto` launches the aug kernel of its rank (rank 64)
    or the Schur base kernel (rank 128) and no other; its rows solve the
    weighted normal equations (float64 bar of the reference's tests)."""
    from predictionio_torch.online import fold_model

    model, hist = _fold_model_and_hist(rank)
    cfg = als.ALSConfig(rank=rank, reg=0.05)
    folded, stats = fold_model(model, cfg, hist)
    assert stats.folded_users == len(hist)
    assert isinstance(folded.user_factors, np.ndarray)
    launched = {k: v for k, v in spd_solve.launches.items() if v}
    assert list(launched) == [kernel] and launched[kernel] > 0
    itf = model.item_factors.astype(np.float64)
    for u, pairs in hist.items():
        cols = np.asarray([model.item_ids[i] for i, _ in pairs])
        vals = np.asarray([v for _, v in pairs])
        y = itf[cols]
        want = np.linalg.solve(y.T @ y + 0.05 * len(cols) * np.eye(rank),
                               y.T @ vals)
        np.testing.assert_allclose(folded.user_factors[model.user_ids[u]],
                                   want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("rank", [64, 128])
def test_fold_on_card_single_equals_batched_at_matched_tier(dev, rank):
    """Eight users folded together equal each folded alone (both tier 8,
    capacity tier 128), a replay is bitwise idempotent, and device-
    resident factors come back on the device, equal to the host fold."""
    from predictionio_torch.online import fold_model, solve_rows
    from predictionio_torch.online.foldin import fold_bucket

    model, hist = _fold_model_and_hist(rank, n_dirty=8, seed=rank)
    cfg = als.ALSConfig(rank=rank, reg=0.05)
    entries = [(np.asarray([model.item_ids[i] for i, _ in pairs], np.int32),
                np.asarray([v for _, v in pairs], np.float32))
               for _, pairs in sorted(hist.items())]
    assert {fold_bucket([e], rank, 1.5)[0].cols.shape[1]
            for e in entries} == {128}
    opposing = torch.as_tensor(model.item_factors, device=dev)
    batched = solve_rows(opposing, entries, cfg)
    for n, e in enumerate(entries):
        assert torch.equal(solve_rows(opposing, [e], cfg)[0], batched[n])
    once, _ = fold_model(model, cfg, hist)
    twice, _ = fold_model(once, cfg, hist)
    assert np.array_equal(once.user_factors, twice.user_factors)
    on_dev = dataclasses.replace(
        model, user_factors=torch.as_tensor(model.user_factors, device=dev),
        item_factors=opposing)
    folded, _ = fold_model(on_dev, cfg, hist)
    assert folded.user_factors.device.type == "cuda"
    assert np.array_equal(folded.user_factors.cpu().numpy(),
                          once.user_factors)


def test_online_plane_poll_on_card_launches_its_kernel_and_replays_bitwise(
        dev, tmp_path, monkeypatch):
    """A store-deployed server on the card with the online plane: one poll
    folds a never-seen user and two re-raters on `gj_aug_reg` alone (rank
    64), the user is served at once, and a batch crashed before its
    watermark replays to bitwise the same factors."""
    import json
    from datetime import datetime, timedelta, timezone

    from predictionio_torch.controller import WorkflowContext
    from predictionio_torch.data.datamap import DataMap
    from predictionio_torch.data.events import Event
    from predictionio_torch.online import OnlineConfig
    from predictionio_torch.storage.base import App
    from predictionio_torch.storage.registry import (
        SourceConfig,
        Storage,
        StorageConfig,
    )
    from predictionio_torch.utils.faults import FaultInjected
    from predictionio_torch.workflow.core_workflow import CoreWorkflow
    from predictionio_torch.workflow.create_server import PredictionServer
    from predictionio_torch.workflow.workflow_utils import (
        EngineVariant,
        extract_engine_params,
        get_engine,
    )

    src = SourceConfig(name="CARD", type="memory")
    storage = Storage(StorageConfig(metadata=src, modeldata=src,
                                    eventdata=src))
    app_id = storage.meta_apps().insert(App(id=0, name="CardApp"))
    rng = np.random.default_rng(0)
    t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)

    def rate(u, i, r, when=None):
        e = Event(event="rate", entity_type="user", entity_id=u,
                  target_entity_type="item", target_entity_id=i,
                  properties=DataMap({"rating": r}))
        if when is not None:
            e.event_time = when
        storage.l_events().insert(e, app_id)

    for n in range(2_000):
        rate(f"u{rng.integers(120)}", f"i{rng.integers(150)}",
             float(rng.integers(1, 11)) / 2, t0 + timedelta(seconds=n))
    d = {"id": "card", "engineFactory": "predictionio_torch.templates."
         "recommendation.RecommendationEngine",
         "datasource": {"params": {"appName": "CardApp"}},
         "algorithms": [{"name": "als", "params": {
             "rank": 64, "numIterations": 3, "lambda": 0.05, "seed": 1}}]}
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps(d))
    variant = EngineVariant.from_dict(d)
    engine = get_engine(variant.engine_factory)
    CoreWorkflow.run_train(engine, extract_engine_params(engine, variant),
                           variant, WorkflowContext(device=dev,
                                                    storage=storage))
    server = PredictionServer(str(engine_json), ip="127.0.0.1", port=0,
                              device=dev, storage=storage,
                              online=OnlineConfig(fold_items=False))
    try:
        server.online.stop()
        for i in (3, 5, 7):
            rate("fresh", f"i{i}", 5.0)
        rate("u1", "i9", 1.0)
        rate("u2", "i9", 4.5)
        spd_solve.reset_launches()
        monkeypatch.setenv("PIO_FAULTS", "online.pre_watermark=error")
        with pytest.raises(FaultInjected):
            server.online.poll_once()
        launched = {k: v for k, v in spd_solve.launches.items() if v}
        assert list(launched) == ["gj_aug_reg"] and launched["gj_aug_reg"] > 0
        model = server.state.models[0]
        rows = [model.user_ids[u] for u in ("fresh", "u1", "u2")]
        pre = np.array(model.user_factors[rows], copy=True)
        monkeypatch.setenv("PIO_FAULTS", "")
        assert server.online.poll_once() == 5
        again = server.state.models[0]
        assert np.array_equal(
            again.user_factors[[again.user_ids[u]
                                for u in ("fresh", "u1", "u2")]], pre)
        assert server.online.poll_once() == 0
        items = [s["item"] for s in server.predict(
            {"user": "fresh", "num": 5})["itemScores"]]
        assert len(items) == 5 and not {"i3", "i5", "i7"} & set(items)
    finally:
        server.server_close()
        storage.close()


def test_serving_plane_batch_of_128_on_card_matches_host(dev, monkeypatch):
    """128 concurrent queries through the port's serving plane with
    max_batch 128: the batch past SERVE_HOST_MAX_BATCH scores on the card
    (`topk_device`), and every answer's item ids equal the host branch's
    (a query alone) wherever the scores are not tied."""
    import threading

    from predictionio_torch import convert
    from predictionio_torch.serving import (
        AdmissionConfig,
        BatcherConfig,
        ServingConfig,
        ServingPlane,
    )
    from predictionio_torch.templates.recommendation.engine import (
        ALSAlgorithm,
    )

    rng = np.random.default_rng(6)
    n_users, n_items, rank = 2_000, 2_700, 64
    seen_u = rng.integers(0, n_users, 40_000)
    model = convert.als_model_from_arrays(
        rng.normal(size=(n_users, rank)).astype(np.float32),
        rng.normal(size=(n_items, rank)).astype(np.float32),
        {f"u{i}": i for i in range(n_users)},
        {f"i{i}": i for i in range(n_items)},
        seen_u, rng.integers(0, n_items, len(seen_u)))
    model.device = str(dev)
    algo = ALSAlgorithm(None)
    device_calls = []
    topk_device = ranking.topk_device

    def counted(*args, **kw):
        device_calls.append(len(args[2]))
        return topk_device(*args, **kw)

    monkeypatch.setattr(ranking, "topk_device", counted)
    plane = None
    gate = threading.Event()

    def dispatch(queries):
        # the first dispatch waits for the rest of the 128 to queue, so
        # they leave as one batch
        if not gate.is_set():
            gate.set()
            deadline = time.monotonic() + 30
            while (len(plane.batcher._queue) + len(queries) < 128
                   and time.monotonic() < deadline):
                time.sleep(0.001)
        return algo.batch_predict(model, queries)

    plane = ServingPlane(dispatch, config=ServingConfig(
        admission=AdmissionConfig(max_queue=256),
        batcher=BatcherConfig(max_batch=128, max_wait_ms=50.0)))
    users = [f"u{u}" for u in rng.choice(n_users, 128, replace=False)]
    out = [None] * 128
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, plane.handle_query({"user": users[i], "num": 10})))
        for i in range(128)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        plane.close()
    assert device_calls and max(device_calls) > ranking.SERVE_HOST_MAX_BATCH
    for user, (result, degraded) in zip(users, out):
        assert degraded is False
        want = model.recommend_products(user, 10)  # alone: the host branch
        got = [(s["item"], s["score"]) for s in result["itemScores"]]
        scores = np.asarray([s for _, s in want])
        np.testing.assert_allclose([s for _, s in got], scores, rtol=1e-5,
                                   atol=1e-5)
        gaps = np.abs(np.diff(scores)) < 1e-5
        tied = np.zeros(len(scores), bool)
        tied[:-1] |= gaps
        tied[1:] |= gaps
        for pos in np.nonzero(~tied)[0]:
            assert got[pos][0] == want[pos][0], (user, pos)


def _hot_ratings(seed=0, n_u=600, n_i=120, nnz=60_000):
    """Zipf-ish items: the popular ones hold many more ratings than the
    split cap below, so a bucket chunk holds several segments of a row."""
    rng = np.random.default_rng(seed)
    ui = rng.integers(0, n_u, nnz).astype(np.int32)
    ii = np.minimum(rng.zipf(1.3, nnz) - 1, n_i - 1).astype(np.int32)
    r = rng.uniform(1, 5, nnz).astype(np.float32)
    return ui, ii, r, n_u, n_i


@pytest.mark.parametrize("implicit", [False, True])
def test_split_rows_train_twice_bitwise_on_card(dev, implicit):
    """Two trains with split rows give the same bits on the card: split
    rows sum their segments in a fixed order (a float index_add_ with
    repeated indices would not)."""
    ui, ii, r, n_u, n_i = _hot_ratings()
    cfg = als.ALSConfig(rank=64, iterations=3, reg=0.05, split_cap=64,
                        implicit=implicit)
    _, split = als.bucket_ragged_split(ii, ui, r, n_i, 8, cfg.split_cap)
    assert len(split) > 10
    a = als.als_train(ui, ii, r, n_u, n_i, cfg, device=dev)
    b = als.als_train(ui, ii, r, n_u, n_i, cfg, device=dev)
    np.testing.assert_array_equal(a.user_factors, b.user_factors)
    np.testing.assert_array_equal(a.item_factors, b.item_factors)


def test_checkpointed_resume_bitwise_on_card(dev, tmp_path):
    ui, ii, r, n_u, n_i = _hot_ratings(seed=1)
    cfg = als.ALSConfig(rank=64, iterations=4, reg=0.05, split_cap=64)
    want = als.als_train(ui, ii, r, n_u, n_i, cfg, device=dev)
    als.als_train(ui, ii, r, n_u, n_i, dataclasses.replace(cfg, iterations=2),
                  device=dev, checkpoint_dir=str(tmp_path))
    got = als.als_train(ui, ii, r, n_u, n_i, cfg, device=dev,
                        checkpoint_dir=str(tmp_path))
    assert got.start_epoch == 2
    np.testing.assert_array_equal(got.user_factors, want.user_factors)
    np.testing.assert_array_equal(got.item_factors, want.item_factors)


def _separable(dev, n=200_000, d=64, c=10, seed=0):
    """Labels that a linear rule of the features decides (argmax x @ W)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, d), generator=gen, device=dev)
    w = torch.randn((d, c), generator=gen, device=dev)
    return x.cpu().numpy(), (x @ w).argmax(1).int().cpu().numpy(), c


def test_logreg_fits_bitwise_on_card(dev, tmp_path):
    """Two identical `logreg_train` fits, a chunked one and a resumed one
    give the same bits on the card: ops/classify.py accumulates through
    no atomics, and cuBLAS repeats its GEMMs on one stream."""
    x, y, c = _separable(dev)
    a = classify.logreg_train(x, y, c, iterations=60, device=dev)
    b = classify.logreg_train(x, y, c, iterations=60, device=dev)
    chunked = classify.logreg_train(x, y, c, iterations=60, device=dev,
                                    checkpoint_dir=str(tmp_path / "c"),
                                    checkpoint_every=7)
    classify.logreg_train(x, y, c, iterations=30, device=dev,
                          checkpoint_dir=str(tmp_path / "r"),
                          checkpoint_every=10)
    resumed = classify.logreg_train(x, y, c, iterations=60, device=dev,
                                    checkpoint_dir=str(tmp_path / "r"),
                                    checkpoint_every=10)
    for got in (b, chunked, resumed):
        np.testing.assert_array_equal(got.weights, a.weights)
        np.testing.assert_array_equal(got.bias, a.bias)
        assert got.loss_history == a.loss_history
    assert a.loss_history[-1] < 0.5 * a.loss_history[0]


def test_classify_grids_on_card_match_sequential(dev):
    """Each grid cell within the reference's bars of its sequential fit
    (LogReg rtol 2e-4 / atol 1e-5 with mixed horizons; NB rtol 1e-6 /
    atol 1e-7), and the card's fit within them of the CPU's."""
    x, y, _ = _separable(dev, n=20_000, d=16, c=4, seed=1)
    cells = [(0.1, 0.0, 40), (0.3, 0.01, 25), (0.05, 0.1, 10)]
    grid = classify.logreg_train_grid(
        x, y, 4, [n for *_, n in cells], [lr for lr, _, _ in cells],
        [rg for _, rg, _ in cells], device=dev)
    for (lr, rg, n), m in zip(cells, grid):
        seq = classify.logreg_train(x, y, 4, iterations=n, learning_rate=lr,
                                    reg=rg, device=dev)
        for name in ("weights", "bias", "loss_history"):
            np.testing.assert_allclose(getattr(m, name), getattr(seq, name),
                                       rtol=2e-4, atol=1e-5)
    host = classify.logreg_train(x, y, 4, iterations=40, device="cpu")
    np.testing.assert_allclose(host.weights, grid[0].weights, rtol=2e-4,
                               atol=1e-5)
    counts = np.abs(x)
    nbs = classify.naive_bayes_train_grid(counts, y, 4, [0.5, 2.0],
                                          device=dev)
    for s, m in zip((0.5, 2.0), nbs):
        seq = classify.naive_bayes_train(counts, y, 4, smoothing=s,
                                         device=dev)
        np.testing.assert_allclose(m.log_theta, seq.log_theta, rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(m.log_prior, seq.log_prior, rtol=1e-6,
                                   atol=1e-7)


def _w2v_pairs(v=5_000, p=60_000, seed=0):
    return np.random.default_rng(seed).integers(0, v, (p, 2)).astype(
        np.int32), v


def test_word2vec_fits_bitwise_on_card(dev, tmp_path):
    """Two identical SGNS fits, a chunked one and one resumed from a
    checkpoint give the same bits on the card: the scatter sums repeated
    rows in a fixed order, and the draws' generator state is carried."""
    pairs, v = _w2v_pairs()
    cfg = text.Word2VecConfig(dim=128, negatives=5, steps=60,
                              batch_size=4_096, seed=3)
    a = text.word2vec_fit_pairs(pairs, v, cfg, device=dev)
    b = text.word2vec_fit_pairs(pairs, v, cfg, device=dev)
    chunked = text.word2vec_fit_pairs(pairs, v, cfg, device=dev,
                                      checkpoint_dir=str(tmp_path / "c"),
                                      checkpoint_every=7)
    text.word2vec_fit_pairs(pairs, v, dataclasses.replace(cfg, steps=30),
                            device=dev, checkpoint_dir=str(tmp_path / "r"),
                            checkpoint_every=10)
    text.reset_sampler_calls()
    resumed = text.word2vec_fit_pairs(pairs, v, cfg, device=dev,
                                      checkpoint_dir=str(tmp_path / "r"),
                                      checkpoint_every=10)
    assert text.sampler_calls["sgns"] == 30
    for got in (b, chunked, resumed):
        np.testing.assert_array_equal(got[0], a[0])
        np.testing.assert_array_equal(got[1], a[1])
        assert got[2] == a[2]
    assert len(a[2]) == 60 and np.isfinite(a[2]).all()


def test_sgns_loop_card_matches_cpu_on_the_same_draws(dev):
    """50 steps on the card and on the CPU from the same tables and the
    same draws (made on the card, copied to the CPU: the two devices'
    generators give different streams) within rtol 1e-5 / atol 1e-6."""
    pairs, v = _w2v_pairs(seed=1)
    cfg = text.Word2VecConfig(dim=128, negatives=5, batch_size=4_096)
    gen = torch.Generator(device=dev).manual_seed(5)
    sampler = text.TorchSampler(gen, len(pairs), v, cfg)
    draws = [sampler() for _ in range(50)]
    rng = np.random.default_rng(2)
    emb_in0 = ((rng.random((v, cfg.dim), dtype=np.float32) - 0.5)
               / cfg.dim)
    tables = {}
    for where in (dev, torch.device("cpu")):
        emb_in = torch.tensor(emb_in0, device=where)
        emb_out = torch.zeros_like(emb_in)
        moved = iter([(i.to(where), n.to(where)) for i, n in draws])
        losses = text.sgns_loop(emb_in, emb_out,
                                torch.from_numpy(pairs).long().to(where),
                                moved.__next__, 50, cfg)
        tables[where.type] = [t.cpu().numpy()
                              for t in (emb_in, emb_out, losses)]
    for got, want in zip(tables["cuda"], tables["cpu"]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_scatter_add_rows_repeats_its_bits_on_card(dev):
    """The fixed-order scatter gives the same bits twice on rows that
    repeat (a Zipf-like draw), and agrees with `index_add_` within f32
    rounding."""
    gen = torch.Generator(device=dev).manual_seed(0)
    ranks = torch.rand(81_920, generator=gen, device=dev)
    ids = (ranks.pow(4) * 20_000).long()  # low ids repeat often
    rows = torch.randn((81_920, 128), generator=gen, device=dev)
    table0 = torch.randn((20_000, 128), generator=gen, device=dev)
    a, b = table0.clone(), table0.clone()
    text.scatter_add_rows(a, ids, rows)
    text.scatter_add_rows(b, ids, rows)
    assert torch.equal(a, b)
    atomics = table0.clone().index_add_(0, ids, rows)
    torch.testing.assert_close(a, atomics, rtol=1e-4, atol=1e-3)


def test_basket_counts_past_bf16_exact_on_card(dev):
    """A pair in 1 023 baskets and one in 257 inside one 1 024-basket
    chunk: the card's int8 Gram counts both exactly (a bf16 product's
    output would give 1 024 and 256), as the CPU does."""
    b = np.concatenate([np.repeat(np.arange(1023), 2), [1023],
                        np.repeat(np.arange(257), 2)])
    i = np.concatenate([np.tile([0, 1], 1023), [2], np.tile([2, 3], 257)])
    got = basket.cooccurrence_matrix(b, i, 1024, 4, device=dev)
    assert got[0, 1] == got[1, 0] == 1023
    assert got[2, 3] == got[3, 2] == 257
    np.testing.assert_array_equal(
        got, basket.cooccurrence_matrix(b, i, 1024, 4, device="cpu"))


def test_basket_rules_on_card_bitwise_equal_cpu(dev):
    """3 000 baskets over 300 Zipf-drawn items, a bot basket capped:
    the card's Gram and every rule array equal the CPU's bit for bit,
    under both scores."""
    rng = np.random.default_rng(0)
    p = 1.0 / np.arange(1, 301)
    sizes = 1 + rng.poisson(9, 3_000)
    b = np.repeat(np.arange(3_000), sizes)
    i = rng.choice(300, len(b), p=p / p.sum())
    b = np.concatenate([b, np.full(900, 17)])
    i = np.concatenate([i, rng.integers(0, 300, 900)])
    np.testing.assert_array_equal(
        basket.cooccurrence_matrix(b, i, 3_000, 300, device=dev),
        basket.cooccurrence_matrix(b, i, 3_000, 300, device="cpu"))
    for score in ("lift", "confidence"):
        got, want = (basket.mine_rules(b, i, 3_000, 300, min_support=0.001,
                                       min_confidence=0.05, score=score,
                                       device=where)
                     for where in (dev, "cpu"))
        assert len(got.cond_items) > 100
        for name in ("cond_items", "cons_items", "scores", "support",
                     "confidence", "lift"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), err_msg=name)


def _session_inputs(v, d, n_blocks, l, b, seed):
    """Seeded params of the template's init and b right-padded histories
    of lengths 1..l (the first row of length 1, the second of l)."""
    rng = np.random.default_rng(seed)
    params = sessionrec.init_params(v, d, n_blocks, l, rng)
    lengths = rng.integers(1, l + 1, b).astype(np.int32)
    lengths[:2] = (1, l)
    seq = np.full((b, l), v, np.int32)
    for r, n in enumerate(lengths):
        seq[r, :n] = rng.choice(v, n, replace=False)
    return params, seq, lengths


@pytest.mark.parametrize("v,d,n_blocks,heads,l,b", [
    (8_192, 16, 1, 2, 32, 64), (8_192, 8, 1, 2, 32, 64),
    (8_192, 16, 2, 2, 32, 64), (500, 64, 2, 4, 256, 6)])
def test_session_kernels_match_plain(dev, v, d, n_blocks, heads, l, b):
    """`session_encode` and `session_readout` against their plain versions
    on the same card tensors within rtol 1e-5 / atol 1e-6; the last case's
    working set (5·L·D + H·L² floats, 1.3 MB) is past shared memory and
    runs the workspace variant."""
    params, seq, lengths = _session_inputs(v, d, n_blocks, l, b, seed=d + l)
    p = session.params_on(params, dev)
    seq_t = torch.tensor(seq, device=dev)
    len_t = torch.tensor(lengths, device=dev)
    assert session.encode_shared_fits(l, d, heads, dev) == (l < 256)
    session.reset_launches()
    h = session.session_encode(p["emb"], p["pos"], p["packed"], n_blocks,
                               seq_t, len_t, heads)
    scores = session.session_readout(h, p["emb"][:-1])
    torch.cuda.synchronize()
    assert session.launches == {"session_encode": 1, "session_readout": 1}
    h_plain = session.session_encode_plain(p, seq_t, len_t, heads)
    torch.testing.assert_close(h, h_plain, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        scores, session.session_readout_plain(h, p["emb"][:-1]),
        rtol=1e-5, atol=1e-6)
    assert torch.isfinite(scores).all() and scores.shape == (b, v)


# the plain tests' four shapes, then the plan's B- and L-dependent
# branches at the template's width: a fold's batch (the readout's 32- and
# 64-row groups, 2 and 8 warp histories a block) and L 64 (the block body
# in shared memory)
SESSION_SHAPES = [(8_192, 16, 1, 2, 32, 64), (8_192, 8, 1, 2, 32, 64),
                  (8_192, 16, 2, 2, 32, 64), (500, 64, 2, 4, 256, 6),
                  (8_192, 16, 1, 2, 32, 128), (8_192, 16, 1, 2, 32, 512),
                  (8_192, 16, 1, 2, 32, 4_096), (8_192, 16, 1, 2, 64, 64)]


@pytest.mark.parametrize("v,d,n_blocks,heads,l,b", SESSION_SHAPES)
def test_session_kernels_match_first_versions_bitwise(dev, v, d, n_blocks,
                                                      heads, l, b):
    """The redesigned `session_encode` and `session_readout` give the bits
    of their first versions on the same card tensors, within rtol 1e-5 /
    atol 1e-6 of their plain versions: the warp body at tier 32 (several
    histories a block from B 512), the block body in shared memory at
    L 64 and its workspace route at (500, 64, 2, 4, 256, 6); the tiled
    readout at every shape (64-row groups from B 512)."""
    params, seq, lengths = _session_inputs(v, d, n_blocks, l, b, seed=d + l)
    p = session.params_on(params, dev)
    seq_t = torch.tensor(seq, device=dev)
    len_t = torch.tensor(lengths, device=dev)
    items = p["emb"][:-1]
    plan = session.launch_plan(
        b, l, d, heads, v, n_blocks,
        *session.card_limits(torch.cuda.current_device()))
    assert plan.body == {32: "warp", 64: "block", 256: "block_workspace"}[l]
    if b >= 512:
        assert plan.histories > 1 and plan.rd_rows == 64
    session.reset_launches()
    h = session.session_encode(p["emb"], p["pos"], p["packed"], n_blocks,
                               seq_t, len_t, heads)
    h1 = session.session_encode_v1(p["emb"], p["pos"], p["packed"],
                                   n_blocks, seq_t, len_t, heads)
    scores = session.session_readout(h, items)
    scores1 = session.session_readout_v1(h1, items)
    torch.cuda.synchronize()
    assert torch.equal(h, h1)
    assert torch.equal(scores, scores1)
    torch.testing.assert_close(
        h, session.session_encode_plain(p, seq_t, len_t, heads),
        rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        scores, session.session_readout_plain(h, items), rtol=1e-5,
        atol=1e-6)
    assert session.launches == {"session_encode": 1, "session_readout": 1}
    assert session.launches_v1 == {"session_encode_v1": 1,
                                   "session_readout_v1": 1}


@pytest.mark.parametrize("v,d,n_blocks,heads,l,b", SESSION_SHAPES)
def test_session_score_is_the_pair_bitwise(dev, v, d, n_blocks, heads, l, b):
    """`score` (one allocation, one `session_score` call: the readout as
    the encoder's programmatic dependent) gives the bits of
    `session_encode` then `session_readout` launched apart, twenty times
    over, and counts one launch of each a call."""
    params, seq, lengths = _session_inputs(v, d, n_blocks, l, b, seed=d + l)
    p = session.params_on(params, dev)
    seq_t = torch.tensor(seq, device=dev)
    len_t = torch.tensor(lengths, device=dev)
    session.reset_launches()
    got = [session.score(p, seq_t, len_t, heads) for _ in range(20)]
    torch.cuda.synchronize()
    assert session.launches == {"session_encode": 20, "session_readout": 20}
    h = session.session_encode(p["emb"], p["pos"], p["packed"], n_blocks,
                               seq_t, len_t, heads)
    want = session.session_readout(h, p["emb"][:-1])
    torch.cuda.synchronize()
    assert got[0].shape == (b, v)
    for scores in got:
        assert torch.equal(scores, want)
    assert session.launches == {"session_encode": 21, "session_readout": 21}
    assert session.launches_v1 == {"session_encode_v1": 0,
                                   "session_readout_v1": 0}


def test_session_scorer_bitwise_batched_vs_single_at_every_tier(dev):
    """On the card a history scores bitwise the same alone at every tier
    that fits it (the default ladder 8, 16, 32 and 5, 12) and as a row of
    a batch at every batch tier 1, 2, 4 … 64."""
    params, seq, lengths = _session_inputs(8_192, 16, 1, 32, 64, seed=5)
    p = session.params_on(params, dev)

    singles = {}
    for r in range(64):
        n = int(lengths[r])
        got = []
        for tier in (5, 8, 12, 16, 32):
            if tier < n:
                continue
            s = np.full((1, tier), 8_192, np.int32)
            s[0, :n] = seq[r, :n]
            got.append(session.score(p, torch.tensor(s, device=dev),
                                     torch.tensor(lengths[r:r + 1],
                                                  device=dev), 2)[0])
        for other in got[1:]:
            assert torch.equal(other, got[0]), r
        singles[r] = got[0]
    for bt in (1, 2, 4, 8, 16, 32, 64):
        batch = session.score(p, torch.tensor(seq[:bt], device=dev),
                              torch.tensor(lengths[:bt], device=dev), 2)
        for r in range(bt):
            assert torch.equal(batch[r], singles[r]), (bt, r)


def test_sessionrec_fits_bitwise_on_card(dev):
    """Two 5-epoch fits at 2 048 users × 1 000 items give the same bits on
    the card (the gather's backward sums in a fixed order), and their
    per-epoch losses agree with the CPU's within rtol 1e-4."""
    rng = np.random.default_rng(0)
    user_seqs = {f"u{u}": rng.choice(1_000, int(rng.integers(2, 33)),
                                     replace=False).astype(np.int32)
                 for u in range(2_048)}
    seq, lengths, _ = sessionrec.training_batch(user_seqs, 1_000, 32, 32)
    params = sessionrec.init_params(1_000, 16, 1, 32,
                                    np.random.default_rng(3))
    fits = [session.train_params(params, seq, lengths, 2, 0.05, 5, where)
            for where in (dev, dev, torch.device("cpu"))]
    (a, la), (b, lb), (_, lc) = fits
    np.testing.assert_array_equal(la, lb)
    for name in ("emb", "pos"):
        np.testing.assert_array_equal(a[name], b[name])
    for ba, bb in zip(a["blocks"], b["blocks"]):
        for k in ba:
            np.testing.assert_array_equal(ba[k], bb[k])
    np.testing.assert_allclose(la, lc, rtol=1e-4)
    assert la[-1] < la[0]


def test_folded_session_model_bitwise_batched_vs_single(dev):
    """A SessionRecModel folded by the online session fold serves on the
    card bitwise the same for each folded user alone and in one batch of
    64, and the same as its new window sent as {"items"}; the folded
    model's device copy is the old model's tensors."""
    from datetime import datetime, timedelta, timezone

    from predictionio_torch import convert
    from predictionio_torch.online.session import SessionFold

    rng = np.random.default_rng(4)
    params = sessionrec.init_params(2_000, 16, 1, 32, rng)
    ids = {f"i{k}": k for k in range(2_000)}
    model = convert.session_model_from_arrays(
        params, ids, {f"u{u}": tuple(f"i{k}" for k in
                                     rng.choice(2_000, 5, replace=False))
                      for u in range(200)}, 32, 2)
    model.device = "cuda"
    algo = sessionrec.SessionRecAlgorithm(sessionrec.SessionRecParams())
    before = algo.batch_predict(model, [{"user": "u0", "num": 10}])
    t0 = datetime(2026, 5, 1, tzinfo=timezone.utc)
    hist = {f"u{u}": [(f"i{int(k)}", 1.0, t0 + timedelta(seconds=int(s)))
                      for k, s in zip(rng.integers(0, 2_100, 40),
                                      rng.integers(0, 30, 40))]
            for u in range(100, 164)}
    folded, stats = SessionFold(32).fold(model, hist)
    assert stats.folded_users == 64 and stats.new_items > 0
    assert folded._on_device is not model._on_device
    assert folded.device_params(dev) is model.device_params(dev)
    users = sorted(hist)
    batch = algo.batch_predict(folded, [{"user": u, "num": 10}
                                        for u in users])
    session.reset_launches()
    for u, got in zip(users, batch):
        assert got["itemScores"], u
        assert algo.predict(folded, {"user": u, "num": 10}) == got, u
        window = list(folded.user_windows[u])
        assert algo.predict(folded, {"items": window, "num": 10}) == got, u
    assert session.launches == {"session_encode": 128,
                                "session_readout": 128}
    assert algo.batch_predict(model, [{"user": "u0", "num": 10}]) == before


def test_run_parity_on_card_against_cpu(dev):
    """`run_parity` at `100k` with the port's ALS on the card and on the
    CPU, from the same initial item factors: the same MLlib-faithful side
    and RMSE within rel 2e-3 (the trajectory bar); the card's trains run
    `gj_aug_reg` alone."""
    from predictionio_torch.quality.parity import parity_split, run_parity

    split = parity_split("explicit", "100k", 5)
    init = (np.random.default_rng(5).standard_normal((split.n_items, 8))
            / np.sqrt(8)).astype(np.float32)
    kw = dict(mode="explicit", scale="100k", rank=8, iterations=3, reg=0.1,
              seed=5, split=split, init_item_factors=init)
    card = run_parity(**kw, device=dev)
    launches = {k: v for k, v in spd_solve.launches.items() if v}
    cpu = run_parity(**kw, device="cpu")
    assert card["ref"]["rmse"] == cpu["ref"]["rmse"]
    np.testing.assert_allclose(card["ours"]["rmse"], cpu["ours"]["rmse"],
                               rtol=2e-3)
    assert card["ours"]["device"] == torch.cuda.get_device_name(dev)
    assert list(launches) == ["gj_aug_reg"]
