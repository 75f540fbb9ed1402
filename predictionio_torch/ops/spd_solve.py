"""Batched SPD solve by Gauss-Jordan elimination — the port of
``predictionio_tpu/ops/pallas_solve.py``.

Each ALS half-epoch solves x_r = A_r⁻¹ b_r for thousands of small (K×K,
K = rank) SPD systems. The public surface is the reference's:
`gj_applicable`, `gj_solve(a, b, layout=...)` (``PIO_GJ_LAYOUT`` when
`layout` is not given), `gj_solve_multi` and `schur_solve`.

Layouts:

- ``aug``: row Gauss-Jordan on [A | b]; `auto` picks it below rank 96.
  `aug_kernel` routes by K: ``gj_aug_reg`` at K ≤ 64 (one warp per
  system, rows in registers, one reciprocal per pivot), ``gj_aug_cta`` at
  64 < K ≤ 128 (one thread block per system, a row per thread in
  registers, one barrier a step), ``gj_aug_split`` at 128 < K ≤ 256 (the
  same block design with each row's first K − 128 columns in shared
  memory), ``gj_aug`` above (working copy in shared or device memory; no
  route reaches it, since `gj_applicable` stops at 256).
- ``schur``: recursive Schur complements; the eliminations become f32
  `torch.bmm` products and the base systems (K ≤ 32, or odd K) go to
  `gj_solve_multi`; `auto` picks it at rank ≥ 96. Every rank from 96 to
  256 but the 25 whose halving stays even down to K ≤ 32 (96, 100, ...,
  128 and the multiples of 8 from 136) has base calls above K = 32: odd
  ranks one [R, K, 1] at the full rank, ranks 2·odd and 4·odd also
  [R, K, M] with odd K from 33 to 127 and M from 34 to 190.
  `multi_kernel(k, m)` names the base's kernel: ``gj_aug_multi_reg`` at
  K ≤ 32 (one warp per system and right-hand-side chunk, columns in
  registers), the ``aug`` kernel of K (`aug_kernel`) at K > 32 with one
  right-hand side, ``gj_aug_multi_cta`` at 32 < K ≤ 128 with M > 1 (the
  block kernel with a chunk of B's columns beside each row), and
  ``gj_aug_multi`` (working copy in shared or device memory) at K > 128
  with M > 1, which no rank reaches.
- ``packed``: column Gauss-Jordan on [[A], [bᵀ]] (the b row ends as xᵀ);
  forced only. It is the row elimination of [Aᵀ | b], transposed, so
  `packed_kernel` routes it to the ``aug`` kernels' bodies with A read
  transposed: ``gj_packed_reg`` at K ≤ 64, ``gj_packed_cta`` at
  64 < K ≤ 128, ``gj_packed_split`` at 128 < K ≤ 256, and above that
  ``gj_packed`` (one system a thread block, working copy in shared or
  device memory).
- ``blocked2``: row Gauss-Jordan on [A | b] two pivots per step through
  the 2×2 pivot-block inverse; even K only; forced only. `blocked2_kernel`
  routes it to the ``aug`` kernels' bodies, each taking a pivot pair a
  step: ``gj_blocked2_reg`` at K ≤ 64, ``gj_blocked2_cta`` at
  64 < K ≤ 128, ``gj_blocked2_split`` at 128 < K ≤ 256, and above that
  ``gj_blocked2`` (working copy in shared or device memory; no route).

Dispatch: a tensor on the CPU runs the kernel's plain PyTorch version
(`gj_solve_reg_plain`, `gj_solve_packed_reg_plain`, `gj_solve_cta_plain`,
`gj_solve_pair_plain`, `gj_solve_plain`, `gj_solve_multi_reg_plain`,
`gj_solve_multi_plain`, `gj_solve_packed_plain`,
`gj_solve_blocked2_plain`); a CUDA tensor launches the hand-written
kernel from ``csrc/gj_reg.cu`` (aug, packed and blocked2 at K ≤ 64),
``csrc/gj_cta.cu`` (the three at 64 < K ≤ 256, aug_multi at
32 < K ≤ 128), ``csrc/gj_multi_reg.cu`` (aug_multi at K ≤ 32),
``csrc/gj_solve.cu`` (aug above K = 256, aug_multi above K = 128) or
``csrc/gj_layouts.cu`` (packed and blocked2 above K = 256), or raises.
One plain version, `gj_solve_cta_plain`, serves the five aug, packed and
aug_multi block kernels, and `gj_solve_pair_plain` the three pair
kernels. `launches` counts kernel launches per wrapper.

No pivoting: A = YᵀWY + λ(n)I is SPD. All-zero systems (bucket padding)
solve to exactly 0 through the pivot guard |d| < 1e-30 → 1.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

_MAX_RANK = 256
_REG_MAX_RANK = 64  # largest K the register (warp) kernels take
# largest K the block kernels take with rows in registers, and with each
# row split between shared memory and registers
_CTA_MAX_RANK = 128
_SPLIT_MAX_RANK = 256
_MULTI_REG_MAX_RANK = 32  # largest K the multi-RHS register kernel takes
# the widest chunk of B's columns one warp of gj_aug_multi_reg takes
MULTI_CHUNK = 64
_PIVOT_EPS = 1e-30
# device-memory variant: resident blocks that share the scratch slots
_SCRATCH_SLOTS = 1024

# kernel launches per wrapper (plain ints; the plain versions never count)
launches = {"gj_aug_reg": 0, "gj_aug_cta": 0, "gj_aug_split": 0,
            "gj_aug": 0, "gj_aug_multi_reg": 0, "gj_aug_multi_cta": 0,
            "gj_aug_multi": 0,
            "gj_packed_reg": 0, "gj_packed_cta": 0, "gj_packed_split": 0,
            "gj_packed": 0, "gj_blocked2_reg": 0, "gj_blocked2_cta": 0,
            "gj_blocked2_split": 0, "gj_blocked2": 0}
# the same launches by kernel and rank, keyed "<kernel>/K=<k>"
launches_by_rank: dict[str, int] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    launches_by_rank.clear()


def gj_applicable(rank: int) -> bool:
    return rank <= _MAX_RANK


def _by_rank(k: int, kernel: str) -> str:
    if k <= _REG_MAX_RANK:
        return f"{kernel}_reg"
    if k <= _CTA_MAX_RANK:
        return f"{kernel}_cta"
    return f"{kernel}_split" if k <= _SPLIT_MAX_RANK else kernel


def aug_kernel(k: int) -> str:
    """The kernel the ``aug`` layout runs at rank `k`: the warp kernel up
    to K = 64, the block kernel with rows in registers up to K = 128 and
    with rows split up to K = 256, the shared/device-memory one above."""
    return _by_rank(k, "gj_aug")


def packed_kernel(k: int) -> str:
    """The kernel the ``packed`` layout runs at rank `k`, split by K as
    `aug_kernel`'s."""
    return _by_rank(k, "gj_packed")


def blocked2_kernel(k: int) -> str:
    """The kernel the ``blocked2`` layout runs at (even) rank `k`, split
    by K as `aug_kernel`'s."""
    return _by_rank(k, "gj_blocked2")


def multi_kernel(k: int, m: int) -> str:
    """The kernel `gj_solve_multi` runs at rank `k` with `m` right-hand
    sides: the multi-RHS register kernel up to K = 32; above, the ``aug``
    kernel of K for one right-hand side, the multi-RHS block kernel up to
    K = 128 and the shared/device-memory one (no route) for more."""
    if k <= _MULTI_REG_MAX_RANK:
        return "gj_aug_multi_reg"
    if m == 1:
        return aug_kernel(k)
    return "gj_aug_multi_cta" if k <= _CTA_MAX_RANK else "gj_aug_multi"


def reg_padded_rank(k: int) -> int:
    """The register kernels' padded size KP ∈ {16, 32, 64} for K ≤ 64."""
    if not 1 <= k <= _REG_MAX_RANK:
        raise ValueError(f"the register kernel takes 1 ≤ K ≤ "
                         f"{_REG_MAX_RANK}, got {k}")
    return 16 if k <= 16 else 32 if k <= 32 else 64


# -- plain versions ---------------------------------------------------------

def _gj_plain(work: torch.Tensor, k: int) -> torch.Tensor:
    """Row Gauss-Jordan on [R, K, W] augmented blocks, the kernel's
    arithmetic step for step; returns the reduced blocks."""
    work = work.clone()
    for p in range(k):
        d = work[:, p, p]
        d = torch.where(d.abs() < _PIVOT_EPS, torch.ones_like(d), d)
        row = work[:, p, :] / d[:, None]
        col = work[:, :, p].clone()
        col[:, p] = 0.0
        work -= col[:, :, None] * row[:, None, :]
        work[:, p, :] = row
    return work


def gj_solve_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [R, K] = A⁻¹ b for a [R, K, K], b [R, K] (plain PyTorch)."""
    k = a.shape[1]
    work = torch.cat([a.float(), b.float()[..., None]], dim=-1)
    return _gj_plain(work, k)[:, :, k]


def _gj_reg_plain(a: torch.Tensor, b: torch.Tensor, kp: int) -> torch.Tensor:
    """X [R, K, M] = A⁻¹ B, the register kernels' arithmetic step for step:
    [A | B] zero-padded to [KP, KP + M], K steps, the pivot row scaled by
    one reciprocal 1/d, and only the columns right of the pivot updated."""
    r, k = a.shape[0], a.shape[1]
    work = a.new_zeros((r, kp, kp + b.shape[2]), dtype=torch.float32)
    work[:, :k, :k] = a
    work[:, :k, kp:] = b
    for p in range(k):
        d = work[:, p, p]
        d = torch.where(d.abs() < _PIVOT_EPS, torch.ones_like(d), d)
        row = work[:, p, p + 1:] * torch.reciprocal(d)[:, None]
        col = work[:, :, p].clone()
        col[:, p] = 0.0
        work[:, :, p + 1:] -= col[:, :, None] * row[:, None, :]
        work[:, p, p + 1:] = row
    return work[:, :k, kp:]


def gj_solve_reg_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [R, K] = A⁻¹ b for a [R, K, K], b [R, K], K ≤ 64 (plain PyTorch),
    the arithmetic of ``gj_aug_reg``."""
    kp = reg_padded_rank(a.shape[1])
    return _gj_reg_plain(a, b[..., None], kp)[..., 0]


def gj_solve_packed_reg_plain(a: torch.Tensor,
                              b: torch.Tensor) -> torch.Tensor:
    """x [R, K] for a [R, K, K], b [R, K], K ≤ 64 (plain PyTorch), the
    arithmetic of ``gj_packed_reg``: ``gj_aug_reg``'s on [Aᵀ | b]. Like
    the reference's packed kernel it solves Aᵀx = b (the same x for a
    symmetric A)."""
    k = a.shape[1]
    return _gj_reg_plain(a.transpose(1, 2), b[..., None],
                         reg_padded_rank(k))[..., 0]


def gj_solve_cta_plain(a: torch.Tensor, b: torch.Tensor,
                       transpose: bool = False) -> torch.Tensor:
    """x [R, K] for a [R, K, K], b [R, K], or X [R, K, M] = A⁻¹B for
    b [R, K, M], K ≤ 256 (plain PyTorch), the arithmetic of the five block
    kernels: ``gj_aug_cta`` (K ≤ 128) and ``gj_aug_split``
    (128 < K ≤ 256), ``gj_aug_multi_cta`` (b [R, K, M], K ≤ 128), and with
    `transpose`, which eliminates [Aᵀ | b] and so solves Aᵀx = b,
    ``gj_packed_cta`` and ``gj_packed_split``. Step for step: the pivot
    row is not scaled; every other row subtracts m·(pivot row) right of
    the pivot with m = c · (1/d), and X_ij = B_ij · (1/d_i) at the end.
    Where a row lies (registers, or split with shared memory) and how B's
    columns are chunked change none of it: each column of X depends on A
    and its own column of B alone."""
    k = a.shape[1]
    if k > _SPLIT_MAX_RANK:
        raise ValueError(f"the block kernels take K ≤ {_SPLIT_MAX_RANK}, "
                         f"got {k}")
    if transpose:
        a = a.transpose(1, 2)
    single = b.dim() == 2
    work = torch.cat([a.float(), (b[..., None] if single else b).float()],
                     dim=-1)
    inv = torch.empty_like(work[:, :, 0])
    for p in range(k):
        d = work[:, p, p]
        d = torch.where(d.abs() < _PIVOT_EPS, torch.ones_like(d), d)
        inv[:, p] = torch.reciprocal(d)
        m = work[:, :, p] * inv[:, p, None]
        m[:, p] = 0.0
        work[:, :, p + 1:] -= m[:, :, None] * work[:, p, None, p + 1:]
    x = work[:, :, k:] * inv[:, :, None]
    return x[..., 0] if single else x


def gj_solve_multi_reg_plain(a: torch.Tensor,
                             b: torch.Tensor) -> torch.Tensor:
    """X [R, K, M] = A⁻¹ B for a [R, K, K], b [R, K, M], K ≤ 32 (plain
    PyTorch), the arithmetic of ``gj_aug_multi_reg``: its chunking of B's
    columns changes no value, so one block [A | B] stands for every
    chunk."""
    if a.shape[1] > _MULTI_REG_MAX_RANK:
        raise ValueError(f"the multi-RHS register kernel takes K ≤ "
                         f"{_MULTI_REG_MAX_RANK}, got {a.shape[1]}")
    return _gj_reg_plain(a, b, reg_padded_rank(a.shape[1]))


def gj_solve_multi_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X [R, K, M] = A⁻¹ B for a [R, K, K], b [R, K, M] (plain PyTorch)."""
    k = a.shape[1]
    work = torch.cat([a.float(), b.float()], dim=-1)
    return _gj_plain(work, k)[:, :, k:]


def gj_solve_packed_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [R, K] by column Gauss-Jordan on M = [[A], [bᵀ]] (plain PyTorch),
    the packed kernel's arithmetic step for step. M's rows are A's rows as
    they lie, so step j reads A's column j: for an A that is not bitwise
    symmetric this solves Aᵀx = b, as the reference's packed kernel does."""
    k = a.shape[1]
    m = torch.cat([a.float(), b.float()[:, None, :]], dim=1)  # [R, K+1, K]
    for j in range(k):
        f = m[:, j, :]  # pivot row
        d = f[:, j]
        d = torch.where(d.abs() < _PIVOT_EPS, torch.ones_like(d), d)
        pn = m[:, :, j] / d[:, None]  # pivot column, normalised
        m = m - pn[:, :, None] * f[:, None, :]
        m[:, :, j] = pn
    return m[:, k, :]


def gj_solve_blocked2_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [R, K] by row Gauss-Jordan on [A | b] two pivots per step through
    the explicit 2×2 pivot-block inverse (plain PyTorch), the blocked2
    kernel's arithmetic step for step. K must be even."""
    k = a.shape[1]
    if k % 2:
        raise ValueError(f"layout='blocked2' needs even rank, got {k}")
    w = torch.cat([a.float(), b.float()[..., None]], dim=-1)  # [R, K, K+1]
    for j0 in range(0, k, 2):
        j1 = j0 + 1
        row0, row1 = w[:, j0, :], w[:, j1, :]
        p00, p01 = row0[:, j0:j0 + 1], row0[:, j1:j1 + 1]
        p10, p11 = row1[:, j0:j0 + 1], row1[:, j1:j1 + 1]
        det = p00 * p11 - p01 * p10
        det = torch.where(det.abs() < _PIVOT_EPS, torch.ones_like(det), det)
        n0 = (p11 * row0 - p01 * row1) / det
        n1 = (p00 * row1 - p10 * row0) / det
        col0 = w[:, :, j0].clone()
        col1 = w[:, :, j1].clone()
        col0[:, j0:j1 + 1] = 0.0
        col1[:, j0:j1 + 1] = 0.0
        w = (w - col0[:, :, None] * n0[:, None, :]
             - col1[:, :, None] * n1[:, None, :])
        w[:, j0, :] = n0
        w[:, j1, :] = n1
    return w[:, :, k]


def gj_solve_pair_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [R, K] = A⁻¹ b for a [R, K, K], b [R, K], even K ≤ 256 (plain
    PyTorch), the arithmetic of the three pair kernels, ``gj_blocked2_reg``,
    ``gj_blocked2_cta`` and ``gj_blocked2_split``: row Gauss-Jordan on
    [A | b], pair step p = 0, 2, ... taking pivots p, p + 1. Step for step:
    the pivot block P is guarded (|det| < 1e-30 → 1) and inverted through
    rdet = 1/det; every other row takes [m0 m1] = [c0 c1]·P⁻¹ from its
    columns p, p + 1 and subtracts m0·(row p) + m1·(row p + 1) right of
    p + 1; the pivot rows stay, and x_p, x_p+1 = P⁻¹·(b_p, b_p+1) at the
    end. Where a row lies changes none of it."""
    r, k = a.shape[0], a.shape[1]
    if k % 2:
        raise ValueError(f"layout='blocked2' needs even rank, got {k}")
    if k > _SPLIT_MAX_RANK:
        raise ValueError(f"the pair kernels take K ≤ {_SPLIT_MAX_RANK}, "
                         f"got {k}")
    work = torch.cat([a.float(), b.float()[..., None]], dim=-1)
    inv = torch.empty((r, k, 2), dtype=torch.float32, device=a.device)
    for p in range(0, k, 2):
        p00, p01 = work[:, p, p], work[:, p, p + 1]
        p10, p11 = work[:, p + 1, p], work[:, p + 1, p + 1]
        det = p00 * p11 - p01 * p10
        det = torch.where(det.abs() < _PIVOT_EPS, torch.ones_like(det), det)
        rdet = torch.reciprocal(det)
        c0, c1 = work[:, :, p], work[:, :, p + 1]
        m0 = (c0 * p11[:, None] - c1 * p10[:, None]) * rdet[:, None]
        m1 = (c1 * p00[:, None] - c0 * p01[:, None]) * rdet[:, None]
        m0[:, p:p + 2] = 0.0
        m1[:, p:p + 2] = 0.0
        inv[:, p] = torch.stack([p11 * rdet, -p01 * rdet], dim=1)
        inv[:, p + 1] = torch.stack([-p10 * rdet, p00 * rdet], dim=1)
        work[:, :, p + 2:] -= (m0[:, :, None] * work[:, p, None, p + 2:]
                               + m1[:, :, None] * work[:, p + 1, None, p + 2:])
    bp = work[:, :, k].reshape(r, k // 2, 1, 2)  # (b_p, b_p+1) of each pair
    inv = inv.reshape(r, k // 2, 2, 2)
    return (inv[..., 0] * bp[..., 0] + inv[..., 1] * bp[..., 1]).reshape(r, k)


# -- the CUDA kernels -------------------------------------------------------

# kernel → its source under csrc/
_SOURCE = {"gj_aug_reg": "gj_reg", "gj_packed_reg": "gj_reg",
           "gj_aug_cta": "gj_cta", "gj_packed_cta": "gj_cta",
           "gj_aug_split": "gj_cta", "gj_packed_split": "gj_cta",
           "gj_aug": "gj_solve", "gj_aug_multi_reg": "gj_multi_reg",
           "gj_aug_multi_cta": "gj_cta", "gj_aug_multi": "gj_solve",
           "gj_packed": "gj_layouts",
           "gj_blocked2_reg": "gj_reg", "gj_blocked2_cta": "gj_cta",
           "gj_blocked2_split": "gj_cta", "gj_blocked2": "gj_layouts"}
# the ranks (least, largest) each register or block kernel takes
_KERNEL_RANKS = {"gj_aug_reg": (1, _REG_MAX_RANK),
                 "gj_packed_reg": (1, _REG_MAX_RANK),
                 "gj_aug_cta": (1, _CTA_MAX_RANK),
                 "gj_packed_cta": (1, _CTA_MAX_RANK),
                 "gj_aug_split": (_CTA_MAX_RANK + 1, _SPLIT_MAX_RANK),
                 "gj_packed_split": (_CTA_MAX_RANK + 1, _SPLIT_MAX_RANK),
                 "gj_blocked2_reg": (1, _REG_MAX_RANK),
                 "gj_blocked2_cta": (1, _CTA_MAX_RANK),
                 "gj_blocked2_split": (_CTA_MAX_RANK + 1, _SPLIT_MAX_RANK),
                 "gj_aug_multi_reg": (1, _MULTI_REG_MAX_RANK),
                 "gj_aug_multi_cta": (1, _CTA_MAX_RANK)}
# the kernels with one right-hand side and the signature of gj_aug_reg
_ONE_RHS = ("gj_aug_reg", "gj_packed_reg", "gj_aug_cta", "gj_packed_cta",
            "gj_aug_split", "gj_packed_split", "gj_blocked2_reg",
            "gj_blocked2_cta", "gj_blocked2_split")
# the split kernels' layout index in gj_split_occupancy
_SPLIT_LAYOUT = {"gj_aug_split": 0, "gj_packed_split": 1,
                 "gj_blocked2_split": 2}
_max_shared: dict[int, int] = {}


def _bind(lib, source: str) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    if source == "gj_solve":
        lib.gj_max_shared_bytes.argtypes = [i32]
        lib.gj_max_shared_bytes.restype = i32
        lib.gj_aug.argtypes = [p, i64, i64, i64, p, i64, i64, p, p, i64,
                               i32, i32, p]
        lib.gj_aug_multi.argtypes = [p, i64, i64, i64, p, i64, i64, i64, p,
                                     p, i64, i32, i32, i32, p]
        fns = (lib.gj_aug, lib.gj_aug_multi)
    elif source in ("gj_reg", "gj_cta"):
        fns = ((lib.gj_aug_reg, lib.gj_packed_reg, lib.gj_blocked2_reg)
               if source == "gj_reg"
               else (lib.gj_aug_cta, lib.gj_packed_cta, lib.gj_aug_split,
                     lib.gj_packed_split, lib.gj_blocked2_cta,
                     lib.gj_blocked2_split))
        for fn in fns:
            fn.argtypes = [p, i64, i64, i64, p, i64, i64, p, i64, i32, p]
        if source == "gj_cta":
            lib.gj_aug_multi_cta.argtypes = [p, i64, i64, i64, p, i64, i64,
                                             i64, p, i64, i32, i32, p]
            lib.gj_split_occupancy.argtypes = [i32, i32, p, p]
            fns += (lib.gj_aug_multi_cta, lib.gj_split_occupancy)
    elif source == "gj_multi_reg":
        lib.gj_aug_multi_reg.argtypes = [p, i64, i64, i64, p, i64, i64, i64,
                                         p, i64, i32, i32, i32, p]
        fns = (lib.gj_aug_multi_reg,)
    else:
        fns = (lib.gj_packed, lib.gj_blocked2)
        for fn in fns:
            fn.argtypes = [p, i64, i64, i64, p, i64, i64, p, p, i64, i32,
                           i32, p]
    for fn in fns:
        fn.restype = i32


def _lib(source: str = "gj_solve"):
    from predictionio_torch.ops import _build

    lib = _build.load(source)
    if not getattr(lib, "_pio_bound", False):
        _bind(lib, source)
        lib._pio_bound = True
    return lib


def _block_floats(name: str, k: int, m: int) -> tuple[int, int]:
    """(working-copy floats, pivot row + column floats) of one block."""
    if name == "gj_packed":
        return (k + 1) * k, 2 * k + 1
    if name == "gj_blocked2":
        return k * (k + 1), 2 * (k + 1) + 2 * k
    return k * (k + m), 2 * k + m


def shared_fits(k: int, m: int, device: torch.device,
                name: str = "gj_aug") -> bool:
    """Whether one block of kernel `name` keeps its working copy in shared
    memory on `device`; otherwise its device-memory variant runs."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _max_shared:
        _max_shared[idx] = _lib().gj_max_shared_bytes(idx)
    return sum(_block_floats(name, k, m)) * 4 <= _max_shared[idx]


def split_occupancy(name: str, k: int, device: torch.device) -> tuple[int, int]:
    """(dynamic shared bytes of one block, blocks an SM holds at once) of
    split kernel `name` at rank `k` on `device`, as the CUDA runtime
    reckons them."""
    shared, blocks = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _lib("gj_cta").gj_split_occupancy(
            _SPLIT_LAYOUT[name], k, ctypes.byref(shared),
            ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"{name} occupancy at K={k}: CUDA error {err}")
    return shared.value, blocks.value


def _launch(name: str, a: torch.Tensor, b: torch.Tensor,
            chunk: int = MULTI_CHUNK) -> torch.Tensor:
    """Launch `name` on CUDA tensors a [R, K, K] and b [R, K, M] (any
    strides; M = 1 but for the aug_multi kernels); returns X [R, K, M].
    `chunk` (32 or 64) is gj_aug_multi_reg's widest chunk of B's columns
    a warp takes; X does not depend on it."""
    r, k, k2 = a.shape
    if k2 != k or b.dim() != 3 or b.shape[:2] != (r, k):
        raise ValueError(f"{name}: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} are not [R, K, K] and [R, K, M]")
    m = b.shape[2]
    if name in (*_ONE_RHS, "gj_packed", "gj_blocked2") and m != 1:
        raise ValueError(f"{name}: takes one right-hand side, got M={m}")
    lo, hi = _KERNEL_RANKS.get(name, (1, k))
    if not lo <= k <= hi:
        raise ValueError(f"{name}: takes {f'{lo} ≤ ' if lo > 1 else ''}"
                         f"K ≤ {hi}, got {k}")
    if name.startswith("gj_blocked2") and k % 2:
        raise ValueError(f"{name}: needs even rank, got {k}")
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{name}: a and b must be on one CUDA device, got "
                         f"{a.device} and {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"{name}: needs float32, got {a.dtype}/{b.dtype}")
    x = torch.empty((r, k, m), dtype=torch.float32, device=a.device)
    if r == 0 or m == 0:
        return x
    lib = _lib(_SOURCE[name])
    scratch = None
    grid = 0
    if name not in _KERNEL_RANKS and \
            not shared_fits(k, m, a.device, name):
        grid = min(r, _SCRATCH_SLOTS)
        scratch = torch.empty(grid * _block_floats(name, k, m)[0],
                              dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    sp = None if scratch is None else scratch.data_ptr()
    ab = (a.data_ptr(), *a.stride(), b.data_ptr())
    if name in _ONE_RHS:
        err = getattr(lib, name)(*ab, b.stride(0), b.stride(1), x.data_ptr(),
                                 r, k, stream)
    elif name == "gj_aug_multi_reg":
        err = lib.gj_aug_multi_reg(*ab, *b.stride(), x.data_ptr(), r, k, m,
                                   chunk, stream)
    elif name == "gj_aug_multi_cta":
        err = lib.gj_aug_multi_cta(*ab, *b.stride(), x.data_ptr(), r, k, m,
                                   stream)
    elif name == "gj_aug_multi":
        err = lib.gj_aug_multi(*ab, *b.stride(), x.data_ptr(), sp, r, k, m,
                               grid, stream)
    else:  # gj_aug, gj_packed, gj_blocked2
        err = getattr(lib, name)(*ab, b.stride(0), b.stride(1),
                                 x.data_ptr(), sp, r, k, grid, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"(R={r}, K={k}, M={m})")
    launches[name] += 1
    key = f"{name}/K={k}"
    launches_by_rank[key] = launches_by_rank.get(key, 0) + 1
    return x


# -- public surface ---------------------------------------------------------

def _solve_one(name: str, plain, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """x [R, K]: `plain` on CPU tensors, kernel `name` on CUDA tensors."""
    if a.device.type == "cpu":
        return plain(a, b)
    return _launch(name, a.float(), b.float()[..., None])[..., 0]


def _aug_plain(name: str):
    """The plain version of the ``aug`` kernel `name` (x [R, K] from
    a [R, K, K], b [R, K])."""
    return {"gj_aug_reg": gj_solve_reg_plain,
            "gj_aug_cta": gj_solve_cta_plain,
            "gj_aug_split": gj_solve_cta_plain,
            "gj_aug": gj_solve_plain}[name]


def gj_solve_multi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X = A⁻¹ B for a batch of SPD systems with M right-hand sides.

    a: [R, K, K]; b: [R, K, M] → X: [R, K, M] f32. The base call of
    `schur_solve`'s recursion; `multi_kernel` names the kernel (on CPU
    tensors, its plain version)."""
    name = multi_kernel(a.shape[1], b.shape[2])
    if a.device.type == "cpu":
        multi = {"gj_aug_multi_reg": gj_solve_multi_reg_plain,
                 "gj_aug_multi_cta": gj_solve_cta_plain,
                 "gj_aug_multi": gj_solve_multi_plain}
        if name in multi:
            return multi[name](a, b)
        return _aug_plain(name)(a, b[..., 0])[..., None]
    return _launch(name, a.float(), b.float())


def schur_solve(a: torch.Tensor, b: torch.Tensor,
                base: int = 32) -> torch.Tensor:
    """x = A⁻¹ b via recursive Schur complements: the elimination work
    becomes [R, K/2, K/2] f32 batched products plus multi-RHS GJ solves at
    the `base` size. For SPD A every split pivot block is SPD, so no level
    needs pivoting.

    a: [R, K, K] SPD; b: [R, K] or [R, K, M]."""
    single = b.dim() == 2
    if single:
        b = b[..., None]
    x = _schur_rec(a.float(), b.float(), base)
    return x[..., 0] if single else x


def _schur_rec(a: torch.Tensor, b: torch.Tensor, base: int) -> torch.Tensor:
    k = a.shape[1]
    if k <= base or k % 2:
        return gj_solve_multi(a, b)
    h = k // 2
    a12 = a[:, :h, h:]
    a21 = a[:, h:, :h]
    b1, b2 = b[:, :h], b[:, h:]
    # one base call solves A11 against [A12 | B1] together
    w = _schur_rec(a[:, :h, :h], torch.cat([a12, b1], dim=2), base)
    w12, w1b = w[:, :, :h], w[:, :, h:]
    s = a[:, h:, h:] - torch.bmm(a21, w12)  # SPD Schur complement
    y2 = _schur_rec(s, b2 - torch.bmm(a21, w1b), base)
    y1 = w1b - torch.bmm(w12, y2)
    return torch.cat([y1, y2], dim=1)


def gj_solve(a: torch.Tensor, b: torch.Tensor, layout: str = "") -> torch.Tensor:
    """Solve x = A⁻¹ b for a batch of SPD systems.

    a: [R, K, K] (all-zero systems yield x = 0); b: [R, K].
    layout: "auto" (default) picks "schur" at rank ≥ 96 and "aug" below;
    "aug", "packed", "blocked2" and "schur" force a layout;
    ``PIO_GJ_LAYOUT`` applies when `layout` is empty. Returns x [R, K]
    f32."""
    layout = layout or os.environ.get("PIO_GJ_LAYOUT", "auto")
    k = a.shape[1]
    if layout == "auto":
        layout = "schur" if k >= 96 else "aug"
    if layout == "schur":
        return schur_solve(a, b)
    if layout == "packed":
        name = packed_kernel(k)
        block = functools.partial(gj_solve_cta_plain, transpose=True)
        plain = {"gj_packed_reg": gj_solve_packed_reg_plain,
                 "gj_packed_cta": block, "gj_packed_split": block,
                 "gj_packed": gj_solve_packed_plain}[name]
        return _solve_one(name, plain, a, b)
    if layout == "blocked2":
        if k % 2:
            raise ValueError(f"layout='blocked2' needs even rank, got {k}")
        name = blocked2_kernel(k)
        plain = (gj_solve_blocked2_plain if name == "gj_blocked2"
                 else gj_solve_pair_plain)
        return _solve_one(name, plain, a, b)
    if layout != "aug":
        raise ValueError(f"unknown gj_solve layout {layout!r} "
                         "(want auto/aug/packed/blocked2/schur)")
    name = aug_kernel(k)
    return _solve_one(name, _aug_plain(name), a, b)
