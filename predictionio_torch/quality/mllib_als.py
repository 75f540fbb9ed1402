"""MLlib-semantics-faithful CPU reference ALS — own copy of the JAX
package's ``quality/mllib_als.py``.

This is the *independent cross-check* for the port's `ops/als.py`: a
from-scratch numpy implementation of the math Spark MLlib's ALS runs
(«org.apache.spark.ml.recommendation.ALS» / «mllib.recommendation.ALS.
train / trainImplicit»). It deliberately shares no code with the port's
ALS (no bucketing, no torch), so agreement between the two on held-out
metrics is evidence about the math, not about shared bugs.

Faithful MLlib semantics implemented here:

- **Init**: each factor row is an i.i.d. gaussian vector normalized to
  unit L2 norm («ALS.initialize»: `nextGaussian` then `sscal(1/nrm)`),
  float32 storage.
- **Update order**: item factors are recomputed from user factors first,
  then user factors from the new item factors («ALS.train»'s iteration
  body), so iteration 1's user solve already sees solved item factors.
- **Explicit** (ALS-WR): for each row r with rated columns C and values v,
    A = Σ_{c∈C} y_c y_cᵀ + λ·|C|·I,   b = Σ v_c y_c,
  i.e. the regularizer is scaled by the row's rating count
  («NormalEquationSolver.solve(ne, numExplicits * regParam)»).
- **Implicit** (Hu-Koren-Volinsky): confidence c₁ = α·|v|, preference 1
  for v>0:
    A = YᵀY + Σ c₁ y yᵀ + λ·n⁺·I,   b = Σ (1 + c₁) y,
  with YᵀY the full Gram of the opposing factors and n⁺ the count of
  positive ratings («ALS.computeFactors» implicit branch: `ne.add(y,
  (c1+1)/c1, c1)` ⇒ ata += c₁·yyᵀ, atb += (1+c₁)·y).
- **Accumulation** in float64 (MLlib's NormalEquation uses doubles),
  factors stored float32; SPD solve via Cholesky.

Rows absent from the data keep their init factors (MLlib never ships them
a block, so they are never updated).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class MLlibALSResult:
    user_factors: np.ndarray  # [n_users, K] float32
    item_factors: np.ndarray  # [n_items, K] float32
    epoch_times: list[float]


def _init_factors(n: int, rank: int, rng: np.random.Generator) -> np.ndarray:
    """MLlib's init: gaussian rows normalized to unit L2 norm, float32."""
    f = rng.standard_normal((n, rank)).astype(np.float32)
    nrm = np.linalg.norm(f, axis=1, keepdims=True)
    return f / np.maximum(nrm, 1e-12)


def _csr(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n_rows: int):
    """Group COO triplets by row: (indptr, cols_sorted, vals_sorted)."""
    order = np.argsort(rows, kind="stable")
    counts = np.bincount(rows, minlength=n_rows)
    indptr = np.concatenate(([0], np.cumsum(counts)))
    return indptr, cols[order], vals[order]


def _solve_side(
    Y: np.ndarray,  # opposing factors [m, K] float32
    indptr: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    X_prev: np.ndarray,  # [n, K] — rows with no data keep these
    reg: float,
    implicit: bool,
    alpha: float,
) -> np.ndarray:
    n = len(indptr) - 1
    k = Y.shape[1]
    Y64 = Y.astype(np.float64)
    YtY = Y64.T @ Y64 if implicit else None
    X = X_prev.copy()
    eye = np.eye(k)
    # batch the k×k solves: python-loop the per-row Gram accumulation
    # (BLAS gemms dominate), then one vectorized solve per chunk
    CH = 1024
    for s in range(0, n, CH):
        e = min(n, s + CH)
        live = np.nonzero(indptr[s + 1 : e + 1] - indptr[s:e])[0]
        if live.size == 0:
            continue
        A = np.empty((live.size, k, k))
        b = np.empty((live.size, k))
        for j, off in enumerate(live):
            r = s + off
            sl = slice(indptr[r], indptr[r + 1])
            Yr = Y64[cols[sl]]
            v = vals[sl].astype(np.float64)
            if implicit:
                c1 = alpha * np.abs(v)
                A[j] = YtY + (Yr * c1[:, None]).T @ Yr
                # preference is 1 only for v>0 («ne.add(y, 0.0, c1)» for
                # non-positive ratings: ata gets c1·yyᵀ, atb gets nothing)
                b[j] = ((1.0 + c1) * (v > 0)) @ Yr
                n_pos = int((v > 0).sum())
            else:
                A[j] = Yr.T @ Yr
                b[j] = v @ Yr
                n_pos = len(v)
            A[j] += (reg * n_pos) * eye
        X[s + live] = np.linalg.solve(A, b[..., None])[..., 0].astype(np.float32)
    return X


def mllib_als_train(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    ratings: np.ndarray,
    n_users: int,
    n_items: int,
    rank: int,
    iterations: int = 10,
    reg: float = 0.1,
    implicit: bool = False,
    alpha: float = 1.0,
    seed: int = 0,
) -> MLlibALSResult:
    """Train ALS with MLlib's exact semantics on CPU. See module docstring."""
    user_idx = np.asarray(user_idx, np.int32)
    item_idx = np.asarray(item_idx, np.int32)
    ratings = np.asarray(ratings, np.float32)
    rng = np.random.default_rng(seed)
    uf = _init_factors(n_users, rank, rng)
    itf = _init_factors(n_items, rank, rng)

    u_indptr, u_cols, u_vals = _csr(user_idx, item_idx, ratings, n_users)
    i_indptr, i_cols, i_vals = _csr(item_idx, user_idx, ratings, n_items)

    times = []
    for _ in range(iterations):
        t0 = time.perf_counter()
        # MLlib order: items from users, then users from the new items
        itf = _solve_side(uf, i_indptr, i_cols, i_vals, itf, reg,
                          implicit, alpha)
        uf = _solve_side(itf, u_indptr, u_cols, u_vals, uf, reg,
                         implicit, alpha)
        times.append(time.perf_counter() - t0)
    return MLlibALSResult(uf, itf, times)


def solve_one_row(
    Y: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    reg: float,
    implicit: bool = False,
    alpha: float = 1.0,
) -> np.ndarray:
    """Solve a single row's normal equations (unit-testable building block;
    same math as `_solve_side` via an independent Cholesky factorization
    instead of the batched LU `np.linalg.solve` path)."""
    Y64 = Y.astype(np.float64)
    Yr = Y64[cols]
    v = np.asarray(vals, np.float64)
    k = Y.shape[1]
    if implicit:
        c1 = alpha * np.abs(v)
        A = Y64.T @ Y64 + (Yr * c1[:, None]).T @ Yr
        b = ((1.0 + c1) * (v > 0)) @ Yr
        n_pos = int((v > 0).sum())
    else:
        A = Yr.T @ Yr
        b = v @ Yr
        n_pos = len(v)
    A += (reg * n_pos) * np.eye(k)
    L = np.linalg.cholesky(A)
    y = np.linalg.solve(L, b)
    return np.linalg.solve(L.T, y).astype(np.float32)
