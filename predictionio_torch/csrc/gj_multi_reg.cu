// Batched Gauss-Jordan solve of small SPD systems with many right-hand
// sides, X = A^-1 B, K <= 32, any M, with the working copy in registers,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel _build_solver_aug_multi of
// predictionio_tpu/ops/pallas_solve.py:296 (reached through gj_solve_multi
// :341) where the Schur recursion ends at K <= 32: every base call of the
// 25 ranks from 96 to 256 whose halving stays even down to K <= 32 (96,
// 100, ..., 128 and the multiples of 8 from 136; rank 128: [R, 32, M],
// M in {97, 65, 33, 1}; rank 96: K = 24; rank 200: K = 25; rank 256: M up
// to 225). The recursion stops at every odd K too, so the other 136 of
// those 161 ranks end above K = 32 (rank 98 -> [R, 49, 50] and
// [R, 49, 1]): the aug kernels take those calls with one right-hand side,
// gj_cta.cu's gj_aug_multi_cta those with more; ops/spd_solve.py routes.
//
// What holds gj_aug_multi back: one thread block per system keeps the
// [K][K+M] working copy in shared memory and rewrites every element in
// each of the K steps, the dead columns at or left of the pivot included,
// with two block barriers a step. That is 4 shared-memory accesses of 4 B
// per element per step: 32 * 129 * 32 * 16 B = 2.1 MB per system at
// K = 32, M = 97, ~29 GB for 13 850 systems, ~1 ms of shared-memory
// bandwidth alone. What the card bounds this solve by is bytes: one
// system reads (K^2 + K*M)*4 bytes and writes K*M*4, (K^2 + 2KM)*4 in all,
// against the K^3/3 + 2K^2*M FP32 operations of a Cholesky solve, ~7 per
// byte at K = 32, M = 97, under the H100's ridge of 20 (67 TFLOP/s over
// 3.35 TB/s).
//
// Design: one warp per (system, right-hand-side chunk). B's M columns are
// split into nq = ceil(M / MC) near-equal chunks (MC, the widest chunk, is
// chosen by the caller: 32 or 64). Lane j holds, in registers, column j of
// A (KP rows) and columns j, j + 32, ... of its chunk of B (NB = 1 or 2
// of them, a template parameter): KP * (1 + NB) floats, whatever M is.
// KP in {16, 32} is a template parameter with K <= KP at run time; rows
// and columns K..KP-1 are zero and steps p >= K are skipped by a branch
// uniform across the warp, so the padding changes no result. Every chunk's
// warp carries A's columns and repeats A's elimination (~K^2/2 FMAs a
// step, small next to the chunk's K*MC): a column of X then depends on
// nothing but A and its own column of B, so a system's X is bitwise the
// same whatever R, MC and the other systems of the launch are, and a
// small bucket gets nq warps per system instead of one.
//
// Step p: lane p holds the pivot column. Its K entries are broadcast with
// __shfl_sync, one a row: d = W[p][p] first, guarded |d| < 1e-30 -> 1 (so
// an all-zero padding system solves to exactly 0); each lane scales its
// own row-p entries by one IEEE reciprocal __frcp_rn(d) (each within an
// ulp of row / d), and for every other row i subtracts c_i times them
// with one fused multiply-add, c_i = W[i][p] read before the step. That is
// K shuffles a step whatever the chunk width; owning rows instead would
// broadcast the pivot row, K + MC - 1 - p shuffles a step. A's columns at
// or left of the pivot are never read again and are not updated (lane p,
// the shuffles' source, keeps its column as it was). Every register array
// is indexed by unrolled loop counters only, so the copy stays in
// registers (ptxas: 0-byte stack frame, 0 spills). No shared memory and
// no barrier.
//
// A and B are read from device memory once per warp, row by row: lane j
// reads element (i, j), so where rows are contiguous (stride 1 along a
// row, as for the recursion's views a[:, :h, :h] and its torch.cat
// results) each row is one coalesced load, and no staging tile is needed.
// Other strides are taken too, uncoalesced. Only X is written, row by
// row, coalesced.
//
// Built without --use_fast_math: the reciprocal is __frcp_rn (IEEE, round
// to nearest), which keeps the 1e-4 bars and the exact zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kPivotEps = 1e-30f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarps = 4;  // warps per block

template <int KP, int NB>
__global__ void __launch_bounds__(kWarps * 32)
gj_multi_reg_kernel(const float* __restrict__ a, int64_t sa0, int64_t sa1,
                    int64_t sa2, const float* __restrict__ b, int64_t sb0,
                    int64_t sb1, int64_t sb2, float* __restrict__ x,
                    int64_t r_total, int k, int m, int nq) {
  const int lane = threadIdx.x % 32;
  const int64_t g = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  const int64_t sys = g / nq;
  if (sys >= r_total) return;  // uniform: a warp holds one system
  const int q = (int)(g - sys * nq);
  // near-equal chunks: the first m % nq take one column more
  const int base = m / nq, extra = m % nq;
  const int width = base + (q < extra ? 1 : 0);
  const int c0 = q * base + (q < extra ? q : extra);

  float wa[KP];      // column `lane` of A, zero past K
  float wb[NB][KP];  // columns lane + 32 t of the chunk of B, zero past K
  {
    const bool live = lane < k;
    const float* as = a + sys * sa0 + (live ? lane : 0) * sa2;
#pragma unroll
    for (int i = 0; i < KP; ++i)
      wa[i] = live && i < k ? __ldg(as + i * sa1) : 0.0f;
#pragma unroll
    for (int t = 0; t < NB; ++t) {
      const int col = lane + 32 * t;
      const bool bl = col < width;
      const float* bs = b + sys * sb0 + (bl ? c0 + col : 0) * sb2;
#pragma unroll
      for (int i = 0; i < KP; ++i)
        wb[t][i] = bl && i < k ? __ldg(bs + i * sb1) : 0.0f;
    }
  }

#pragma unroll
  for (int p = 0; p < KP; ++p) {
    if (p >= k) break;  // uniform: k is the same for every lane
    float d = __shfl_sync(kFullMask, wa[p], p);
    if (fabsf(d) < kPivotEps) d = 1.0f;
    const float inv = __frcp_rn(d);
    const bool right = lane > p;  // A's column is read again
    const float ra = wa[p] * inv;
    float rb[NB];
#pragma unroll
    for (int t = 0; t < NB; ++t) rb[t] = wb[t][p] * inv;
#pragma unroll
    for (int i = 0; i < KP; ++i) {
      if (i == p) continue;
      const float c = __shfl_sync(kFullMask, wa[i], p);
      if (right) wa[i] = fmaf(-c, ra, wa[i]);
#pragma unroll
      for (int t = 0; t < NB; ++t) wb[t][i] = fmaf(-c, rb[t], wb[t][i]);
    }
    if (right) wa[p] = ra;
#pragma unroll
    for (int t = 0; t < NB; ++t) wb[t][p] = rb[t];
  }

  float* xs = x + sys * k * m + c0;
#pragma unroll
  for (int t = 0; t < NB; ++t) {
    const int col = lane + 32 * t;
    if (col < width) {
#pragma unroll
      for (int i = 0; i < KP; ++i)
        if (i < k) xs[i * m + col] = wb[t][i];
    }
  }
}

template <int KP, int NB>
int launch(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
           const float* b, int64_t sb0, int64_t sb1, int64_t sb2, float* x,
           int64_t r, int k, int m, int nq, cudaStream_t stream) {
  const int64_t warps = r * nq;
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  gj_multi_reg_kernel<KP, NB><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      a, sa0, sa1, sa2, b, sb0, sb1, sb2, x, r, k, m, nq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// X [r, k, m] = A^-1 B for A [r, k, k] (strides sa*) and B [r, k, m]
// (strides sb*), 1 <= k <= 32, m >= 1; X contiguous. mc (32 or 64) is the
// widest chunk of B's columns one warp takes. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a k, m or mc out of range.
int gj_aug_multi_reg(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
                     const float* b, int64_t sb0, int64_t sb1, int64_t sb2,
                     float* x, int64_t r, int k, int m, int mc,
                     void* stream) {
  if (k < 1 || k > 32 || m < 1 || (mc != 32 && mc != 64))
    return (int)cudaErrorInvalidValue;
  if (r <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nq = (m + mc - 1) / mc;
  const int widest = (m + nq - 1) / nq;  // <= mc
  if (k <= 16)
    return widest <= 32
        ? launch<16, 1>(a, sa0, sa1, sa2, b, sb0, sb1, sb2, x, r, k, m, nq, s)
        : launch<16, 2>(a, sa0, sa1, sa2, b, sb0, sb1, sb2, x, r, k, m, nq, s);
  return widest <= 32
      ? launch<32, 1>(a, sa0, sa1, sa2, b, sb0, sb1, sb2, x, r, k, m, nq, s)
      : launch<32, 2>(a, sa0, sa1, sa2, b, sb0, sb1, sb2, x, r, k, m, nq, s);
}

}  // extern "C"
