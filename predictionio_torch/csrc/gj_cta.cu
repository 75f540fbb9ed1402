// Batched Gauss-Jordan solve of small SPD systems, x = A^-1 b,
// 64 < K <= 128, one thread block per system with the working copy in
// registers, for Hopper (sm_90a).
//
// Replaces two TPU kernels of predictionio_tpu/ops/pallas_solve.py at
// 64 < K <= 128 (any rank from 65 to 95 under `auto`, every rank up to 128
// under a forced layout):
//   - _build_solver_aug :249 (entry point gj_aug_cta);
//   - _build_solver_packed :101 (entry point gj_packed_cta).
// At K <= 64 gj_reg.cu runs both, above K = 128 gj_solve.cu's gj_aug and
// gj_layouts.cu's gj_packed; ops/spd_solve.py routes. As in gj_reg.cu the
// packed layout (column Gauss-Jordan on [[A], [b^T]]) is the row
// elimination below applied to [A^T | b], so one body serves both and only
// the load differs (kPacked); for an A that is not bitwise symmetric the
// packed entry point solves A^T x = b, as the TPU kernel does.
//
// What held the kernels this replaces back: gj_solve.cu and gj_layouts.cu
// keep the [K][K+1] copy in shared memory and make about four
// shared-memory accesses per element per step (element, pivot-column
// entry, pivot-row entry, write back), two block barriers a step, one IEEE
// division per pivot-column element, and the pivot column read with
// stride K (32-way bank conflicts at K = 64 and 128). What the card bounds
// this solve by: (K^2 + 2K)*4 bytes against the K^3/3 + 2K^2 FP32
// operations of the least work that solves an SPD system (a Cholesky
// factorisation and two substitutions), ~11 per byte at K = 128, under the
// H100's FP32 ridge of 20 (67 TFLOP/s over 3.35 TB/s): 0.28 ms for 13 850
// systems at K = 128 and 0.108 ms at K = 80, both set by bytes.
//
// Design: one thread block owns one system, KP threads, KP in {96, 128} a
// template parameter and K <= KP at run time. Thread i holds row i of A
// (of A^T when kPacked) in KP registers and b_i in one more. Rows and
// columns K..KP-1 are zero, steps p >= K are skipped by a branch uniform
// across the block, and the padding rows' threads skip their updates, so
// the padding changes no result. Step p:
//   - thread p, the owner of the pivot row, guards its pivot d
//     (|d| < 1e-30 -> 1, so an all-zero padding system solves to exactly
//     0), takes one IEEE reciprocal __frcp_rn(d), keeps it, and writes its
//     row right of the pivot, b_p and 1/d to the pivot-row buffer p mod 2
//     in shared memory with 16-byte stores. The row is not scaled: that
//     would be K - p multiplies in one thread while the block waits, and
//     made the kernel 8-11 % slower at K = 80, 96 and 128 (PERF.md);
//   - one __syncthreads;
//   - every other thread forms its multiplier m = c / d as c * (1/d), c
//     its own column-p value read before the step, reads the row back as
//     16-byte broadcast loads and updates its columns right of p and its
//     b entry with one fused multiply-add each. The pivot row stays as it
//     is; columns <= p are never read again.
// After K steps row i holds d_i x_i in its b entry, and x_i = b_i * (1/d_i)
// with the reciprocal thread i took at its own pivot.
//
// Why one barrier a step is enough: the pivot row is double-buffered.
// Buffer p mod 2 is written at step p before barrier p and read after it;
// its next write, at step p + 2, comes after barrier p + 1, which no
// thread passes before every thread has arrived there, i.e. has finished
// its reads of step p. The write of step p + 1 goes to the other buffer,
// so it cannot race with a slow reader of step p either. A thread's own
// update of step p - 1 precedes, in program order, its pivot work at
// step p, so the owner writes a row that is up to date.
//
// Registers and code: a register array can only be indexed by
// compile-time constants, yet the step loop, whose body names column p,
// must not be unrolled in full: at KP = 128 that is ~30 k instructions
// (~480 KB), far more than an SM's instruction cache; that version, which
// also scaled the pivot row in its owner, ran 1.4-1.7x slower than the
// form below (PERF.md). So the row is rotated:
// the steps run in groups of kGroup (4), each group's pivot columns in
// r[0..3], and after each group every register moves down four places;
// one rolled loop body serves every group. The rotation costs a move per
// column per group, and the body updates a fixed width W instead of the
// K - p columns right of the pivot, so the steps run in kPhases (4)
// phases of KP/4 steps whose widths KP, 3KP/4, KP/2, KP/4 still cover
// every live column: ~5/4 of the triangle's multiply-adds.
//
// What bounds the design: every step delivers the pivot row to every
// thread from shared memory, (W + 4) * 4 bytes a thread, and an SM's
// shared memory delivers at most 128 bytes a clock, however many threads
// read one address. At K = 128 that is ~5.5 MB, ~43 k clocks, a system:
// ~2.3 ms for 13 850 systems on 132 SMs at 1.98 GHz, above the card's
// 0.28 ms bound. That is the price of a row per thread; a thread holding
// a block of several rows would use each delivered value more than once.
//
// A is read from device memory once. The packed load needs no staging:
// thread i reads A[j][i] for each row j, so where A's rows are contiguous
// the block reads row j in one coalesced access. The aug load reads each
// warp's 32 rows in chunks of 32 columns, coalesced, all issued before
// the first is used, and transposes every chunk through a per-warp shared
// tile of stride 33 (odd, so lane i reading row i finds 32 different
// banks). Only x is written.
//
// Built without --use_fast_math: the reciprocal is __frcp_rn (IEEE, round
// to nearest), which keeps the 1e-4 bars and the exact zeros.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr float kPivotEps = 1e-30f;
constexpr int kGroup = 4;   // steps between two rotations of the row
constexpr int kPhases = 4;  // phases of K/4 steps, each of its own width

// Steps p0 .. p0 + kGroup - 1 (stopping at k) on thread i's row r, which
// holds A's columns p0, p0 + 1, ... in r[0], r[1], ...; every live column
// lies in r[0..W-1]. rb is b_i; inv_own receives 1/d when i pivots.
template <int KP, int W>
__device__ __forceinline__ void steps(float (&r)[KP], float& rb,
                                      float& inv_own,
                                      float4 (*prow)[KP / 4 + 1], int i,
                                      int k, int p0) {
  constexpr int QB = KP / 4;  // the quad that carries (b_p, 1/d_p)
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int p = p0 + u;
    if (p >= k) return;  // uniform: k is the same for every thread
    float4* buf = prow[u & 1];  // p mod 2: p0 is a multiple of kGroup
    float c = r[u];
    if (i == p) {
      float d = r[u];
      if (fabsf(d) < kPivotEps) d = 1.0f;
      inv_own = __frcp_rn(d);
#pragma unroll
      for (int q = (u + 1) / 4; q < W / 4; ++q)
        buf[q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2],
                             r[4 * q + 3]);
      buf[QB] = make_float4(rb, inv_own, 0.0f, 0.0f);
      c = 0.0f;
    }
    __syncthreads();
    if (i >= k) continue;  // a padding row: zero, and never read
    const float4 t = buf[QB];
    const float m = c * t.y;
#pragma unroll
    for (int q = (u + 1) / 4; q < W / 4; ++q) {
      const float4 v = buf[q];
      const int j = 4 * q;
      if (j > u) r[j] = fmaf(-m, v.x, r[j]);
      if (j + 1 > u) r[j + 1] = fmaf(-m, v.y, r[j + 1]);
      if (j + 2 > u) r[j + 2] = fmaf(-m, v.z, r[j + 2]);
      if (j + 3 > u) r[j + 3] = fmaf(-m, v.w, r[j + 3]);
    }
    rb = fmaf(-m, t.x, rb);
  }
}

// Phase PH: the groups from g up to the phase's last (or to step k), at
// width W, each followed by the rotation that brings the next group's
// pivot columns to r[0..kGroup-1]; then the next phase.
template <int KP, int PH>
__device__ __forceinline__ void phase(float (&r)[KP], float& rb,
                                      float& inv_own,
                                      float4 (*prow)[KP / 4 + 1], int i,
                                      int k, int g) {
  constexpr int W = KP - PH * (KP / kPhases);
  constexpr int g_end = (PH + 1) * (KP / kGroup / kPhases);
#pragma unroll 1
  for (; g < g_end && g * kGroup < k; ++g) {
    steps<KP, W>(r, rb, inv_own, prow, i, k, g * kGroup);
#pragma unroll
    for (int j = 0; j < W - kGroup; ++j) r[j] = r[j + kGroup];
#pragma unroll
    for (int j = W - kGroup; j < W; ++j) r[j] = 0.0f;
  }
  if constexpr (PH + 1 < kPhases)
    phase<KP, PH + 1>(r, rb, inv_own, prow, i, k, g);
}

template <int KP, bool kPacked>
__global__ void __launch_bounds__(KP)
gj_cta_kernel(const float* __restrict__ a, int64_t sa0, int64_t sa1,
              int64_t sa2, const float* __restrict__ b, int64_t sb0,
              int64_t sb1, float* __restrict__ x, int k) {
  constexpr int T = 33;  // tile row stride
  __shared__ float4 prow[2][KP / 4 + 1];  // the pivot row, double-buffered
  __shared__ float tile[kPacked ? 1 : KP / 32][32 * T];

  const int i = threadIdx.x;
  const int64_t sys = blockIdx.x;
  const float* as = a + sys * sa0;
  float r[KP];  // row i of A, zero past K

  if constexpr (kPacked) {  // row i of A^T: column i of A
    const bool live = i < k;
    const float* col = as + (live ? i : 0) * sa2;
#pragma unroll
    for (int j = 0; j < KP; ++j)
      r[j] = live && j < k ? __ldg(col + j * sa1) : 0.0f;
  } else {
    // lane reads column 32q + lane of the warp's rows row0 .. row0 + 31
    // into r[32q + rr], then each chunk goes through the tile so that
    // thread i gets row i
    const int lane = i % 32;
    const int row0 = i - lane;
#pragma unroll
    for (int q = 0; q < KP / 32; ++q) {
      const int c = q * 32 + lane;
#pragma unroll
      for (int rr = 0; rr < 32; ++rr) {
        const int row = row0 + rr;
        r[q * 32 + rr] =
            row < k && c < k ? __ldg(as + row * sa1 + c * sa2) : 0.0f;
      }
    }
    float* t = tile[i / 32];
#pragma unroll
    for (int q = 0; q < KP / 32; ++q) {
#pragma unroll
      for (int rr = 0; rr < 32; ++rr) t[rr * T + lane] = r[q * 32 + rr];
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 32; ++j) r[q * 32 + j] = t[lane * T + j];
      __syncwarp();  // the next chunk overwrites the tile
    }
  }
  float rb = i < k ? b[sys * sb0 + i * sb1] : 0.0f;
  float inv_own = 1.0f;

  phase<KP, 0>(r, rb, inv_own, prow, i, k, 0);

  if (i < k) x[sys * k + i] = rb * inv_own;
}

template <int KP, bool kPacked>
int launch(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
           const float* b, int64_t sb0, int64_t sb1, float* x, int64_t r,
           int k, cudaStream_t stream) {
  gj_cta_kernel<KP, kPacked><<<(unsigned)r, KP, 0, stream>>>(
      a, sa0, sa1, sa2, b, sb0, sb1, x, k);
  return (int)cudaGetLastError();
}

template <bool kPacked>
int dispatch(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
             const float* b, int64_t sb0, int64_t sb1, float* x, int64_t r,
             int k, void* stream) {
  if (r <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k >= 1 && k <= 96)
    return launch<96, kPacked>(a, sa0, sa1, sa2, b, sb0, sb1, x, r, k, s);
  if (k > 96 && k <= 128)
    return launch<128, kPacked>(a, sa0, sa1, sa2, b, sb0, sb1, x, r, k, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x [r, k] = A^-1 b for A [r, k, k] (strides sa*) and b [r, k] (strides
// sb0, sb1), 1 <= k <= 128 (the routing sends it 64 < k); x contiguous.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a k out of
// range.
int gj_aug_cta(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
               const float* b, int64_t sb0, int64_t sb1, float* x,
               int64_t r, int k, void* stream) {
  return dispatch<false>(a, sa0, sa1, sa2, b, sb0, sb1, x, r, k, stream);
}

// x [r, k] = A^-T b (the packed layout's elimination; A^-1 b for a
// symmetric A), arguments as for gj_aug_cta.
int gj_packed_cta(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
                  const float* b, int64_t sb0, int64_t sb1, float* x,
                  int64_t r, int k, void* stream) {
  return dispatch<true>(a, sa0, sa1, sa2, b, sb0, sb1, x, r, k, stream);
}

}  // extern "C"
